"""Where one epoch of the PyTorch/CUDA port's trainer spends its time on the card.

    python3 tools/torch_epoch_profile.py [--config {mlp_trap,impala_procmaze,impala_prod_bf16,
                                                    impala_procmaze_vbn,cnn_pixelgrid,
                                                    gaussian_swimmer,impala_128px,
                                                    gaussian_swimmer_15}]
                                         [--out chiprun_out/torch_epoch_profile]

Runs ``dfd_tpu_torch``'s ``VectorizedTrainer`` on one configuration, each
with its ``bench.py`` ``TrainConfig`` (the default ``noise_backend="jax"``:
eps from ``normal_kernel``, the dense combine):

- ``mlp_trap`` (the default; ``bench.py:143-152``): ``DiscreteMLP(2, 9)``,
  ``TrapEnv``, P = 2048, T = 201;
- ``impala_procmaze`` (``bench.py:210-219``): ``ImpalaPolicy`` 16/32/32,
  hidden 256, ``conv_impl="fused_feat"``, on ``ProcMazeEnv`` 3x64x64,
  P = 128, T = 40;
- ``impala_prod_bf16`` (``bench.py:221-240``): ``ImpalaPolicy`` 64/128/128,
  hidden 512, bf16 operands, ``conv_impl="fused_feat"``, the same env,
  P = 64, T = 40;
- ``impala_procmaze_vbn``: ``impala_procmaze`` with ``vbn_buffer_size=1000``
  (the reference's launch value), its VBN refresh a range of its own;
- ``cnn_pixelgrid`` (``bench.py:183-202``): ``AtariCNN`` on 3x64x64 frames,
  bf16 operands, ``PixelGridEnv(grid=8, scale=8, max_steps=40,
  intensity=1.0)``, P = 256, T = 40;
- ``gaussian_swimmer`` (``bench.py:173-181``): ``GaussianMLP(16, 6)`` on
  ``SwimmerEnv(max_steps=100)`` (7 links, one ``swimmer_step_kernel``
  launch a step), the Wasserstein distance, P = 512, T = 100,
  ``normalize_obs=True``;
- ``impala_128px``: ``impala_prod_bf16``'s model and ``TrainConfig`` in f32
  at 128 x 128 frames (``ProcMazeEnv(grid=16, scale=8)``), in chunks of 16
  members: three of its five fused torso calls a step on the tiled forms;
- ``gaussian_swimmer_15``: ``gaussian_swimmer`` at 15 links
  (``GaussianMLP(32, 14)``, the swimmer kernel's run-time form).

It warms two epochs, times ten epochs of ``train`` without the profiler,
then traces one more with ``torch.profiler``, its stages (perturb, rollout,
novelty, combine, vbn) marked as profiler ranges; for every configuration
but ``mlp_trap`` the model's ``linear`` layers (the fc, 2048 -> 256 or
8192 -> 512, and the policy head; the Gaussian MLP's three), its ``lstm``
steps, its ``patches`` convs (stage 0's feature conv and stage 2's residual
convs, whose 8x8 frames the fused kernels' gate leaves on that path; the
CNN's two convs) and the env's ``step`` (``env``) are ranges too.  Prints the untraced epochs' median and
longest time, their env-steps/s and the median split between the epoch step
and the host archive; the traced epoch's wall time, the device's busy time
and idle share and the kernel launch count; each stage's host time and the
device time of the PyTorch kernels inside it (the profiler does not
attribute the ctypes-launched kernels to a range: they have their own
lines); the ported kernels' device times; and the largest kernels by device
time.  Writes the Chrome trace and the full table under ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


STAGES = ("perturb", "rollout", "novelty", "combine", "vbn")
LAYERS = ("linear", "lstm", "patches", "env")  # the model's and env's ranges inside the stages
PORTED = ("normal_kernel", "perturb_kernel", "combine_kernel", "res_stage_mma_kernel",
          "feat_pool_mma_kernel", "res_stage_tf32_kernel", "feat_pool_tf32_kernel",
          "conv_tiled_tf32_kernel", "conv_tiled_mma_kernel", "swimmer_step_kernel",
          "swimmer_step_dyn_kernel")


def _device_us(evt, total: bool = False) -> float:
    prefix = "" if total else "self_"
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _mark_stages(tr, layer_ranges: bool) -> None:
    """Wrap the epoch's stages in profiler ranges named by ``STAGES`` and,
    with ``layer_ranges``, the model layers named by ``LAYERS``."""
    from dfd_tpu_torch.models import atari, impala, layers
    from dfd_tpu_torch.runners import vectorized

    def ranged(fn, name):
        def inner(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return inner

    tr._perturbed = ranged(tr._perturbed, "perturb")
    vectorized.combine = ranged(vectorized.combine, "combine")
    for name in ("combine_gradient", "combine_gradient_chunked"):
        setattr(vectorized.fd_combine, name,
                ranged(getattr(vectorized.fd_combine, name), "combine"))
    vectorized.fd_rollout.episode_rollout = ranged(vectorized.fd_rollout.episode_rollout, "rollout")
    tr._batch_novelty = ranged(tr._batch_novelty, "novelty")
    tr.model.vbn = ranged(tr.model.vbn, "vbn")
    if layer_ranges:
        layers.linear = ranged(layers.linear, "linear")
        layers.lstm_step = ranged(layers.lstm_step, "lstm")
        impala.conv3x3_patches = ranged(impala.conv3x3_patches, "patches")
        atari.conv2d = ranged(atari.conv2d, "patches")
        tr.env.step = ranged(tr.env.step, "env")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("mlp_trap", "impala_procmaze", "impala_prod_bf16",
                                         "impala_procmaze_vbn", "cnn_pixelgrid",
                                         "gaussian_swimmer", "impala_128px",
                                         "gaussian_swimmer_15"),
                    default="mlp_trap")
    ap.add_argument("--out", default="chiprun_out/torch_epoch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_epoch_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import PixelGridEnv, ProcMazeEnv, SwimmerEnv, TrapEnv
    from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, GaussianMLP, ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import VectorizedTrainer
    from dfd_tpu_torch.utils.profiling import trace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.config == "mlp_trap":
        # mlp_trap (bench.py): P = 2048, zeta 64, archive 16, lr 0.05, sigma 0.05
        cfg = TrainConfig(batch_size=2048, learning_rate=0.05, noise_std=0.05,
                          zeta_size=64, max_strategy_history_size=16, random_seed=0,
                          scan_unroll=8)
        tr = VectorizedTrainer(DiscreteMLP(2, 9), TrapEnv(), distances.categorical_tvd, cfg)
    elif args.config == "cnn_pixelgrid":
        env = PixelGridEnv(grid=8, scale=8, max_steps=40, intensity=1.0)
        cfg = TrainConfig(batch_size=256, zeta_size=16, max_strategy_history_size=8,
                          episode_length=40, random_seed=0)
        model = AtariCNN((64, 64), env.n_actions, in_channels=3, compute_dtype=torch.bfloat16)
        tr = VectorizedTrainer(model, env, distances.categorical_tvd, cfg)
    elif args.config in ("gaussian_swimmer", "gaussian_swimmer_15"):
        cfg = TrainConfig(batch_size=512, zeta_size=16, max_strategy_history_size=8,
                          episode_length=100, random_seed=0, normalize_obs=True)
        links = 15 if args.config == "gaussian_swimmer_15" else 7
        model = GaussianMLP(2 * links + 2, links - 1)
        tr = VectorizedTrainer(model, SwimmerEnv(n_links=links, max_steps=100),
                               distances.gaussian_wasserstein_from_strategies, cfg)
    elif args.config == "impala_128px":
        env = ProcMazeEnv(grid=16, scale=8, max_steps=40, num_levels=200)
        cfg = TrainConfig(batch_size=64, zeta_size=8, max_strategy_history_size=4,
                          episode_length=40, random_seed=0, population_chunk=16)
        model = ImpalaPolicy(env.obs_shape, env.n_actions, conv_impl="fused_feat",
                             channels=(64, 128, 128), hidden=512)
        tr = VectorizedTrainer(model, env, distances.categorical_tvd, cfg)
    else:
        env = ProcMazeEnv(grid=8, scale=8, max_steps=40, num_levels=200)
        prod = args.config == "impala_prod_bf16"
        widths = dict(compute_dtype=torch.bfloat16, channels=(64, 128, 128), hidden=512)
        cfg = TrainConfig(batch_size=64 if prod else 128, zeta_size=8,
                          max_strategy_history_size=4, episode_length=40, random_seed=0,
                          vbn_buffer_size=1000 if args.config == "impala_procmaze_vbn" else 0)
        model = ImpalaPolicy(env.obs_shape, env.n_actions, conv_impl="fused_feat",
                             **(widths if prod else {}))
        tr = VectorizedTrainer(model, env, distances.categorical_tvd, cfg)
    tr.train(2)  # builds the kernels, fills the archive enough for novelty
    torch.cuda.synchronize()
    n_timed = 10
    steps0 = tr.cumulative_timesteps
    t0 = time.perf_counter()
    tr.train(n_timed)  # each epoch ends in a device-to-host metrics fetch
    steps_per_s = (tr.cumulative_timesteps - steps0) / (time.perf_counter() - t0)
    epoch_ms = sorted(r["Epoch Time"] * 1e3 for r in tr.reporter.history[-n_timed:])
    median_ms = statistics.median(epoch_ms)
    split_ms = {k: statistics.median([r[f"_stage/{k}"] * 1e3 for r in tr.reporter.history[-n_timed:]])
                for k in ("device_step", "archive")}
    _mark_stages(tr, layer_ranges=args.config != "mlp_trap")
    with trace(args.out) as prof:
        t0 = time.perf_counter()
        tr.train(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = prof.key_averages()
    on_device = lambda e: "CUDA" in str(getattr(e, "device_type", ""))
    # device-side events only (kernels, copies, sets): the CPU ops that
    # launched them carry the same time again, and the stage ranges span them
    dev_rows = sorted(((_device_us(e), e.count, e.key) for e in rows
                       if on_device(e) and e.key not in STAGES + LAYERS and _device_us(e) > 0),
                      reverse=True)
    busy_ms = sum(us for us, _, _ in dev_rows) / 1e3
    launches = sum(e.count for e in rows if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    named = {k: (us / 1e3, n) for us, n, k in dev_rows if any(p in k for p in PORTED)}
    sort_key = ("self_device_time_total" if hasattr(rows[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(rows.table(sort_by=sort_key, row_limit=60))
    stages = {e.key: (e.cpu_time_total / 1e3, _device_us(e, total=True) / 1e3)
              for e in rows if e.key in STAGES + LAYERS and not on_device(e)}
    print(f"card: {card}")
    print(f"epoch: P={cfg.batch_size} T={tr.horizon}, {n_timed} untraced epochs: median "
          f"{median_ms:.1f} ms, longest {epoch_ms[-1]:.1f} ms, {steps_per_s:.0f} env-steps/s; "
          f"median epoch step {split_ms['device_step']:.1f} ms, host archive "
          f"{split_ms['archive']:.1f} ms")
    print(f"traced epoch: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, kernel launches {launches}")
    for k, (host_ms, dev_ms) in stages.items():
        print(f"stage {k}: host {host_ms:.2f} ms, PyTorch kernels {dev_ms:.3f} ms")
    for k, (ms, n) in named.items():
        print(f"kernel {k}: {ms:.4f} ms device time, {n} launch(es)")
    print("top kernels by device time (ms, count, name):")
    for us, n, k in dev_rows[:15]:
        print(f"  {us / 1e3:9.3f} {n:6d}  {k[:100]}")
    print(json.dumps({"card": card, "epoch_ms": epoch_ms, "median_epoch_ms": median_ms,
                      "env_steps_per_s": steps_per_s,
                      "median_split_ms": split_ms, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                      "launches": launches,
                      "stages": {k: {"host_ms": h, "torch_kernels_ms": d} for k, (h, d) in stages.items()},
                      "kernels": {k: {"ms": ms, "count": n} for k, (ms, n) in named.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
