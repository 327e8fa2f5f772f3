"""Where one epoch of the PyTorch/CUDA port's trainer spends its time on the card.

    python3 tools/torch_epoch_profile.py [--config {mlp_trap,impala_procmaze,impala_prod_bf16,
                                                    impala_procmaze_vbn,cnn_pixelgrid,
                                                    gaussian_swimmer,impala_128px,
                                                    gaussian_swimmer_15,impala_procgen,
                                                    impala_procgen_bf16}]
                                         [--out chiprun_out/torch_epoch_profile]
                                         [--epochs 10] [--tree DIR] [--spans-ab PAIRS]

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
  (the reference's launch value), its VBN refresh inside the ``update`` span;
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
  (``GaussianMLP(32, 14)``, the swimmer kernel's run-time form);
- ``impala_procgen`` and ``impala_procgen_bf16``: the shapes of the
  benchmark's cells (``benchmark/configs``, ``benchmark/workloads``):
  16/32/32, hidden 256, f32 or bf16, on ``ProcMazeEnv`` 3x64x64 with
  200 levels, P = 1536, T = 500, zeta 8, archive 4, lr 0.01, sigma 0.02
  (the trainer's own weights and draws, not the benchmark's).

It warms two epochs, then times ``--epochs`` epochs of ``train`` without
the profiler and traces one more with ``torch.profiler``.  The stages are
the program's own spans (``utils/profiling.py``): for the untraced epochs
it prints each span's median host ms and, from its CUDA events, device ms
and device ms outside the spans inside it, and the torso's counts; for the
traced epoch the same from the trainer's report, each ``dfd/<span>``
range's host time and the PyTorch kernels the profiler put inside it (not
the ctypes-launched kernels), the wall time, the device's busy time (the
union of its operations' intervals, as ``benchmark/trace.py`` reads it)
and idle share, the kernel launches and the host's synchronising calls, the
ported kernels' device times and the largest operations.  Writes the Chrome
trace and the profiler's table under ``--out``.  ``--tree DIR`` runs the
``dfd_tpu_torch`` of another checkout (an earlier commit unpacked with
``git archive``; one without spans prints the host stages it reports).
``--spans-ab PAIRS`` then times single epochs of ``train`` in turns with
the trainer's spans as they are and with them off (a host-only timer that
is never made active, so every span inside the step reads no timer and no
event is recorded), on, off, off, on, PAIRS times, in one process: the
spans' cost with the profiler off.  Needs a CUDA device.
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

from benchmark import trace as trace_file  # noqa: E402

PORTED = ("normal_kernel", "perturb_kernel", "combine_kernel", "res_stage_mma_kernel",
          "feat_pool_mma_kernel", "res_stage_tf32_kernel", "feat_pool_tf32_kernel",
          "conv_tiled_tf32_kernel", "conv_tiled_mma_kernel", "swimmer_step_kernel",
          "swimmer_step_dyn_kernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
CONFIGS = ("mlp_trap", "impala_procmaze", "impala_prod_bf16", "impala_procmaze_vbn",
           "cnn_pixelgrid", "gaussian_swimmer", "impala_128px", "gaussian_swimmer_15",
           "impala_procgen", "impala_procgen_bf16")


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _stages(reports) -> dict:
    """{span key: median over ``reports`` of its ``_stage/`` value} (seconds
    and counts as reported; a key absent from a report reads 0 there)."""
    keys = sorted({k for r in reports for k in r if k.startswith("_stage/")})
    return {k[len("_stage/"):]: statistics.median(r.get(k, 0.0) for r in reports) for k in keys}


def _print_stages(title: str, stages: dict) -> None:
    names = [k for k in stages if "." not in k]
    for name in names:
        dev = stages.get(f"{name}.device")
        self_dev = stages.get(f"{name}.self.device")
        counts = {k.split(".", 1)[1]: v for k, v in stages.items()
                  if k.startswith(f"{name}.") and "device" not in k}
        print(f"{title} span {name}: host {1e3 * stages[name]:.2f} ms"
              + (f", device {1e3 * dev:.2f} ms" if dev is not None else "")
              + (f", device outside inner spans {1e3 * self_dev:.2f} ms"
                 if self_dev is not None else "")
              + "".join(f", {k} {v:.0f}" for k, v in counts.items()))


def _spans_ab(tr, pairs: int) -> dict:
    """{"on": epoch ms, "off": epoch ms} of single ``train`` epochs in
    turns on, off, off, on (see the module's docstring)."""
    import contextlib

    from dfd_tpu_torch.utils.profiling import StageTimer

    on, off = tr.timer, StageTimer()
    off.active = contextlib.nullcontext
    ms = {"on": [], "off": []}
    for _ in range(pairs):
        for side in ("on", "off", "off", "on"):
            tr.timer = on if side == "on" else off
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train(1)
            torch.cuda.synchronize()
            ms[side].append((time.perf_counter() - t0) * 1e3)
    tr.timer = on
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=CONFIGS, default="mlp_trap")
    ap.add_argument("--out", default="chiprun_out/torch_epoch_profile")
    ap.add_argument("--epochs", type=int, default=10, help="untraced epochs timed")
    ap.add_argument("--tree", help="root of another checkout whose dfd_tpu_torch to run")
    ap.add_argument("--spans-ab", type=int, default=0, metavar="PAIRS",
                    help="time epochs with the spans on and off in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_epoch_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
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
    elif args.config in ("impala_procgen", "impala_procgen_bf16"):
        env = ProcMazeEnv(grid=8, scale=8, max_steps=500, num_levels=200)
        cfg = TrainConfig(batch_size=1536, zeta_size=8, max_strategy_history_size=4,
                          episode_length=500, learning_rate=0.01, noise_std=0.02,
                          random_seed=0)
        dtype = torch.bfloat16 if args.config == "impala_procgen_bf16" else None
        model = ImpalaPolicy(env.obs_shape, 5, conv_impl="fused_feat", compute_dtype=dtype)
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
    n_timed = args.epochs
    steps0 = tr.cumulative_timesteps
    t0 = time.perf_counter()
    tr.train(n_timed)  # each epoch ends in a device-to-host metrics fetch
    steps_per_s = (tr.cumulative_timesteps - steps0) / (time.perf_counter() - t0)
    untraced = tr.reporter.history[-n_timed:]
    epoch_ms = sorted(r["Epoch Time"] * 1e3 for r in untraced)
    median_ms = statistics.median(epoch_ms)
    ab = _spans_ab(tr, args.spans_ab) if args.spans_ab else None
    with trace(args.out) as prof:
        t0 = time.perf_counter()
        tr.train(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    traced = tr.reporter.history[-1]

    read = trace_file.read(os.path.join(args.out, "trace.json"))
    rows = prof.key_averages()
    syncs = {name: sum(e.count for e in rows if e.key == name) for name in SYNCS}
    ranges = {e.key: (e.cpu_time_total / 1e3, _device_us(e) / 1e3) for e in rows
              if e.key.startswith("dfd/") and "CUDA" not in str(getattr(e, "device_type", ""))}
    sort_key = ("self_device_time_total" if hasattr(rows[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(rows.table(sort_by=sort_key, row_limit=60))
    busy_ms = read.busy_s * 1e3
    named = {k: 1e3 * v for k, v in read.device_s.items() if any(p in k for p in PORTED)}
    stages, traced_stages = _stages(untraced), _stages([traced])

    print(f"card: {card}")
    print(f"epoch: P={cfg.batch_size} T={tr.horizon}, {n_timed} untraced epochs: median "
          f"{median_ms:.1f} ms, longest {epoch_ms[-1]:.1f} ms, {steps_per_s:.0f} env-steps/s")
    _print_stages("untraced median", stages)
    if ab:
        ratios = [(a + b) / (c + d) for a, b, c, d in
                  zip(ab["on"][::2], ab["on"][1::2], ab["off"][::2], ab["off"][1::2])]
        print(f"spans on / off, {args.spans_ab} turns of on, off, off, on: epoch ms on "
              f"{', '.join(f'{x:.1f}' for x in ab['on'])}; off "
              f"{', '.join(f'{x:.1f}' for x in ab['off'])}; ratios "
              f"{', '.join(f'{x:.4f}' for x in ratios)}, median {statistics.median(ratios):.4f}")
    print(f"traced epoch: wall {wall_ms:.1f} ms ({wall_ms / median_ms:.4f} x the untraced "
          f"median), device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
          f"kernel launches {read.launches}, "
          + ", ".join(f"{k} {n}" for k, n in syncs.items()))
    _print_stages("traced", traced_stages)
    for k, (host_ms, dev_ms) in ranges.items():
        print(f"range {k}: host {host_ms:.2f} ms, PyTorch kernels inside {dev_ms:.3f} ms")
    for k, ms in named.items():
        print(f"kernel {k}: {ms:.4f} ms device time")
    print("top device operations by time (ms, name):")
    for k, v in trace_file.top(read.device_s, 15):
        print(f"  {1e3 * v:9.3f}  {k[:100]}")
    print(json.dumps({"card": card, "config": args.config, "tree": args.tree or ".",
                      "epoch_ms": epoch_ms, "median_epoch_ms": median_ms, "spans_ab_ms": ab,
                      "env_steps_per_s": steps_per_s, "stages": stages, "wall_ms": wall_ms,
                      "traced_stages": traced_stages, "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms, "launches": read.launches,
                      "syncs": syncs,
                      "ranges": {k: {"host_ms": h, "torch_kernels_ms": d}
                                 for k, (h, d) in ranges.items()},
                      "kernels_ms": named}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
