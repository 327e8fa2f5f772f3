"""The port's ``train_fast`` epochs in this checkout and another, in turns, on one card.

    python3 tools/torch_epoch_turns.py --parent DIR [--cells CELL ...] [--rounds N]
                                       [--epochs N]

DIR is the root of another checkout of this repository (an earlier commit,
unpacked with ``git archive``) whose ``VectorizedTrainer`` takes the same
``TrainConfig``s.  Each turn is one process that imports ``dfd_tpu_torch``
from one checkout (its kernels built into that checkout's ``build/``) and,
for each cell, warms two epochs, then times ``train_fast(epochs,
sync_every=epochs)``: one chunk of epochs that the host may queue ahead of
the card unless a step waits for it.  A round's turns are parent, change,
change, parent, so both versions share the card, its clocks and its power
limit.  The cells take their ``bench.py`` ``TrainConfig``s (the default
``noise_backend="jax"``):

- ``mlp_trap`` (``bench.py:143-152``) and ``mlp_trap_e8`` (``:159-168``,
  eight episodes a member): ``DiscreteMLP(2, 9)`` on ``TrapEnv``, P = 2048;
- ``impala_procmaze`` (``bench.py:210-219``): ``ImpalaPolicy`` 16/32/32 on
  ``ProcMazeEnv`` 3x64x64, P = 128;
- ``impala_prod_bf16`` (``bench.py:221-240``): 64/128/128, hidden 512, bf16
  operands, P = 64; ``impala_prod_bf16_c16`` the same in population chunks
  of 16;
- ``gaussian_swimmer`` (``bench.py:173-181``): ``GaussianMLP(16, 6)`` on
  ``SwimmerEnv(max_steps=100)``, P = 512, normalized observations
  (``swimmer_step_kernel`` at N = 513, once a rollout step);
- ``gaussian_swimmer_15``: ``gaussian_swimmer`` at 15 links (DeepMind
  Control's ``swimmer15``), ``GaussianMLP(32, 14)``, as ``chip_smoke.py``'s
  ``swimmer15_path`` builds it (its ``SWIM15_*`` sizes, imported from the
  timed checkout's own ``chip_smoke.py``): the swimmer kernel's run-time
  form at N = 513, once a rollout step;
- ``impala_128px``: ``chip_smoke.py``'s ``shapes`` phase's 128-pixel f32
  flagship (``BIG_ENV``, ``BIG_MODEL``, P = ``BIG_P`` in chunks of
  ``BIG_CHUNK``, T = ``BIG_T``: ``impala_prod_bf16``'s model in f32 on
  3x128x128 frames), the path of the f32 tiled torso forms, imported from
  the timed checkout's own ``chip_smoke.py``;
- ``swimmer_host``: the sequential topology's ``Swimmer-v0`` as
  ``chip_smoke.py``'s host paths build it (the factory's model and env,
  batch 4, zeta 16, archive 16, seed 123; ``swimmer_step_kernel`` at N = 1,
  once a host env step), timed as ``train(epochs)`` after one warm epoch;
- ``impala_procgen`` and ``impala_procgen_bf16``: the shapes of the
  benchmark's cells (16/32/32, hidden 256, f32 or bf16 on 3x64x64 frames,
  P = 1536, T = 500, zeta 8, archive 4, lr 0.01, sigma 0.02), as
  ``tools/torch_epoch_profile.py`` builds them.

Prints each turn's epoch time per cell, then per cell each round's
change / parent ratio (the two changes' mean over the two parents') and the
rounds' median.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("mlp_trap", "mlp_trap_e8", "impala_procmaze", "impala_prod_bf16",
         "impala_prod_bf16_c16", "gaussian_swimmer", "swimmer_host", "impala_128px",
         "gaussian_swimmer_15", "impala_procgen", "impala_procgen_bf16")


def make_trainer(cell: str):
    import torch

    from dfd_tpu_torch.config import TrainConfig
    from dfd_tpu_torch.envs import ProcMazeEnv, SwimmerEnv, TrapEnv
    from dfd_tpu_torch.models import DiscreteMLP, GaussianMLP, ImpalaPolicy
    from dfd_tpu_torch.ops import distances
    from dfd_tpu_torch.runners import SequentialRunner, VectorizedTrainer
    from dfd_tpu_torch.utils import factory
    from dfd_tpu_torch.utils.metrics import EpochReporter

    tvd = distances.categorical_tvd
    if cell == "impala_128px":  # as chip_smoke.py's shapes phase builds it
        import chip_smoke as cs

        cfg = TrainConfig(batch_size=cs.BIG_P, zeta_size=8, max_strategy_history_size=4,
                          episode_length=cs.BIG_T, random_seed=0, population_chunk=cs.BIG_CHUNK)
        env = ProcMazeEnv(**cs.BIG_ENV)
        return VectorizedTrainer(ImpalaPolicy(env.obs_shape, 5, **cs.BIG_MODEL), env, tvd, cfg)
    if cell == "swimmer_host":
        env, model, dist = factory.get_init_data("Swimmer-v0", 123, "cuda")
        return SequentialRunner(model, env, dist, batch_size=4, zeta_size=16,
                                max_strategy_history_size=16, random_seed=123,
                                reporter=EpochReporter(quiet=True))
    if cell == "gaussian_swimmer_15":  # as chip_smoke.py's swimmer15_path builds it
        import chip_smoke as cs

        cfg = TrainConfig(batch_size=cs.SWIM15_P, zeta_size=16, max_strategy_history_size=8,
                          episode_length=cs.SWIM15_T, random_seed=0, normalize_obs=True)
        links = cs.SWIM15_LINKS
        return VectorizedTrainer(GaussianMLP(2 * links + 2, links - 1),
                                 SwimmerEnv(n_links=links, max_steps=cs.SWIM15_T),
                                 distances.gaussian_wasserstein_from_strategies, cfg)
    if cell == "gaussian_swimmer":
        cfg = TrainConfig(batch_size=512, zeta_size=16, max_strategy_history_size=8,
                          episode_length=100, random_seed=0, normalize_obs=True)
        return VectorizedTrainer(GaussianMLP(16, 6), SwimmerEnv(max_steps=100),
                                 distances.gaussian_wasserstein_from_strategies, cfg)
    if cell.startswith("impala_procgen"):
        env = ProcMazeEnv(grid=8, scale=8, max_steps=500, num_levels=200)
        cfg = TrainConfig(batch_size=1536, zeta_size=8, max_strategy_history_size=4,
                          episode_length=500, learning_rate=0.01, noise_std=0.02, random_seed=0)
        dtype = torch.bfloat16 if cell == "impala_procgen_bf16" else None
        return VectorizedTrainer(ImpalaPolicy(env.obs_shape, 5, conv_impl="fused_feat",
                                              compute_dtype=dtype), env, tvd, cfg)
    if cell.startswith("mlp_trap"):
        cfg = TrainConfig(batch_size=2048, learning_rate=0.05, noise_std=0.05, zeta_size=64,
                          max_strategy_history_size=16, random_seed=0, scan_unroll=8,
                          envs_per_perturbation=8 if cell == "mlp_trap_e8" else 1)
        return VectorizedTrainer(DiscreteMLP(2, 9), TrapEnv(), tvd, cfg)
    env = ProcMazeEnv(grid=8, scale=8, max_steps=40, num_levels=200)
    prod = cell.startswith("impala_prod_bf16")
    widths = dict(compute_dtype=torch.bfloat16, channels=(64, 128, 128), hidden=512)
    cfg = TrainConfig(batch_size=64 if prod else 128, zeta_size=8, max_strategy_history_size=4,
                      episode_length=40, random_seed=0,
                      population_chunk=16 if cell.endswith("_c16") else None)
    model = ImpalaPolicy(env.obs_shape, env.n_actions, conv_impl="fused_feat",
                         **(widths if prod else {}))
    return VectorizedTrainer(model, env, tvd, cfg)


def worker(cells, epochs: int) -> dict:
    """{cell: epoch ms} of this process's checkout."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for cell in cells:
        tr = make_trainer(cell)
        if cell == "swimmer_host":
            warm, run = (lambda: tr.train(1)), (lambda: tr.train(epochs))
        else:
            warm, run = (lambda: tr.train_fast(2, sync_every=2)), \
                (lambda: tr.train_fast(epochs, sync_every=epochs))
        warm()  # builds the kernels, fills the archive for novelty
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out[cell] = (time.perf_counter() - t0) / epochs * 1e3
        del tr
        torch.cuda.empty_cache()
    return out


def turn(tree: str, cells, epochs: int) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree, "--epochs", str(epochs),
           "--cells", *cells]
    done = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{done.stdout[-4000:]}{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.worker))
        print(json.dumps(worker(args.cells, args.epochs)))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("torch_epoch_turns: needs a CUDA device and --parent", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    ratios = {c: [] for c in args.cells}
    for r in range(args.rounds):
        got = []
        for who in ("parent", "change", "change", "parent"):
            ms = turn(trees[who], args.cells, args.epochs)
            got.append(ms)
            print(f"round {r} {who}: " + ", ".join(f"{c} {ms[c]:.1f} ms" for c in args.cells),
                  flush=True)
        for c in args.cells:
            ratios[c].append((got[1][c] + got[2][c]) / (got[0][c] + got[3][c]))
    for c in args.cells:
        print(f"{c}: change / parent epoch {', '.join(f'{x:.4f}' for x in ratios[c])}; "
              f"median {statistics.median(ratios[c]):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
