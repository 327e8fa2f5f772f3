"""The throughput benchmark, the counterpart of the JAX package's ``bench.py``:

    python -m dfd_tpu_torch bench [--device cuda]
    python -m dfd_tpu_torch.bench [--device cuda]
    python -m dfd_tpu_torch.bench --mesh N [--device cuda]

``main`` runs the six cells (:data:`CELLS`: ``bench.py``'s models, envs,
``TrainConfig`` s and epoch counts) on the card, each as one warm epoch step
and then ``n_epochs`` chained ones with no host synchronisation between
them, and prints one JSON line: the ``mlp_trap`` rate as its value, every
cell's env-steps/s in ``suite``, and the card's name and power limit.  The
archive is taken once, empty, before the warm epoch, and stays frozen: no
policy is submitted and zeta's archive is never re-evaluated, so novelty
runs no forward and the host archive that ``train`` pays between epochs is
outside the timed window.

``main_mesh`` is the weak-scaling harness: the ``mlp_trap`` config at
P = ``base_p`` x n over n = 1, 2, 4, ... up to N ranks (n = 1: no mesh, in
this process), each rank a process of its own joined by gloo, on the device
the caller names, as every entry point: on the cards, rank r takes card
r mod their number (gloo carries CUDA tensors, and ranks may share a card,
which NCCL refuses); on the CPU (``--device cpu``) the ranks share the
host's cores, which n = 1 already uses.  So it checks the sharded trainer
and bounds its collectives' cost; it cannot show how the population scales
across cards over NCCL.

The float32 products run in full float32 (:func:`full_f32`), as the
trainer's entry points run them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.envs import PixelGridEnv, ProcMazeEnv, SwimmerEnv, TrapEnv
from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, GaussianMLP, ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils.metrics import EpochReporter


def _sync(device, x: torch.Tensor) -> float:
    """Wait for the card, then read a scalar of ``x`` on the host: the timing
    closes with a value transfer."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return float(x.sum())


def _barrier(mesh) -> None:
    if mesh.group is not None:
        torch.distributed.barrier(group=mesh.group)


def epochs(tr: VectorizedTrainer, state, archive, count: int, n: int):
    """``n`` chained epoch steps of ``tr`` from ``state``: (the last state,
    each epoch's env-step count as a device tensor).  No host
    synchronisation."""
    steps = []
    for _ in range(n):
        state, metrics = tr._epoch_step(state, archive, count)
        steps.append(metrics["_timesteps"])
    return state, steps


def time_epochs(tr: VectorizedTrainer, n_epochs: int):
    """(env-steps, seconds) of ``n_epochs`` chained epoch steps of ``tr``
    after a warm one, which builds and loads the kernels.  Each epoch's step
    count stays on the device until the window has closed.  On a mesh the
    window opens and closes at a barrier of every rank, and the count is the
    whole population's (the trainer gathers it to every rank)."""
    archive, count = tr._archive_inputs()  # empty (count 0) and frozen from here on
    with full_f32():
        state, _ = epochs(tr, tr.state, archive, count, 1)
        _sync(tr.device, state.flat)
        _barrier(tr.mesh)
        t0 = time.perf_counter()
        state, steps = epochs(tr, state, archive, count, n_epochs)
        _sync(tr.device, state.flat)
        _barrier(tr.mesh)
        seconds = time.perf_counter() - t0
    return int(torch.stack(steps).sum()), seconds


def _report(name: str, steps: int, seconds: float, n_epochs: int) -> float:
    rate = steps / seconds
    print(f"[bench:{name}] {steps} env-steps in {seconds:.2f}s over {n_epochs} epochs "
          f"-> {rate:,.0f} steps/s", file=sys.stderr, flush=True)
    return rate


def bench_config(name, model, env, distance_fn, cfg, n_epochs, device="cuda"):
    """Steady-state env-steps/s of one configuration (the host out of the
    loop), reported on stderr."""
    tr = VectorizedTrainer(model, env, distance_fn, cfg, device=device,
                           reporter=EpochReporter(quiet=True))
    return _report(name, *time_epochs(tr, n_epochs), n_epochs)


# -- the cells ----------------------------------------------------------------------

class Cell(NamedTuple):
    name: str
    n_epochs: int
    build: Callable  # device -> (model, env, distance_fn, cfg) on that device


TRAP = dict(batch_size=2048, learning_rate=0.05, noise_std=0.05, zeta_size=64,
            max_strategy_history_size=16, random_seed=0, scan_unroll=8)


def mlp_trap(device, **cfg):
    """``DiscreteMLP(2, 9)`` on the trap env at ``TRAP`` (with ``cfg``'s
    fields replaced)."""
    return (DiscreteMLP(2, 9, device=device), TrapEnv(device=device),
            distances.categorical_tvd, TrainConfig(**dict(TRAP, **cfg)))


def _gaussian_swimmer(device):
    return (GaussianMLP(16, 6, device=device), SwimmerEnv(max_steps=100, device=device),
            distances.gaussian_wasserstein_from_strategies,
            TrainConfig(batch_size=512, zeta_size=16, max_strategy_history_size=8,
                        episode_length=100, random_seed=0, normalize_obs=True))


def _cnn_pixelgrid(device):
    env = PixelGridEnv(grid=8, scale=8, max_steps=40, intensity=1.0, device=device)
    return (AtariCNN((64, 64), env.n_actions, in_channels=3, compute_dtype=torch.bfloat16,
                     device=device), env, distances.categorical_tvd,
            TrainConfig(batch_size=256, zeta_size=16, max_strategy_history_size=8,
                        episode_length=40, random_seed=0))


def _impala(device, batch_size, **model):
    env = ProcMazeEnv(grid=8, scale=8, max_steps=40, num_levels=200, device=device)
    return (ImpalaPolicy(env.obs_shape, env.n_actions, conv_impl="fused_feat", device=device,
                         **model), env, distances.categorical_tvd,
            TrainConfig(batch_size=batch_size, zeta_size=8, max_strategy_history_size=4,
                        episode_length=40, random_seed=0))


# bench.py's six cells, in its order, with its epoch counts
CELLS = (
    Cell("mlp_trap", 30, mlp_trap),
    # E = 8 episodes averaged a member
    Cell("mlp_trap_e8", 12, lambda device: mlp_trap(device, envs_per_perturbation=8)),
    Cell("gaussian_swimmer", 10, _gaussian_swimmer),
    Cell("cnn_pixelgrid", 10, _cnn_pixelgrid),
    Cell("impala_procmaze", 10, lambda device: _impala(device, 128)),
    # production widths, unchunked (about 5.7 GiB at its peak)
    Cell("impala_prod_bf16", 6, lambda device: _impala(
        device, 64, compute_dtype=torch.bfloat16, channels=(64, 128, 128), hidden=512)),
)


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def main(device="cuda") -> dict:
    """Every cell's env-steps/s on ``device``, printed as one JSON line (and
    returned)."""
    device = resolve_device(device)
    suite = {cell.name: bench_config(cell.name, *cell.build(device), cell.n_epochs,
                                     device=device)
             for cell in CELLS}
    line = {
        "metric": "fd_eval_env_steps_per_s_single_chip",
        "value": round(suite["mlp_trap"], 1),
        "unit": "env-steps/s",
        "suite": {k: round(v, 1) for k, v in suite.items()},
        "device": device_line(device),
        "vs_baseline": None,
    }
    print(json.dumps(line), flush=True)
    return line


# -- the mesh harness ---------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_rank(rank: int, world: int, port: int, base_p: int, n_epochs: int,
              device: str) -> int:
    """One rank of ``main_mesh``'s n = ``world`` row on ``device``, in a
    process of its own: prints ``{"steps": ..., "seconds": ...}`` as its
    last line."""
    from dfd_tpu_torch.parallel import initialize_multihost, make_pop_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device, backend="gloo")
    try:
        mesh = make_pop_mesh(device)
        tr = VectorizedTrainer(*mlp_trap(device, batch_size=base_p * world), mesh=mesh,
                               device=device, reporter=EpochReporter(quiet=True))
        steps, seconds = time_epochs(tr, n_epochs)
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"steps": steps, "seconds": seconds}), flush=True)
    return 0


def _rank_device(device: torch.device, rank: int) -> str:
    """The device of rank ``rank``: the CPU, the card ``device`` names, or
    else card ``rank`` mod the number of cards."""
    if device.type == "cpu" or device.index is not None:
        return str(device)
    return f"cuda:{rank % torch.cuda.device_count()}"


def _run_ranks(world: int, base_p: int, n_epochs: int, device: torch.device, timeout: float):
    """(rank 0's env-steps, the slowest rank's seconds) of ``world`` gloo
    processes on ``device``; a rank that fails, or is still running after
    ``timeout`` seconds, stops the others and raises."""
    root = str(Path(__file__).resolve().parents[1])  # this package, in every rank
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + path if path else root)
    code = ("import sys; from dfd_tpu_torch.bench import mesh_rank; "
            "sys.exit(mesh_rank(*map(int, sys.argv[1:6]), sys.argv[6]))")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port),
                               str(base_p), str(n_epochs), _rank_device(device, r)], env=env, stdout=subprocess.PIPE,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:  # until every rank has ended, one has failed (the others would wait for it) or time is up
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline and \
                not any(p.returncode for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"mesh harness: ranks {bad} of {world} failed or timed out "
                           f"(rc {[procs[r].returncode for r in bad]})")
    rows = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    if len({row["steps"] for row in rows}) != 1:
        raise RuntimeError(f"mesh harness: the ranks counted different steps: {rows}")
    return rows[0]["steps"], max(row["seconds"] for row in rows)


def main_mesh(n_devices: int, base_p: int = 256, n_epochs: int = 6, device="cuda",
              timeout: float = 3600.0) -> dict:
    """The weak-scaling harness over gloo processes on ``device`` (see the
    module's docstring), printed as one JSON line (and returned); each row
    of ranks gets ``timeout`` seconds."""
    device = resolve_device(device)
    rows = {}
    n = 1
    while n <= n_devices:
        if n == 1:
            rows[n] = bench_config("mesh1", *mlp_trap(device, batch_size=base_p), n_epochs,
                                   device=device)
        else:
            rows[n] = _report(f"mesh{n}", *_run_ranks(n, base_p, n_epochs, device, timeout),
                              n_epochs)
        n *= 2
    top = max(rows)
    if device.type == "cpu":
        where, shared = "on the CPU", "share one host's cores (n=1 already uses them all)"
    else:
        cards = 1 if device.index is not None else torch.cuda.device_count()
        where, shared = f"on {cards} card(s)", f"take card r mod {cards}, sharing where n > {cards}"
    line = {
        "metric": f"fd_eval_mesh_harness_steps_per_s_{top}dev",
        "value": round(rows[top], 1),
        "unit": f"env-steps/s (P={base_p} x n sharded over n gloo processes {where})",
        "vs_baseline": None,
        "note": (f"the processes {shared}; they reduce over gloo: validates the sharded "
                 "trainer and bounds its collectives' cost, not scaling across cards over NCCL"),
        "suite": {f"steps_per_s_{n}dev": round(v, 1) for n, v in rows.items()},
    }
    print(json.dumps(line), flush=True)
    return line


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dfd_tpu_torch.bench")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="the weak-scaling harness over 1, 2, 4, ... N gloo processes")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cells or the ranks (cuda, or cpu); no fallback "
                        "to the CPU")
    args = p.parse_args(argv)
    from dfd_tpu_torch.__main__ import _device, main as entry

    if args.mesh is None:
        return entry(["bench", "--device", args.device])
    device = _device(args)
    if device is None:
        return 2
    main_mesh(args.mesh, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
