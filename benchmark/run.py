"""The benchmark of ``dfd_tpu_torch``: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the check's numbers and limits as the last lines of standard error,
and the result as one JSON object, the last line of standard output.  Exits
with 2 and prints no result where there is no CUDA card, or fewer than the
cell asks for; with 3 where JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


def main(argv=None) -> int:
    t0 = _process_start()
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    base = ROOT / "build" / "benchmark"  # kernel caches at fixed paths in the checkout
    os.environ.update(TRITON_CACHE_DIR=str(base / "triton"),
                      TORCH_EXTENSIONS_DIR=str(base / "torch_extensions"),
                      CUDA_CACHE_PATH=str(base / "nv_compute_cache"))
    import torch

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: modules loaded that the port must not load: {banned}", file=sys.stderr)
        return 3
    for line in res.lines:
        print(line, file=sys.stderr)
    print(json.dumps(harness.result_line(res, on_card=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
