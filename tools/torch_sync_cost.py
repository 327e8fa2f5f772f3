"""What the epoch's wait for the card cost the port's trainer, in one process on one card.

    python3 tools/torch_sync_cost.py [--cells CELL ...] [--rounds N] [--epochs N]

For each cell (``tools/torch_epoch_turns.py``'s, with their ``bench.py``
``TrainConfig``s) one trainer warms two epochs, then times blocks of
``train_fast(epochs, sync_every=epochs)`` in two modes, in turns
(``now, waiting, waiting, now`` a round):

- ``now``: the member keys of an epoch go to the card once, from pinned
  memory without waiting (``CounterNoise.prepare``);
- ``waiting``: every block of members copies its keys from pageable memory
  with a blocking copy, which waits for the card's stream to drain: once an
  epoch unchunked, twice a chunk when chunked (perturb and combine).

Both modes draw the same noise, so only the host's waits differ.  Prints
each block's epoch time and per cell each round's waiting / now ratio and
their median.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_epoch_turns import CELLS, make_trainer  # noqa: E402


def set_mode(noise, waiting: bool) -> None:
    """Key transfers as now, or each block's blocking copy from pageable memory."""
    for name in ("prepare", "_to_device"):
        noise.__dict__.pop(name, None)
    noise._prepared = None
    if waiting:
        noise.prepare = lambda epoch, members: None
        noise._to_device = lambda words: torch.from_numpy(
            np.ascontiguousarray(words).reshape(-1, 2).view(np.int32)).to(noise.device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sync_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for cell in args.cells:
        tr = make_trainer(cell)
        tr.train_fast(2, sync_every=2)  # builds the kernels, fills the archive for novelty
        ratios = []
        for r in range(args.rounds):
            ms = []
            for waiting in (False, True, True, False):
                set_mode(tr.noise, waiting)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_fast(args.epochs, sync_every=args.epochs)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) / args.epochs * 1e3)
            ratios.append((ms[1] + ms[2]) / (ms[0] + ms[3]))
            print(f"{cell} round {r}: epoch now {ms[0]:.1f}, waiting {ms[1]:.1f}, waiting "
                  f"{ms[2]:.1f}, now {ms[3]:.1f} ms", flush=True)
        print(f"{cell}: waiting / now epoch {', '.join(f'{x:.4f}' for x in ratios)}; median "
              f"{statistics.median(ratios):.4f}", flush=True)
        del tr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
