"""Profiling helpers.

- :func:`trace` — context manager around ``torch.profiler`` (CPU and, where
  there is one, CUDA activity) that writes a Chrome trace of whatever runs
  inside to ``log_dir`` and hands back the profiler for ``key_averages()``;
- :class:`StageTimer` — cheap named wall-clock stages surfaced into the epoch
  report as ``_stage/...`` keys (underscore-prefixed: logged,
  console-suppressed);
- :func:`time_ms` and :func:`bound` — a kernel's time on the card with CUDA
  events, and the least time the card could take for the same work, from
  the H100 SXM's published peaks (``F32_RATE``, ``BF16_RATE``,
  ``TF32_RATE`` and ``TF32X3_RATE``, ``BYTES_RATE``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

import torch

F32_RATE = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
BF16_RATE = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
TF32_RATE = 495e12    # H100 SXM dense TF32 tensor-core FLOP/s
TF32X3_RATE = TF32_RATE / 3  # f32-accurate products as three TF32 ones (3xTF32)
BYTES_RATE = 3.35e12  # H100 SXM HBM3 bytes/s
SPIN_CYCLES_PER_S = 2.0e9  # at least the H100's SM clock (1.98 GHz at most)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        """The stage totals since the last report, then reset."""
        out = {f"_stage/{k}": v for k, v in self.totals.items()}
        self.totals.clear()
        return out


def time_ms(fn: Callable, dev: torch.device, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` calls after one warm call: CUDA
    events on the card, the host clock on the CPU.

    On the card the calls are queued behind a spin kernel that lasts longer
    than the host takes to enqueue them, so the events time the card's work
    and not the host's launch rate (a launch through ctypes costs the host
    more time than many of these kernels take on the card)."""
    t0 = time.perf_counter()
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    enqueue_s = time.perf_counter() - t0  # at least the host's time to enqueue one call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (1.5 * iters * enqueue_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def bound(nbytes: float, *work):
    """(least ms for the work, "operations" or "bytes"): the larger of the
    operations' time, summed over ``work``'s (count, rate per second) pairs,
    and the bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops, t_bytes = sum(n / rate for n, rate in work), nbytes / BYTES_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
