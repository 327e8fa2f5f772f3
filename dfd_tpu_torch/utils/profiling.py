"""Profiling helpers.

- :func:`trace` — context manager around ``torch.profiler`` (CPU and, where
  there is one, CUDA activity) that writes a Chrome trace of whatever runs
  inside to ``log_dir`` and hands back the profiler for ``key_averages()``;
- :class:`StageTimer` and :func:`span` — named spans surfaced into the
  epoch report as ``_stage/...`` keys (underscore-prefixed: logged,
  console-suppressed): host seconds, device seconds from CUDA events,
  counts, and ``dfd/<name>`` ranges in a ``torch.profiler`` trace;
- :func:`time_ms` and :func:`bound` — a kernel's time on the card with CUDA
  events, and the least time the card could take for the same work, from
  the H100 SXM's published peaks (``F32_RATE``, ``BF16_RATE``,
  ``TF32_RATE`` and ``TF32X3_RATE``, ``BYTES_RATE``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

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


DRAIN = 256  # closed spans a StageTimer keeps pending before it reads their events


class StageTimer:
    """A runner's named stages, summed between reports.  A stage is a span
    with, under ``_stage/`` in :meth:`report`:

    - ``<name>``: its host seconds;
    - ``<name>.device``: on a CUDA ``device``, its seconds on the device's
      stream, between two CUDA events recorded at its boundaries (taken from
      a pool reused across reports).  The events are read without waiting:
      at :meth:`report`, which follows the epoch's metrics fetch, and
      whenever ``DRAIN`` closed spans are pending, so that the reading is
      spread over the epoch, while the device works through the queue the
      host is ahead by, rather than done at its end, where the device waits
      for the next epoch.  An event the device has not reached yet is read
      later;
    - ``<name>.self.device``: for a span with spans inside it, its device
      seconds less theirs;
    - ``<name>.<count>``: the counts its calls passed (:meth:`stage`'s
      keywords), summed.

    A span opened ``after="<name>"`` starts at the end event of the span
    ``<name>`` where that is the span closed last, in the same parent (the
    caller queues no device work between the two): one event less on the
    device's stream.

    While ``torch.profiler`` runs, a span is also the range ``dfd/<name>``
    in its trace; otherwise only the profiler's flag is read.  A runner
    makes its timer :meth:`active` so that :func:`span` in the code it
    calls (the rollout, the model, the env step) reaches it.
    """

    def __init__(self, device=None):
        self.totals: Dict[str, float] = defaultdict(int)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = torch.device(device) if self._cuda else None
        self._stream = torch.cuda.current_stream(self._device) if self._cuda else None
        self._free: List = []     # events read and free for reuse
        self._open: List = []     # records of the spans open now, innermost last
        self._pending: List = []  # records of closed spans whose events are not read yet
        self._last = None         # the record of the span closed last, if none opened since
        self._one_stream = True   # every pending record's events on self._stream
        self._keys: Dict[str, tuple] = {}  # name -> its device and self-device keys

    def stage(self, name: str, after: Optional[str] = None, **counts: int) -> "_Span":
        """The span ``name`` as a context manager; ``counts`` are added to
        ``<name>.<count>``."""
        return _Span(self, name, after, counts)

    @contextlib.contextmanager
    def active(self) -> Iterator["StageTimer"]:
        """This timer as the one :func:`span` reaches in this thread, its
        events recorded on the stream current now."""
        outer = getattr(_ACTIVE, "timer", None)
        _ACTIVE.timer = self
        if self._cuda:
            stream = torch.cuda.current_stream(self._device)
            if stream != self._stream:
                self._one_stream = not self._pending
                self._stream = stream
        try:
            yield self
        finally:
            _ACTIVE.timer = outer

    def _record(self):
        """A timing event recorded on the timer's stream (looking the
        current stream up costs as much as a launch)."""
        event = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        return event

    def _passed(self) -> List[bool]:
        """Whether the device has passed each pending record's end event.
        On one stream it passes them in the order they were recorded, so
        a bisection queries a few; across streams each is queried."""
        pending = self._pending
        if not self._one_stream:
            return [rec[2].query() for rec in pending]
        lo, hi = 0, len(pending)
        while lo < hi:
            mid = (lo + hi) // 2
            if pending[mid][2].query():
                lo = mid + 1
            else:
                hi = mid
        return [True] * lo + [False] * (len(pending) - lo)

    def _read_events(self) -> None:
        """Device seconds of every closed span whose end event the device
        has passed; the rest, and the span closed last while a span may
        still open ``after`` it, wait.  A record is [name, start, end,
        parent record, children's seconds or None, whether it frees its end
        event (not where a span opened ``after`` it starts there and frees
        it)]; a span closes after the spans inside it, so they are read
        first."""
        totals, keys, waiting = self.totals, self._keys, []
        for rec, passed in zip(self._pending, self._passed()):
            if not passed or rec is self._last:
                waiting.append(rec)
                continue
            name, start, end, parent, inner, owns_end = rec
            s = start.elapsed_time(end) * 1e-3
            if name not in keys:
                keys[name] = (f"{name}.device", f"{name}.self.device")
            device_key, self_key = keys[name]
            totals[device_key] += s
            if inner is not None:
                totals[self_key] += s - inner
            if parent is not None:
                parent[4] = (parent[4] or 0.0) + s
            self._free.append(start)
            if owns_end:
                self._free.append(end)
        self._pending = waiting
        self._one_stream = self._one_stream or not waiting

    def report(self) -> Dict[str, float]:
        """The stage totals since the last report, then reset.  No span
        opens ``after`` one closed before a report."""
        self._last = None
        if self._pending:
            self._read_events()
        out = {f"_stage/{k}": v for k, v in self.totals.items()}
        self.totals.clear()
        return out


class _Span:
    """One span of a :class:`StageTimer` (``timer``) or, with none, only
    the profiler's range."""

    __slots__ = ("timer", "name", "after", "counts", "t0", "rec", "range")

    def __init__(self, timer: Optional[StageTimer], name: str, after: Optional[str],
                 counts: Dict[str, int]):
        self.timer, self.name, self.after, self.counts = timer, name, after, counts

    def __enter__(self) -> "_Span":
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function("dfd/" + self.name)
            self.range.__enter__()
        timer = self.timer
        if timer is not None:
            if timer._cuda:
                parent, last = timer._open[-1] if timer._open else None, timer._last
                if last is not None and last[0] == self.after and last[3] is parent:
                    last[5] = False
                    start = last[2]
                else:
                    start = timer._record()
                self.rec = [self.name, start, None, parent, None, True]
                timer._open.append(self.rec)
                timer._last = None
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        timer = self.timer
        if timer is not None:
            totals = timer.totals
            totals[self.name] += time.perf_counter() - self.t0
            for k, n in self.counts.items():
                totals[f"{self.name}.{k}"] += n
            if timer._cuda:
                self.rec[2] = timer._record()
                timer._open.pop()
                timer._pending.append(self.rec)
                timer._last = self.rec
                if len(timer._pending) >= DRAIN:
                    timer._read_events()
        if self.range is not None:
            self.range.__exit__(*exc)


_ACTIVE = threading.local()  # .timer: the StageTimer that span() reaches in this thread


def span(name: str, after: Optional[str] = None, **counts: int):
    """The span ``name`` (``after``, with ``counts``: see
    :class:`StageTimer`) of this thread's active timer; with none active,
    the profiler's range ``dfd/<name>`` alone while the profiler runs, else
    nothing."""
    timer = getattr(_ACTIVE, "timer", None)
    if timer is None and not _profiler._is_profiler_enabled:
        return _NOTHING
    return _Span(timer, name, after, counts)


_NOTHING = contextlib.nullcontext()


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
