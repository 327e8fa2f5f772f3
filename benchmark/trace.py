"""Reading a ``torch.profiler`` trace of the traced window.

From the Chrome trace the profiler exports: every device operation
(kernels, copies, fills) with its interval; the device's busy time as the
union of those intervals, so that overlapping operations count once; the
kernel launches the host made (the runtime's and the driver's launch calls);
the device's time by operation name; and each idle gap between device
operations labelled by the host operation running at its middle (the
innermost one), or by the host operation that ended the gap where none ran.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


class Trace(NamedTuple):
    busy_s: float
    launches: int
    device_s: Dict[str, float]      # seconds on the device by operation name
    idle_by_host: Dict[str, float]  # idle seconds between device operations by host operation


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label_gaps(gaps: List[Tuple[float, float]], host: List[Tuple[float, float, str]]):
    """Each gap's label: the innermost host operation covering its middle,
    else ``"host:before <next operation>"``."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    starts = [e[0] for e in host]
    labels, stack, i = [], [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        if stack:
            labels.append(stack[-1][2])
        else:
            nxt = bisect.bisect_right(starts, mid)
            labels.append(f"host:before {host[nxt][2]}" if nxt < len(host) else "host:end")
    return labels


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, launches = [], [], 0
    device_s: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            device_s[name] += dur * 1e-6
        elif cat in LAUNCH_CATS and "LaunchKernel" in name:
            launches += 1
        elif cat == "cpu_op":
            host.append((ts, ts + dur, name))
    busy = _union(device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(sorted(gaps), _label_gaps(gaps, host)):
        idle[label] += (b - a) * 1e-6
    return Trace(sum(b - a for a, b in busy) * 1e-6, launches, dict(device_s), dict(idle))


def top(table: Dict[str, float], n: int = TOP) -> List[List]:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
