"""One run of one cell: set-up, the measured window, the traced window, the
check, and the result line.

Set-up builds the program's trainer for the cell on the device from the
seed (its weights and zeta replaced by the benchmark's, its draws the
benchmark's), then drives it through the cell's ``check_epochs`` epochs by
``train``, the loop the window drives, recording what the check reads (the
first epoch builds or loads every kernel; these epochs warm every shape the
window uses).  The window opens at that epoch boundary and closes at the
first boundary past ``seconds``; every epoch is stamped by the benchmark's
reporter.  With ``trace`` a second, traced window of ``trace_seconds``
follows under ``torch.profiler``.  Then the trainer is freed and the plain
reference judges the recorded epochs.
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check
from benchmark import trace as trace_mod
from benchmark.reference import dfd

BANNED = ("jax", "jaxlib", "flax", "dfd_tpu")
TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "benchmark"


class WindowClosed(Exception):
    """Raised by the reporter at the first epoch boundary past the deadline."""


class Stamps:
    """The trainer's reporter: stamps each epoch's end on the host clock,
    keeps its report, calls ``on_epoch`` (set-up's recording), and closes
    the window past ``deadline``."""

    def __init__(self):
        self.rows: List[tuple] = []
        self.deadline: Optional[float] = None
        self.on_epoch = None

    def report(self, m: Dict) -> None:
        now = time.perf_counter()
        self.rows.append((now, dict(m)))
        if self.on_epoch is not None:
            self.on_epoch(m)
        if self.deadline is not None and now >= self.deadline:
            raise WindowClosed


class Recorder:
    """Set-up's record of the program: the actions its rollout hands the
    env (by the env's ``step``, shadowed on the instance while recording),
    and after each epoch theta, zeta, the metrics and the archive's
    members."""

    def __init__(self, trainer):
        self.tr = trainer
        self.record = dfd.Record(theta=[trainer.state.flat.cpu()],
                                 zeta=[trainer.state.zeta.cpu()])
        self._steps: List[torch.Tensor] = []
        env = trainer.env
        original = type(env).step

        def step(state, action):
            self._steps.append(action.detach().clone())
            return original(env, state, action)

        env.step = step

    def stop(self) -> None:
        del self.tr.env.step

    def epoch(self, m: Dict) -> None:
        rec, st = self.record, self.tr.state
        rec.theta.append(st.flat.cpu())
        rec.zeta.append(st.zeta.cpu())
        rec.actions.append(torch.stack(self._steps).cpu())
        self._steps.clear()
        rec.metrics.append({k: float(v) for k, v in m.items() if not k.startswith("_")
                            and isinstance(v, (int, float))})
        rec.archive.append([self._index(p.flat) for p in self.tr.handler.archive.points])

    def _index(self, flat: np.ndarray) -> int:
        """The epoch s whose theta_s the archived ``flat`` is, bit for bit."""
        for s in range(len(self.record.theta) - 1, -1, -1):
            if np.array_equal(self.record.theta[s].numpy(), flat):
                return s
        return -1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(trainer, stamps: Stamps, seconds: float, device):
    """Epochs of ``train`` until the first boundary past ``seconds``:
    (opening time, rows of (stamp, report))."""
    _sync(device)
    stamps.rows = []
    opened = time.perf_counter()
    stamps.deadline = opened + seconds
    try:
        trainer.train(1 << 30)
    except WindowClosed:
        pass
    stamps.deadline = None
    return opened, list(stamps.rows)


def setup(cell, seed: int, device):
    """The program's trainer for ``cell`` from ``seed``, driven by ``train``
    through the cell's check epochs: (trainer, its reporter, the record)."""
    w = cell.workload
    stamps = Stamps()
    trainer = cell.arch.build_program(cell.config, w, seed, device, stamps,
                                      check.draw_source(cell, seed, device))
    theta0, zeta0 = cell.arch.initial_inputs(cell.config, w, seed, device)
    trainer.state = trainer.state._replace(flat=theta0.clone(), zeta=zeta0.clone())
    recorder = Recorder(trainer)
    stamps.on_epoch = recorder.epoch
    trainer.train(w["check_epochs"])
    recorder.stop()
    stamps.on_epoch = None
    return trainer, stamps, recorder.record


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in BANNED})


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> SimpleNamespace:
    """One run of ``cell``: its result line's parts and the check's lines."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    w = cell.workload
    t_build = time.perf_counter()
    trainer, stamps, record = setup(cell, seed, device)
    t_checked = time.perf_counter()
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    steps0 = trainer.cumulative_timesteps
    opened, rows = _window(trainer, stamps, seconds, device)
    setup_s = opened - t0
    window = SimpleNamespace(
        seconds=rows[-1][0] - opened, epochs=len(rows),
        env_steps=trainer.cumulative_timesteps - steps0,
        epoch_s=list(np.diff([opened] + [r[0] for r in rows])),
        reports=[r[1] for r in rows])
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t_a = time.perf_counter()
            _, trows = _window(trainer, stamps, w["trace_seconds"], device)
            _sync(device)
            t_b = time.perf_counter()
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        read = trace_mod.read(str(path))
        path.unlink()
        traced = SimpleNamespace(window_s=t_b - t_a, epochs=len(trows), **read._asdict())

    ctx = SimpleNamespace(cell=cell, config=cell.config, workload=w, on_card=on_card,
                          setup_s=setup_s, window=window, window_peak_bytes=window_peak,
                          trace=traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    memory_peak = max(setup_peak, window_peak) if on_card else 0

    # the program freed before the reference runs on the device
    del trainer, stamps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.judge(cell, seed, record, device)
    t_ref = time.perf_counter() - t_ref
    correct, lines, table = check.verdict(numbers, w["limits"])
    steps = [int(r["Cumulative Timesteps"]) for r in window.reports]
    lines.insert(0, f"window: {window.epochs} epochs in {window.seconds:.6g} s, "
                    f"{window.env_steps} env steps ({np.mean(np.diff([steps0] + steps)):.6g} an "
                    f"epoch), epoch ms median {1e3 * np.median(window.epoch_s):.6g} "
                    f"mean {1e3 * np.mean(window.epoch_s):.6g}; setup {setup_s:.6g} s: "
                    f"{t_build - t0:.3g} to the trainer's build, {t_checked - t_build:.3g} in "
                    f"the build and the {w['check_epochs']} check epochs"
                    + (f"; traced {traced.epochs} epochs in {traced.window_s:.6g} s"
                       if traced is not None else "") + f"; the reference took {t_ref:.3g} s")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        breakdown = {"device_ops": trace_mod.top(traced.device_s),
                     "idle_gaps": trace_mod.top(traced.idle_by_host)}
    return SimpleNamespace(correct=correct, attempted=window.epochs, failed=0, metrics=metrics,
                           device=dev, breakdown=breakdown, checks=table, lines=lines)


def result_line(res, on_card: bool) -> Dict:
    """The last line of standard output, the checks' key last.  Off the card
    no number is written under a metric's name: they go to
    ``cpu_readings``."""
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": res.metrics if on_card else {}, "device": res.device}
    if not on_card:
        line["cpu_readings"] = res.metrics
    if res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = res.checks
    return line
