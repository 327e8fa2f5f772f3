"""The port's spans (``dfd_tpu_torch/utils/profiling.py``: ``StageTimer``,
``span``) on a tiny IMPALA trainer: every span of the epoch is reported,
the torso counts its frames and members exactly, children's host seconds
stay within their parents', the profiler's ranges appear in its trace and
cost no ``record_function`` call while it is off, and device seconds read
from events the device has passed, carrying the rest to a later report.

    python -m pytest -p no:cacheprovider tests/test_torch_tracing.py -q

The ``cuda`` test reads the device seconds on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q -k card
"""

import json

import pytest
import torch

from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.envs import ProcMazeEnv
from dfd_tpu_torch.models import ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils import profiling
from dfd_tpu_torch.utils.profiling import StageTimer, span

P, T, Z, H = 4, 6, 3, 2
TOP = ("perturb", "rollout", "novelty", "eval", "update")  # inside device_step
ROLLOUT = ("torso", "fc", "core", "env")                    # inside rollout
SPANS = ("archive", "device_step") + TOP + ROLLOUT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _trainer(device="cpu", conv_impl="fused_feat"):
    env = ProcMazeEnv(grid=4, scale=8, max_steps=T, num_levels=20, device=device)
    cfg = TrainConfig(batch_size=P, zeta_size=Z, max_strategy_history_size=H, random_seed=1,
                      episode_length=T)
    model = ImpalaPolicy(env.obs_shape, 5, channels=(8, 8, 8), hidden=16, conv_impl=conv_impl,
                         device=device)
    return VectorizedTrainer(model, env, distances.categorical_tvd, cfg, device=device)


def _epochs(tr, n):
    """The reports of ``n`` more epochs."""
    tr.train(n)
    return tr.reporter.history[-n:]


def test_an_epoch_reports_every_span_and_no_device_seconds_off_the_card():
    tr = _trainer()
    row = _epochs(tr, 3)[-1]
    assert {f"_stage/{name}" for name in SPANS} <= set(row)
    assert {"_stage/torso.frames", "_stage/torso.members"} <= set(row)
    assert all(row[f"_stage/{name}"] > 0 for name in SPANS)
    assert not any(k.endswith(".device") for k in row)
    assert tr.timer.totals == {}


@pytest.mark.parametrize("conv_impl", ["fused_feat", "nhwc"])
def test_the_torso_counts_every_frame_and_member_of_the_epoch(conv_impl):
    """T (P + 1) frames of the rollout, (P + 1) Z of the novelty once the
    archive holds 2 strategies, Z for each archived policy the zeta refresh
    re-evaluates and Z for a candidate scored against a full archive."""
    tr = _trainer(conv_impl=conv_impl)
    tr._archive_current()  # the first train call's own submission, made here
    for _ in range(4):
        count = tr._archive_inputs()[1]
        n0 = len(tr.handler.archive.points)
        archive_calls = n0 + (n0 >= H)
        row = _epochs(tr, 1)[0]
        novelty = count >= 2
        frames = T * (P + 1) + novelty * (P + 1) * Z + archive_calls * Z
        assert row["_stage/torso.frames"] == frames
        assert row["_stage/torso.members"] == T * (P + 1) + novelty * (P + 1) + archive_calls
    assert novelty and n0 == H


def test_children_take_no_more_host_time_than_their_parents():
    tr = _trainer()
    for row in _epochs(tr, 3):
        s = lambda *names: sum(row.get(f"_stage/{n}", 0.0) for n in names)
        assert s(*TOP) <= s("device_step")
        assert s("core", "env") <= s("rollout")
        assert s("torso", "fc") <= s("rollout", "novelty", "archive")


class _Counting:
    """``record_function`` with a count of its calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def test_with_the_profiler_off_no_range_is_made(monkeypatch):
    tr = _trainer()
    tr.train(1)
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    tr.train(2)
    assert counting.calls == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train(1)
    assert counting.calls >= T * len(ROLLOUT)


def test_the_profiler_trace_holds_a_range_for_every_span(tmp_path):
    tr = _trainer()
    tr.train(2)
    with profiling.trace(str(tmp_path)):
        tr.train(1)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {f"dfd/{name}" for name in SPANS} <= names


def test_a_span_outside_an_active_timer_is_a_range_or_nothing():
    assert profiling.span("torso", frames=3) is profiling.span("fc")  # the shared null context
    timer, inner = StageTimer(), StageTimer()
    with timer.active():
        with span("torso", frames=3, members=1):
            with inner.active():
                with span("fc"):
                    pass
            with span("torso", frames=2, members=1):
                pass
    out = timer.report()
    assert out["_stage/torso.frames"] == 5 and out["_stage/torso.members"] == 2
    assert "_stage/fc" not in out and "_stage/fc" in inner.report()
    assert getattr(profiling._ACTIVE, "timer", None) is None


class _Event:
    """A CUDA event's stand-in: passed by the device once ``done``; it has
    no ``synchronize`` or ``wait``, so a timer that waits on it fails."""

    clock = 0.0

    def __init__(self):
        self.done, self.at = False, None

    def stamp(self):
        _Event.clock += 1.0
        self.at, self.done = _Event.clock, False
        return self

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)  # ms


class _FakeCudaTimer(StageTimer):
    def __init__(self):
        super().__init__()
        self._cuda, self.made, self.recorded = True, 0, []

    def _record(self):
        if self._free:
            event = self._free.pop()
        else:
            event, self.made = _Event(), self.made + 1
        self.recorded.append(event.stamp())
        return event


def test_device_seconds_come_from_passed_events_and_the_rest_wait():
    timer = _FakeCudaTimer()
    with timer.stage("rollout"):          # events at 1 and 6: 5 s
        with timer.stage("torso"):        # 2 and 3: 1 s
            pass
        with timer.stage("env"):          # 4 and 5: 1 s
            pass
    for e in timer.recorded:
        e.done = True
    with timer.stage("update"):           # 7 and 8, not yet passed
        pass
    out = timer.report()
    assert out["_stage/rollout.device"] == pytest.approx(5.0)
    assert out["_stage/rollout.self.device"] == pytest.approx(3.0)
    assert out["_stage/torso.device"] == pytest.approx(1.0)
    assert "_stage/torso.self.device" not in out and "_stage/update.device" not in out
    assert "_stage/update" in out and len(timer._pending) == 1
    timer.recorded[-1].done = True
    assert timer.report() == {"_stage/update.device": pytest.approx(1.0)}
    with timer.stage("torso"):            # reuses the pool's events
        pass
    assert timer.made == 8 and len(timer._free) == 6


def test_a_span_opened_after_its_sibling_starts_at_its_end_event():
    timer = _FakeCudaTimer()
    with timer.stage("rollout"):
        for step in range(2):
            with timer.stage("torso"):
                pass
            with timer.stage("fc", after="torso"):
                pass
            with timer.stage("env", after="core"):  # core did not close last: a fresh start
                pass
        with timer.stage("core", after="env"):  # starts at the last env's end
            with timer.stage("env", after="core"):  # core is open, not closed: a fresh start
                pass
    # rollout 2 + a step's torso 2, fc 1, env 2, twice + core 1, env 2
    assert timer.made == 2 + 2 * 5 + 1 + 2
    for e in timer.recorded:
        e.done = True
    out = timer.report()
    assert out["_stage/fc.device"] == pytest.approx(2.0)  # 1 s a step: torso's end to its own
    assert out["_stage/core.device"] == pytest.approx(3.0)
    assert out["_stage/rollout.device"] == pytest.approx(timer.made - 1)
    assert out["_stage/rollout.self.device"] == pytest.approx(5.0)  # 1 s at each fresh boundary
    assert len(timer._free) == timer.made  # every event freed once


def test_passed_events_are_read_while_spans_pile_up(monkeypatch):
    monkeypatch.setattr(profiling, "DRAIN", 4)
    timer = _FakeCudaTimer()
    for _ in range(10):
        with timer.stage("env"):
            pass
        for e in timer.recorded:  # the device right behind the host
            e.done = True
    assert timer.totals["env.device"] > 0 and len(timer._pending) < 4
    assert timer.made <= 8  # the pool recycles what was read
    assert timer.report()["_stage/env.device"] == pytest.approx(10.0)


def test_an_event_a_later_span_starts_at_is_not_reused_before_it_is_read(monkeypatch):
    monkeypatch.setattr(profiling, "DRAIN", 2)
    timer = _FakeCudaTimer()
    for _ in range(6):  # the device passes every event as soon as it is recorded
        for name, after in (("torso", None), ("fc", "torso"), ("core", "fc")):
            with timer.stage(name, after=after):
                pass
            for e in timer.recorded:
                e.done = True
    out = timer.report()
    for name in ("torso", "fc", "core"):
        assert out[f"_stage/{name}.device"] == pytest.approx(6.0)
    assert len(set(map(id, timer._free))) == len(timer._free) == timer.made == 4


def test_across_streams_each_end_event_is_queried():
    timer = _FakeCudaTimer()
    for name in ("perturb", "rollout"):
        with timer.stage(name):
            pass
    timer._one_stream = False  # as after a switch of stream with records pending
    timer.recorded[-1].done = True  # the later span's stream passed it, the earlier's not
    out = timer.report()
    assert "_stage/rollout.device" in out and "_stage/perturb.device" not in out
    timer.recorded[1].done = True
    assert set(timer.report()) == {"_stage/perturb.device"} and timer._one_stream


@pytest.mark.cuda
def test_on_the_card_every_span_has_device_seconds_within_its_parents(cuda):
    tr = _trainer(cuda)
    rows = _epochs(tr, 4)
    for row in rows[1:]:
        d = lambda *names: sum(row.get(f"_stage/{n}.device", 0.0) for n in names)
        assert all(f"_stage/{name}.device" in row for name in TOP + ROLLOUT + ("device_step",))
        slack = 1e-5 * (len(TOP) + len(ROLLOUT))  # the events' microsecond resolution
        assert d(*TOP) <= d("device_step") + slack
        assert d("core", "env") <= d("rollout") + slack
        assert d("torso", "fc") <= d("rollout", "novelty", "archive") + slack
        for name in ("device_step", "rollout"):
            assert row[f"_stage/{name}.self.device"] >= -slack
    # the archive full: the novelty's forward and H + 1 archive calls
    assert rows[-1]["_stage/torso.frames"] == T * (P + 1) + (P + 1) * Z + (H + 1) * Z
