"""The readers of the program's spans (``torso_span_roofline``,
``fc_device_ms``, ``rollout_self_device_ms``) on synthetic window reports:
their values and units, and no value where the reports lack their keys, as
on the CPU or at a commit whose program has no such span."""

from types import SimpleNamespace

import pytest

from benchmark import peaks, spec
from benchmark.arch import impala

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
ENTRY = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIG = spec.load_json(spec.ROOT / "benchmark/configs/impala_procgen.json")


def _ctx(reports, config=CONFIG):
    return SimpleNamespace(cell=SimpleNamespace(arch=impala), config=config, on_card=True,
                           window=SimpleNamespace(reports=reports, epochs=len(reports)))


@pytest.mark.parametrize("name,unit,better,layer", [
    ("torso_span_roofline", "%", "higher", "kernels"),
    ("fc_device_ms", "ms/epoch", "lower", "rollout loop"),
    ("rollout_self_device_ms", "ms/epoch", "lower", "rollout loop"),
])
def test_each_span_metric_is_declared_for_both_cells(name, unit, better, layer):
    m = ENTRY[name]
    assert (m["unit"], m["better"], m["layer"]) == (unit, better, layer)
    assert m["source"] == "program_span" and m["moves"] == "env_steps_per_s"
    assert m["workloads"] == CELLS
    assert all(name in {x.name for x in spec.cell(c).per_layer} for c in CELLS)


@pytest.mark.parametrize("name,key", [("fc_device_ms", "_stage/fc.device"),
                                      ("rollout_self_device_ms", "_stage/rollout.self.device")])
def test_a_device_span_reads_ms_an_epoch_over_every_report(name, key):
    read = spec.reader(name).read
    # the second epoch's events were read at the third report
    reports = [{key: 0.6}, {"_stage/fc": 0.1}, {key: 1.2}]
    assert read(_ctx(reports)) == pytest.approx(600.0)
    assert read(_ctx([{"_stage/fc": 0.1, "_stage/archive": 0.04}])) is None
    assert read(_ctx([])) is None


def _one_stage_config(dtype):
    return dict(CONFIG, channels=[16], compute_dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_torso_roofline_counts_every_block_once_a_frame_and_a_member(dtype):
    """One stage at 64x64: a feature block 3 -> 16 (unfused: 3 channels) and
    a residual pair at 32x32, each the larger of operations and bytes."""
    cfg = _one_stage_config(dtype)
    assert [(c.kind, c.fused) for c in impala.convs(cfg)] == [("feat", False), ("res", True)]
    F, M = 3000, 1000
    feat = max(F * 2 * 9 * 3 * 16 * 64 * 64 / peaks.flops(dtype),
               4 * (F * (3 * 64 * 64 + 16 * 32 * 32) + M * (16 * 9 * 3 + 16 + 2 * 3))
               / peaks.HBM_BYTES)
    res = max(F * 4 * 2 * 9 * 16 * 16 * 32 * 32 / peaks.flops(dtype),
              4 * (F * 2 * 16 * 32 * 32 + M * 4 * (16 * 9 * 16 + 3 * 16)) / peaks.HBM_BYTES)
    read = spec.reader("torso_span_roofline").read
    half = {"_stage/torso.frames": F // 2, "_stage/torso.members": M // 2}
    seconds = 10 * (feat + res)
    reports = [dict(half, **{"_stage/torso.device": seconds / 4}),
               dict(half, **{"_stage/torso.device": 3 * seconds / 4})]
    assert read(_ctx(reports, cfg)) == pytest.approx(10.0)
    reports[1]["_stage/torso.device"] *= 2
    assert read(_ctx(reports, cfg)) == pytest.approx(100.0 * (feat + res) / (1.75 * seconds))


def test_the_torso_roofline_bounds_more_work_than_the_fused_kernels_alone():
    """At an epoch's counts the span's bound holds ``epoch_torso_bound_s``
    (the fused blocks) and the two blocks the kernels leave out."""
    w = spec.load_json(spec.HERE / "workloads" / "impala_procgen.p1536.json")
    M, T, Z, H = w["population"] + 1, w["episode_length"], w["zeta_size"], w["archive_size"]
    report = {"_stage/torso.frames": T * M + M * Z + (H + 1) * Z,
              "_stage/torso.members": T * M + M + H + 1, "_stage/torso.device": 1.0}
    share = spec.reader("torso_span_roofline").read(_ctx([report]))
    assert share > 100.0 * impala.epoch_torso_bound_s(CONFIG, w)


def test_the_torso_roofline_has_no_value_without_the_span():
    read = spec.reader("torso_span_roofline").read
    assert read(_ctx([{"_stage/archive": 0.05}])) is None
    assert read(_ctx([{"_stage/torso.frames": 10, "_stage/torso.members": 1}])) is None
