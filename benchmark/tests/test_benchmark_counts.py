"""The benchmark's operation and byte counts against counts made by hand."""

import pytest

from benchmark import peaks, spec
from benchmark.arch import impala


def _config(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


# one frame's forward, conv by conv, then fc, LSTM and policy layer
HAND_FLOPS = {
    "impala_procgen": (2 * 9 * 3 * 16 * 64 * 64 + 4 * 2 * 9 * 16 * 16 * 32 * 32
                       + 2 * 9 * 16 * 32 * 32 * 32 + 4 * 2 * 9 * 32 * 32 * 16 * 16
                       + 2 * 9 * 32 * 32 * 16 * 16 + 4 * 2 * 9 * 32 * 32 * 8 * 8
                       + 2 * 2048 * 256 + 2 * 4 * 256 * 257 + 2 * 4 * 256 * 256 + 2 * 256 * 5),
}
HAND_FLOPS["impala_procgen_bf16"] = HAND_FLOPS["impala_procgen"]  # the same widths


@pytest.mark.parametrize("name", sorted(HAND_FLOPS))
def test_frame_flops_match_the_hand_count(name):
    assert impala.frame_flops(_config(name)) == HAND_FLOPS[name]


def test_hand_counts_are_the_published_sizes():
    assert HAND_FLOPS["impala_procgen"] == 62_263_808


@pytest.mark.parametrize("name", sorted(HAND_FLOPS))
def test_parameter_count_is_the_configs(name):
    cfg = _config(name)
    assert impala.reference_policy(cfg, "f32").d == cfg["params"]


def test_routing_follows_the_programs_gates():
    fused = [(c.kind, c.ci, c.H, c.fused) for c in impala.convs(_config("impala_procgen_bf16"))]
    assert fused == [("feat", 3, 64, False), ("res", 16, 32, True), ("feat", 16, 32, True),
                     ("res", 32, 16, True), ("feat", 32, 16, True), ("res", 32, 8, False)]


def test_torso_bound_of_one_frame_by_hand():
    # bf16, one member and frame: (operations, bytes) of the four fused kernels
    kernels = [(18_874_368, 4 * 2 * 16 * 1024 + 16 * (16 * 144 + 48)),
               (9_437_184, 4 * (16 * 1024 + 32 * 256) + 4 * (32 * 144 + 64)),
               (18_874_368, 4 * 2 * 32 * 256 + 16 * (32 * 288 + 96)),
               (4_718_592, 4 * (32 * 256 + 32 * 64) + 4 * (32 * 288 + 96))]
    hand = sum(max(f / 989e12, b / 3.35e12) for f, b in kernels)
    got = impala.torso_call_bound_s(_config("impala_procgen_bf16"), 1, 1)
    assert got == pytest.approx(hand, rel=1e-12)


def test_torso_bound_scales_with_members_and_frames():
    cfg = _config("impala_procgen")
    one = impala.torso_call_bound_s(cfg, 1, 1)
    assert impala.torso_call_bound_s(cfg, 1, 8) > one
    # the weights are read once a member, however many frames it has
    assert impala.torso_call_bound_s(cfg, 1, 8) < 8 * one
    assert impala.torso_call_bound_s(cfg, 8, 1) == pytest.approx(8 * one, rel=1e-12)


def test_epoch_torso_bound_counts_rollout_novelty_and_archive():
    cfg = _config("impala_procgen")
    w = spec.load_json(spec.HERE / "workloads" / "impala_procgen.p1536.json")
    M, Z = w["population"] + 1, w["zeta_size"]
    hand = (w["episode_length"] * impala.torso_call_bound_s(cfg, M, 1)
            + impala.torso_call_bound_s(cfg, M, Z)
            + (w["archive_size"] + 1) * impala.torso_call_bound_s(cfg, 1, Z))
    assert impala.epoch_torso_bound_s(cfg, w) == pytest.approx(hand, rel=1e-12)


def test_window_flops_by_hand():
    cfg = _config("impala_procgen_bf16")
    w = spec.load_json(spec.HERE / "workloads" / "impala_procgen_bf16.p1536.json")
    f, d = 62_263_808, 1_156_139
    hand = 1000 * f + 3 * ((1536 + 1 + 4 + 1) * 8 * f + 4 * d * 1536)
    assert impala.window_flops(cfg, w, 1000, 3) == pytest.approx(hand, rel=1e-12)


def test_peaks():
    assert peaks.flops("bfloat16") == 989e12
    assert peaks.flops("float32") == 495e12
    assert peaks.bound_s(989e12, 0, "bfloat16") == 1.0
    assert peaks.bound_s(0, 3.35e12, "float32") == 1.0
