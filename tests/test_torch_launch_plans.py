"""The launch plans of the res_chain and combine kernels, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); their
plans are Python mirrors that the C entry points recompute and refuse to
differ from (``ops/res_chain.py::res_chain_plan``,
``ops/perturb.py::combine_plan``).  Checked here: every probe and trained
shape is planned; the blocks cover every image row, output channel, lane
and member exactly once; shared memory fits a block; the card tests' shapes
reach every kind of plan; and the combine's staging of antithetic pairs
gives ``combine_plain``'s result.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per xdist worker)
from dfd_tpu_torch.ops import perturb as pk
from dfd_tpu_torch.ops import res_chain as rc
from dfd_tpu_torch.probes import pool, wide

LAYOUTS = ("channel_major", "channel_minor")
# (P, C, H, W, layout, bf16): the wide probe's 12 chains and the pool probe's 3
PROBE_CHAINS = ([(64, C, H, W, layout, cd is not None) for C, H, W in wide.STAGES
                 for layout in LAYOUTS for _, cd in wide.DTYPES]
                + [(64, 16, 32, 32, layout, cd is not None) for _, layout, cd in pool.CHAINS])
RAGGED = [(2, 8, 8, 8), (3, 12, 5, 7), (2, 20, 17, 19), (1, 130, 2, 2), (1, 33, 3, 5),
          (3, 6, 1, 40), (132, 16, 32, 32), (5, 100, 9, 11)]


def _check_res_plan(P, C, H, W, layout, bf16):
    p = rc.res_chain_plan(P, C, H, W, layout, bf16)
    assert p.rs * p.cs in (1, 2, 4, 8) and p.warps_m in (1, 2, 4, 8)
    # the bands cover the rows and the groups the channels, each exactly once, none empty
    rows = np.zeros(H, np.int32)
    for r in range(p.rs):
        assert r * p.band < H
        rows[r * p.band:(r + 1) * p.band] += 1
    chans = np.zeros(C, np.int32)
    for g in range(p.cs):
        assert g * p.cw < C
        chans[g * p.cw:(g + 1) * p.cw] += 1
    assert (rows == 1).all() and (chans == 1).all()
    # the warps' tiles cover a block's channels and positions; at most 64 sums a thread
    assert 16 * p.mt * p.warps_m >= p.cw and p.mt * p.nt <= rc.MAX_TILES
    assert 8 * p.nt * (8 // p.warps_m) >= p.band * W
    assert p.wt in (9, 3, 1)
    arows = 16 * p.mt * p.warps_m
    assert p.smem == rc.plan_smem(C, W, p.band, arows, p.wt, layout == "channel_minor", bf16)
    assert p.smem <= rc.SMEM_MAX == 232_448
    return p


@pytest.mark.parametrize("P, C, H, W, layout, bf16", PROBE_CHAINS)
def test_every_probe_chain_has_a_plan(P, C, H, W, layout, bf16):
    p = _check_res_plan(P, C, H, W, layout, bf16)
    # P = 64 fills the card: a full wave of 128 blocks or more
    assert P * p.rs * p.cs >= 128


@pytest.mark.parametrize("P, C, H, W", RAGGED)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ragged_chains_have_plans(P, C, H, W, bf16):
    for layout in LAYOUTS:
        _check_res_plan(P, C, H, W, layout, bf16)


def test_card_test_shapes_take_every_plan():
    """The card tests' shapes reach clusters of 1, 2, 4 and 8 blocks, row,
    channel and mixed splits, one-, two- and four-tile warps, warp grids of
    more than one row and tap groups of 9, 3 and 1."""
    from test_torch_cuda import RES_CHAIN_SHAPES

    plans = [rc.res_chain_plan(P, C, H, W, layout, bf16) for P, C, H, W in RES_CHAIN_SHAPES
             for layout in LAYOUTS for bf16 in (False, True)]
    assert {p.rs * p.cs for p in plans} == {1, 2, 4, 8}
    assert any(p.rs > 1 and p.cs == 1 for p in plans)
    assert any(p.rs == 1 and p.cs > 1 for p in plans)
    assert any(p.rs > 1 and p.cs > 1 for p in plans)
    assert {p.mt for p in plans} == {1, 2, 4} and {p.wt for p in plans} == {1, 3, 9}
    assert any(p.warps_m > 1 for p in plans)


def test_probe_plans_split_as_designed():
    """The wide probe's 128-channel chains split channels (the bf16 tile of
    every channel fits), its 64-channel f32 chains rows and channels."""
    assert rc.res_chain_plan(64, 128, 16, 16, bf16=True)[:2] == (1, 2)
    p = rc.res_chain_plan(64, 64, 32, 32)
    assert p.rs > 1 and p.cs > 1


def test_a_chain_no_plan_fits_raises():
    with pytest.raises(ValueError, match="no res_chain plan"):
        rc.res_chain_plan(1, 1024, 8, 8)
    with pytest.raises(ValueError, match="no res_chain plan"):
        rc.res_chain_plan(64, 600, 16, 16, "channel_minor", True)
    with pytest.raises(ValueError, match="positive"):
        rc.res_chain_plan(0, 8, 8, 8)


# -- combine -------------------------------------------------------------------------


TRAINED = [(2048, 5197, False), (2048, 5197, True), (128, 1_156_139, False),
           (64, 7_872_651, False)]
SMALL = [(1, 1, False), (1, 777, True), (7, 1027, True), (13, 777, False), (9, 100, True),
         (37, 3000, False), (1001, 5197, False), (2049, 5197, True), (130, 3000, True)]


def _combine_cover(P, d, anti):
    """How often the kernel's blocks and threads take each (draw, lane), by
    the kernel's own index arithmetic (``csrc/perturb.cu::combine_kernel``)."""
    lt, mg, cl = pk.combine_plan(P, d, anti)
    draws = (P + 1) // 2 if anti else P
    lanes, tiles = 4 * lt, -(-d // (4 * lt))
    taken = np.zeros(draws, np.int64)
    per = -(-draws // cl)
    for rank in range(cl):
        lo, hi = rank * per, min(draws, rank * per + per)
        for t0 in range(lo, hi, pk.COMBINE_THREADS):
            n = min(pk.COMBINE_THREADS, hi - t0)
            for grp in range(mg):
                taken[t0 + np.arange(grp, n, mg)] += 1
    lane_cover = np.zeros(tiles * lanes, np.int64)
    for tile in range(tiles):
        for li in range(lt):
            lane_cover[tile * lanes + 4 * li + np.arange(4)] += 1
    return taken, lane_cover, tiles * cl


@pytest.mark.parametrize("P, d, anti", TRAINED + SMALL)
def test_combine_slices_cover_each_draw_once(P, d, anti):
    taken, lane_cover, blocks = _combine_cover(P, d, anti)
    assert (taken == 1).all()
    assert (lane_cover == 1).all() and lane_cover.shape[0] - 4 * 256 < d <= lane_cover.shape[0]
    lt, mg, cl = pk.combine_plan(P, d, anti)
    assert lt * mg == pk.COMBINE_THREADS and cl in (1, 2, 4, 8)
    assert (4 * lt) & (4 * lt - 1) == 0 and pk.CHUNK % (4 * lt) == 0  # a tile in one chunk
    # groups keep at least 4 draws wherever the members were split
    draws = (P + 1) // 2 if anti else P
    assert mg * cl == 1 or draws >= mg * cl * pk.MIN_PER_GROUP


def test_combine_plans_fill_the_card_where_they_can():
    assert pk.combine_plan(2048, 5197) == (16, 16, 8)  # mlp_trap: 82 tiles x 8 blocks, one wave
    # impala_procmaze: 1129 tiles of 1024 lanes would be 1.07 waves; 9033 of 128 are 8.55
    assert pk.combine_plan(128, 1_156_139) == (32, 8, 1)
    assert pk.combine_plan(64, 7_872_651) == (128, 2, 1)
    plans = {pk.combine_plan(P, d, anti) for P, d, anti in SMALL}
    assert (256, 1, 1) in plans and any(mg > 1 and cl == 1 for _, mg, cl in plans)
    assert any(cl == 8 for _, _, cl in plans)


def _draw_coefs(coefs):
    """Each draw's coefficient as ``combine_kernel`` stages it under
    antithetic: draw m takes ``c[2m] - c[2m + 1]``, a lone last member its own."""
    pairs = coefs[: coefs.shape[0] // 2 * 2].reshape(-1, 2)
    return torch.cat([pairs[:, 0] - pairs[:, 1], coefs[pairs.shape[0] * 2:]])


@pytest.mark.parametrize("P, d", [(6, 3000), (7, 1027), (1, 100), (2048, 5197)])
def test_antithetic_staging_gives_combine_plain(P, d):
    coefs = torch.from_numpy(np.random.RandomState(P).randn(P).astype(np.float32))
    staged = _draw_coefs(coefs)
    assert staged.shape == ((P + 1) // 2,)
    got = staged @ pk.noise_plain(9, 4, staged.shape[0], d)
    want = pk.combine_plain(coefs, 9, 4, d, antithetic=True)
    assert ((got - want).norm() / want.norm()).item() <= 1e-5


# -- the wrappers refuse on the CPU what the card refuses ---------------------------------

from dfd_tpu_torch.ops import fused_resblock as fr  # noqa: E402
from dfd_tpu_torch.ops import gemm_chain as gc  # noqa: E402


def _r(*shape):
    return torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32))


def _stage(C=4, H=4, W=4):
    return _r(1, 1, C, H, W), _r(1, 4, C, 9 * C), _r(1, 4, C), _r(1, 4, C), _r(1, 4, C)


def _feat(ci=4, co=8, H=4, W=4):
    return _r(1, 1, ci, H, W), _r(1, co, 9 * ci), _r(1, co), _r(1, ci), _r(1, ci)


def _chain(C=4, H=4, W=4):
    return _r(1, C, H * W), _r(1, 1, C, 9 * C), _r(1, 1, C)


# wrapper: (call, plain version, valid operands, [(operands a card refuses, error), ...]);
# float64 and strided operands, a compute_dtype, operands of the wrong shape (the fused
# torso's plain versions cannot take them either) and shapes no launch plan fits
REFUSALS = {
    "perturb": (lambda f: pk.perturb(f, 0.1, 3, 1, 2), lambda f: pk.perturb_plain(f, 0.1, 3, 1, 2),
                (_r(40),), [((_r(40).double(),), "contiguous 1-D float32"),
                            ((_r(80)[::2],), "contiguous 1-D float32")]),
    "combine": (lambda c: pk.combine(c, 3, 1, 40), lambda c: pk.combine_plain(c, 3, 1, 40),
                (_r(4),), [((_r(4).double(),), "contiguous 1-D float32"),
                           ((_r(8)[::2],), "contiguous 1-D float32")]),
    "fused_res_stage": (
        fr.fused_res_stage, fr.fused_res_stage_plain, _stage(),
        [(tuple(v.double() for v in _stage()), "contiguous float32"),
         ((_r(1, 1, 4, 4, 8)[..., ::2],) + _stage()[1:], "contiguous float32"),
         ((_stage()[0], _r(1, 4, 4, 35)) + _stage()[2:], "w must be \\[M, 4, C, 9C\\]")]),
    "fused_feat_pool": (
        fr.fused_feat_pool, fr.fused_feat_pool_plain, _feat(),
        [(tuple(v.double() for v in _feat()), "contiguous float32"),
         ((_r(1, 1, 4, 4, 8)[..., ::2],) + _feat()[1:], "contiguous float32"),
         (_feat()[:2] + (_r(1, 8, 1),) + _feat()[3:], "b must be 1-D per member")]),
    "res_chain": (
        lambda x, w, b: rc.res_chain(x, w, b, 4, 4),
        lambda x, w, b: rc.res_chain_plain(x, w, b, 4, 4),
        _chain(), [(tuple(v.double() for v in _chain()), "contiguous float32"),
                   ((_r(1, 4, 32)[..., ::2],) + _chain()[1:], "contiguous float32")]),
    "gemm_chain": (
        lambda a, b: gc.gemm_chain(a, b, 2), lambda a, b: gc.gemm_chain_plain(a, b, 2),
        (_r(4, 8), _r(8, 4)), [((_r(4, 8).double(), _r(8, 4).double()),
                                "a must be a contiguous float32"),
                               ((_r(8, 4).t(), _r(8, 4)), "a must be a contiguous float32"),
                               ((_r(1, 65536), _r(65536, 1)), "do not fit")]),
}


@pytest.mark.parametrize("name", REFUSALS)
def test_cpu_wrappers_refuse_what_the_card_refuses(name):
    """Each wrapper checks what its kernel needs (dtype, contiguity,
    compute_dtype, the launch plan) before it branches on the device, with
    the card's ValueError text; the plain versions take anything."""
    fn, plain, ok, bad = REFUSALS[name]
    assert torch.equal(fn(*ok), plain(*ok))
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            fn(*args)
        if "fit" not in what and not what.startswith(("w must", "b must")) and name != "combine":
            assert plain(*args).dtype == args[0].dtype  # combine_plain's eps is float32
    if name.startswith("fused"):
        with pytest.raises(ValueError, match="compute_dtype must be None or torch.bfloat16"):
            fn(*ok, compute_dtype=torch.float16)


def test_res_chain_refuses_a_chain_no_plan_fits():
    """C = 512 at 64x64: no cluster of blocks holds the chain's tiles."""
    x, w, b = _r(1, 512, 64 * 64), _r(1, 1, 512, 9 * 512), _r(1, 1, 512)
    with pytest.raises(ValueError, match="no res_chain plan fits C=512 at 64x64"):
        rc.res_chain(x, w, b, 64, 64)
