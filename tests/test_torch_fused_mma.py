"""The launch plans of the tensor-core torso kernels, bf16
(``csrc/fused_resblock_mma.cu``) and f32 as 3xTF32
(``csrc/fused_resblock_tf32.cu``), and the wrappers' routing, on the CPU.

The tensor-core kernels themselves run only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``).  What their launch needs is
chosen in Python: the res stage's cluster of row bands (and, in f32, the
group of weight taps a buffer holds) and the feature pool's bands of pooled
rows.  These tests hold those plans to the shapes the kernels are launched
at: every image row and pooled row has exactly one owner, the shared memory
fits an H100 block, and what cannot fit raises.  On CPU tensors both
wrappers run their plain versions in either type and count no launch.
"""

import pytest
import torch

from dfd_tpu_torch.ops import fused_resblock as fr

# (C, H, W): impala_prod_bf16's res stages, the bf16 reference check's, ragged ones
RES_SHAPES = [(64, 32, 32), (128, 16, 16), (8, 16, 16), (16, 8, 8), (5, 8, 12), (5, 9, 13),
              (5, 7, 33), (24, 11, 6), (5, 1, 3), (144, 9, 9)]
# (ci, co, H, W): impala_prod_bf16's feature blocks, the reference check's, ragged ones
FEAT_SHAPES = [(64, 128, 32, 32), (128, 128, 16, 16), (3, 8, 32, 32), (8, 16, 16, 16),
               (5, 7, 9, 13), (5, 7, 16, 8), (5, 7, 21, 19), (24, 72, 21, 19), (80, 130, 12, 10),
               (5, 5, 1, 1)]


@pytest.mark.parametrize("C, H, W", RES_SHAPES)
def test_res_stage_plan_bands_cover_the_rows(C, H, W):
    cluster, band, smem = fr.res_stage_mma_plan(C, H, W)
    assert cluster in (2, 4, 8) and smem <= fr.SMEM_MAX
    owners = [r for r in range(cluster) for _ in range(max(0, min(band, H - r * band)))]
    assert owners == sorted(owners) and len(owners) == H  # each row once, in band order
    kp = -(-C // 16) * 16
    assert smem == 4 * (band + 2) * (W + 2) * (kp + 8) + 2 * kp * (kp + 8) + 4 * kp * C


@pytest.mark.parametrize("ci, co, H, W", FEAT_SHAPES)
def test_feat_pool_plan_bands_cover_the_pooled_rows(ci, co, H, W):
    pb, bands, smem = fr.feat_pool_mma_plan(ci, co, H, W)
    Ho = (H + 1) // 2
    assert smem <= fr.SMEM_MAX
    assert (bands - 1) * pb < Ho <= bands * pb  # no band is empty, none is missing
    assert (2 * pb + 1) * W <= 256 or pb == 1  # one chunk of dense positions a block


def test_production_plans_fill_the_card():
    """At impala_prod_bf16's rollout (M = 65 members, one frame each) the res
    stage runs 130 blocks on the H100's 132 SMs, and the feature pool's
    shared memory lets two blocks share an SM."""
    assert fr.res_stage_mma_plan(64, 32, 32)[:2] == (2, 16)
    assert fr.res_stage_mma_plan(128, 16, 16)[:2] == (2, 8)
    for ci, co, H, W in ((64, 128, 32, 32), (128, 128, 16, 16)):
        assert 2 * fr.feat_pool_mma_plan(ci, co, H, W)[2] <= 228 * 1024 - 2 * 1024


def _tiles_cover(plan, H, W, feat):
    """The tiled plan's tiles cover the (pooled) frame, none of them empty,
    and its shared memory fits a block."""
    assert isinstance(plan, fr.TiledPlan) and plan.smem <= fr.SMEM_MAX
    Ho, Wo = ((H + 1) // 2, (W + 1) // 2) if feat else (H, W)
    ntr, ntc = -(-Ho // plan.rows), -(-Wo // plan.cols)
    assert ntr * ntc == plan.tiles
    assert (ntr - 1) * plan.rows < Ho and (ntc - 1) * plan.cols < Wo


def test_mma_plans_refuse_what_does_not_fit():
    """What no cluster of bf16 blocks holds (a band of 2000 columns, 256
    channels beside a tap, a feature pool of 512 input channels at W = 512)
    is refused by the cluster form and goes to the tiled form: tiles that
    cover the frame in a block's shared memory."""
    for C, H, W in ((16, 8, 2000), (256, 16, 16)):
        plan = fr.res_stage_mma_plan(C, H, W)
        _tiles_cover(plan, H, W, feat=False)
        assert plan.group == min(64, -(-C // 16) * 16) and plan.kc == 16
    plan = fr.feat_pool_mma_plan(512, 64, 16, 512)
    _tiles_cover(plan, 16, 512, feat=True)
    assert (2 * plan.rows + 1) * (2 * plan.cols + 1) <= 256  # the warps' positions


# (C, H, W) of the f32 res stage: impala_procmaze's, the reference check's,
# ragged ones, frames that take clusters or smaller tap groups, production widths
TF32_RES_SHAPES = [(16, 32, 32), (32, 16, 16), (8, 16, 16), (16, 8, 8), (5, 8, 12), (5, 9, 13),
                   (17, 7, 33), (16, 40, 40), (32, 24, 24), (64, 32, 32), (128, 16, 16),
                   (5, 1, 3), (120, 9, 9)]
# (ci, co, H, W) of the f32 feature pool
TF32_FEAT_SHAPES = [(16, 32, 32, 32), (32, 32, 16, 16), (3, 8, 32, 32), (8, 16, 16, 16),
                    (5, 7, 9, 13), (5, 7, 16, 8), (5, 7, 21, 19), (3, 20, 40, 24), (5, 7, 6, 600),
                    (64, 128, 32, 32), (128, 128, 16, 16), (24, 72, 21, 19), (5, 5, 1, 1)]


def _tf32_rows(co):
    mt = 1 if co <= 16 else 2
    return -(-co // (16 * mt)) * 16 * mt


@pytest.mark.parametrize("C, H, W", TF32_RES_SHAPES)
def test_res_stage_tf32_plan_bands_cover_the_rows(C, H, W):
    cluster, band, wt, smem = fr.res_stage_tf32_plan(C, H, W)
    assert cluster in (1, 2, 4, 8) and wt in (9, 3, 1) and smem <= fr.SMEM_MAX
    owners = [r for r in range(cluster) for _ in range(max(0, min(band, H - r * band)))]
    assert owners == sorted(owners) and len(owners) == H  # each row once, in band order
    kp = -(-C // 8) * 8
    # two halo-padded f32 buffers, row stride kp + 4, and two weight buffers
    assert smem == 4 * (2 * (band + 2) * (W + 2) * (kp + 4) + 2 * _tf32_rows(C) * (wt * kp + 4))
    if cluster > 1:  # no smaller cluster fits, even with single taps
        fewer = -(-H // (cluster // 2))
        assert 4 * (2 * (fewer + 2) * (W + 2) * (kp + 4) + 2 * _tf32_rows(C) * (kp + 4)) \
            > fr.SMEM_MAX


@pytest.mark.parametrize("ci, co, H, W", TF32_FEAT_SHAPES)
def test_feat_pool_tf32_plan_bands_cover_the_pooled_rows(ci, co, H, W):
    pb, bands, wt, smem = fr.feat_pool_tf32_plan(ci, co, H, W)
    Ho = (H + 1) // 2
    assert wt in (9, 3, 1) and smem <= fr.SMEM_MAX
    assert (bands - 1) * pb < Ho <= bands * pb  # no band is empty, none is missing
    rows = _tf32_rows(co)
    cap = 8 // (rows // (16 if co <= 16 else 32)) * 8 * (16 if co <= 16 else 8)
    assert (2 * pb + 1) * W <= cap or pb == 1  # one chunk of dense positions a block


def test_flagship_f32_plans_fill_the_card():
    """At impala_procmaze's rollout (M = 129 members, one frame each) a res
    stage's frame fits one block, whole convs of weights beside it (129
    blocks, one wave on the H100's 132 SMs); the feature pool runs 3 bands
    a frame at 32x32, two blocks an SM, and one at 16x16."""
    assert fr.res_stage_tf32_plan(16, 32, 32)[:3] == (1, 32, 9)
    assert fr.res_stage_tf32_plan(32, 16, 16)[:3] == (1, 16, 9)
    pb, bands, wt, smem = fr.feat_pool_tf32_plan(16, 32, 32, 32)
    assert (pb, bands, wt) == (6, 3, 9) and 2 * smem <= 228 * 1024 - 2 * 1024
    assert fr.feat_pool_tf32_plan(32, 32, 16, 16)[:3] == (8, 1, 9)


def test_tf32_plans_refuse_what_does_not_fit():
    """What no cluster of f32 blocks holds (a band of 4000 columns, more than
    256 channels, a feature pool of 512 input channels at W = 512) goes to
    the tiled form: tiles that cover the frame, whose dense positions one
    chunk of the warps takes, in a block's shared memory."""
    for C, H, W in ((16, 8, 4000), (257, 16, 16)):
        plan = fr.res_stage_tf32_plan(C, H, W)
        _tiles_cover(plan, H, W, feat=False)
        assert plan.rows * plan.cols <= fr._tf32_tiles(min(C, 64))[1] and plan.kc == 8
    for ci, co, H, W in ((512, 64, 16, 512), (16, 300, 16, 16)):
        plan = fr.feat_pool_tf32_plan(ci, co, H, W)
        _tiles_cover(plan, H, W, feat=True)
        assert (2 * plan.rows + 1) * (2 * plan.cols + 1) <= fr._tf32_tiles(min(co, 64))[1]


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(compute_dtype):
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=g)
    counts = lambda: (fr.fused_res_stage.launches, fr.fused_res_stage.mma_launches,
                      fr.fused_feat_pool.launches, fr.fused_feat_pool.mma_launches)
    before = counts()
    res = (r(2, 1, 5, 9, 13), r(2, 4, 5, 45) / 7, r(2, 4, 5), 1 + r(2, 4, 5).abs(), r(2, 4, 5))
    got = fr.fused_res_stage(*res, compute_dtype=compute_dtype)
    torch.testing.assert_close(got, fr.fused_res_stage_plain(*res, compute_dtype),
                               rtol=0, atol=0)
    feat = (r(2, 1, 5, 9, 13), r(2, 7, 45) / 7, r(2, 7), 1 + r(2, 5).abs(), r(2, 5))
    got = fr.fused_feat_pool(*feat, compute_dtype=compute_dtype)
    torch.testing.assert_close(got, fr.fused_feat_pool_plain(*feat, compute_dtype),
                               rtol=0, atol=0)
    assert counts() == before
