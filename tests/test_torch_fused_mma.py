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

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dfd_tpu_torch.ops import build
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
    cover the frame in a block's shared memory, whose halo-padded (dense)
    rows the block's four warpgroups take at once (4 x 152 positions for
    one group of 64 output channels, 2 x 152 for two), K in chunks of 16
    input channels."""
    for C, H, W in ((16, 8, 2000), (256, 16, 16)):
        plan = fr.res_stage_mma_plan(C, H, W)
        _tiles_cover(plan, H, W, feat=False)
        groups = 2 if C > 64 else 1
        assert plan.group == 64 * groups and plan.kc == 16 and plan.stages in (2, 3)
        assert plan.rows * (plan.cols + 2) - 2 <= 4 // groups * fr.MMA_N
    plan = fr.feat_pool_mma_plan(512, 64, 16, 512)
    _tiles_cover(plan, 16, 512, feat=True)
    assert plan.group == 64 and plan.kc == 16
    assert (2 * plan.rows + 1) * (2 * plan.cols + 3) - 2 <= 4 * fr.MMA_N  # the warpgroups'


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
    the tiled form: tiles that cover the frame, whose (dense) positions the
    block's warps take at once (128 in the res stage, 320 in the pool), 64
    or 32 output channels a block, K in chunks of 16 input channels, in a
    block's shared memory."""
    for C, H, W in ((16, 8, 4000), (257, 16, 16)):
        plan = fr.res_stage_tf32_plan(C, H, W)
        _tiles_cover(plan, H, W, feat=False)
        assert plan.rows * plan.cols <= fr.TF32_RES_SLOTS and plan.kc == 16
        assert plan.group == fr.TF32_RES_GROUP
    for ci, co, H, W in ((512, 64, 16, 512), (16, 300, 16, 16)):
        plan = fr.feat_pool_tf32_plan(ci, co, H, W)
        _tiles_cover(plan, H, W, feat=True)
        assert (2 * plan.rows + 1) * (2 * plan.cols + 1) <= fr.TF32_POOL_SLOTS and plan.kc == 16
        assert plan.group == fr.TF32_POOL_GROUP


# impala_128px's three tiled calls at its chunk of M = 16 members, one frame each
FLAGSHIP_128 = [("res", 64, 64, 64, 64), ("feat", 64, 128, 64, 64), ("res", 128, 128, 32, 32)]
SMS, WARPS_A_BLOCK = 132, 16


@pytest.mark.parametrize("kind, ci, co, H, W", FLAGSHIP_128,
                         ids=["res-64@64x64", "feat-64to128@64x64", "res-128@32x32"])
def test_tiled_tf32_plans_fill_the_card_at_128_pixels(kind, ci, co, H, W):
    """At impala_128px's shapes (M = 16) the f32 tiled forms launch at least
    132 x 16 warps of work (two 8-warp blocks' worth an SM; a block is 16
    warps, one an SM), in a block's shared memory; the feature pool's tile
    computes at most 4.6 dense conv outputs a pooled one (the 3 x 65-dense
    tiles before: 6.09)
    and leaves at most a tenth of the warps' position slots past it; the
    res stage's fills its 128 slots."""
    M = 16
    if kind == "res":
        plan = fr.res_stage_tf32_plan(ci, H, W)
        slots, used = fr.TF32_RES_SLOTS, plan.rows * plan.cols
    else:
        plan = fr.feat_pool_tf32_plan(ci, co, H, W)
        slots, used = fr.TF32_POOL_SLOTS, (2 * plan.rows + 1) * (2 * plan.cols + 1)
        assert used / (plan.rows * plan.cols) <= 4.6
    assert isinstance(plan, fr.TiledPlan) and plan.smem <= fr.TF32_TILED_SMEM_MAX
    assert used <= slots and (slots - used) <= 0.1 * slots
    blocks = M * plan.tiles * -(-co // plan.group)
    assert blocks * WARPS_A_BLOCK >= SMS * 16


# the 192-pixel bf16 path's three tiled calls: M = 16 members of the res stages (as the
# 128-pixel path's chunks), M = 2 of the feature pool, one frame each
BF16_192 = [("res", 16, 64, 64, 96, 96), ("res", 16, 128, 128, 48, 48),
            ("feat", 2, 64, 128, 192, 192)]


@pytest.mark.parametrize("kind, M, ci, co, H, W", BF16_192,
                         ids=["res-64@96x96", "res-128@48x48", "feat-64to128@192x192"])
def test_tiled_mma_plans_fill_the_card_at_192_pixels(kind, M, ci, co, H, W):
    """At 192-pixel frames' shapes the bf16 tiled forms read at most 1.4
    halo positions an output (the 2 x 96 tiles before: 2.04) and the pool
    computes at most 4.6 dense outputs a pooled one (the 1 x 32 tiles
    before: 6.1), in a block's shared memory, at least 96% of the block's
    halo-padded positions kept, with at least as many blocks as the card
    has SMs; a 128-channel block takes both groups of 64 (one operand tile
    for both)."""
    if kind == "res":
        plan = fr.res_stage_mma_plan(ci, H, W)
        th, tw = plan.rows, plan.cols
        assert (th + 2) * (tw + 2) / (th * tw) <= 1.4
    else:
        plan = fr.feat_pool_mma_plan(ci, co, H, W)
        th, tw = 2 * plan.rows + 1, 2 * plan.cols + 1
        assert th * tw / (plan.rows * plan.cols) <= 4.6
    assert isinstance(plan, fr.TiledPlan) and plan.smem <= fr.MMA_TILED_SMEM_MAX
    slots = (4 if co <= 64 else 2) * fr.MMA_N
    assert th * (tw + 2) - 2 <= slots and th * (tw + 2) - 2 >= 0.94 * slots
    assert plan.group == (64 if co <= 64 else 128)
    assert M * plan.tiles >= SMS * 0.96


@pytest.fixture(scope="module")
def mma_plan_header(tmp_path_factory):
    """``csrc/tiled_mma_plan.cuh`` compiled by g++ behind a C interface."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the plan's header for the host")
    d = tmp_path_factory.mktemp("tiled_mma_plan")
    (d / "plan.cc").write_text(
        '#include "tiled_mma_plan.cuh"\n'
        'namespace tm = tiled_mma;\n'
        'extern "C" void res_plan(int C, int H, int W, int* th, int* tw) {\n'
        '  tm::res_plan(C, H, W, th, tw); }\n'
        'extern "C" void feat_plan(int co, int H, int W, int* ph, int* pw) {\n'
        '  tm::feat_plan(co, H, W, ph, pw); }\n'
        'extern "C" long long smem_bytes(int pool, int planar, int co, int th, int tw,\n'
        '                                int stages) {\n'
        '  return tm::smem_bytes(pool != 0, planar != 0, co, th, tw, stages); }\n'
        'extern "C" int stages(int pool, int planar, int co, int th, int tw) {\n'
        '  return tm::stages(pool != 0, planar != 0, co, th, tw); }\n'
        'extern "C" long long conv_image_elems(int ci, int co) {\n'
        '  return tm::conv_image_elems(ci, co); }\n'
        'extern "C" long long image_offset(int ci, int co, int o, int tap, int c) {\n'
        '  return tm::image_offset(ci, co, o, tap, c); }\n')
    lib = d / "libplan.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(build.CSRC), "-o",
                    str(lib), str(d / "plan.cc")], check=True, capture_output=True)
    host = ctypes.CDLL(str(lib))
    i32, i64, ip = ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    host.res_plan.argtypes = host.feat_plan.argtypes = [i32, i32, i32, ip, ip]
    host.smem_bytes.argtypes = [i32] * 6
    host.stages.argtypes = [i32] * 5
    host.conv_image_elems.argtypes = [i32] * 2
    host.image_offset.argtypes = [i32] * 5
    host.smem_bytes.restype = host.conv_image_elems.restype = host.image_offset.restype = i64
    return host


# (H, W) for the bf16 host plan comparison: 192-pixel frames' three, the flagship's, ragged
# and extreme ones
MMA_HOST_PLAN_FRAMES = [(96, 96), (48, 48), (192, 192), (64, 64), (32, 32), (16, 16),
                        (200, 150), (8, 2000), (61, 1001), (1, 1), (1, 300), (300, 1), (2, 536),
                        (3, 7), (128, 128), (9, 13), (17, 33), (1000, 2), (2, 1000), (127, 129)]


@pytest.mark.parametrize("H, W", MMA_HOST_PLAN_FRAMES)
def test_tiled_mma_plan_in_python_is_the_c_plan(mma_plan_header, H, W):
    """The Python plans, ring slots and shared bytes are the C entries' own
    (``tiled_mma::res_plan``, ``feat_plan``, ``stages``, ``smem_bytes``; the
    res stage's f32 first conv and its planar convs 1-3), compiled here from
    the header the kernels include, at one group of 64 output channels and
    at two; the halo-padded rows fit the block's warpgroups and a landing
    row fits a tensor map's box."""
    th, tw = ctypes.c_int(), ctypes.c_int()
    for C in (16, 64, 128):
        slots = (4 if C <= 64 else 2) * fr.MMA_N
        plan = fr.res_stage_tiled_plan(C, H, W, "mma")
        mma_plan_header.res_plan(C, H, W, ctypes.byref(th), ctypes.byref(tw))
        assert (plan.rows, plan.cols) == (th.value, tw.value)
        assert plan.rows * (plan.cols + 2) - 2 <= slots and plan.cols <= fr.MMA_BOX_MAX
        assert plan.stages == mma_plan_header.stages(0, 0, C, th.value, tw.value)
        assert plan.smem == mma_plan_header.smem_bytes(0, 0, C, th.value, tw.value, plan.stages) \
            <= fr.MMA_TILED_SMEM_MAX
        planar = fr._mma_stages(False, C, th.value, tw.value, planar=True)  # convs 1-3
        assert planar == mma_plan_header.stages(0, 1, C, th.value, tw.value)
        assert fr._mma_smem(False, C, th.value, tw.value, planar, planar=True) \
            == mma_plan_header.smem_bytes(0, 1, C, th.value, tw.value, planar) \
            <= fr.MMA_TILED_SMEM_MAX
        plan = fr.feat_pool_tiled_plan(16, C, H, W, "mma")
        mma_plan_header.feat_plan(C, H, W, ctypes.byref(th), ctypes.byref(tw))
        assert (plan.rows, plan.cols) == (th.value, tw.value)
        dh, dw = 2 * th.value + 1, 2 * tw.value + 1
        assert dh * (dw + 2) - 2 <= slots
        assert plan.stages == mma_plan_header.stages(1, 0, C, dh, dw)
        assert plan.smem == mma_plan_header.smem_bytes(1, 0, C, dh, dw, plan.stages) \
            <= fr.MMA_TILED_SMEM_MAX


@pytest.mark.parametrize("ci, co", [(64, 64), (128, 128), (64, 128), (6, 20), (264, 264),
                                    (16, 300), (5, 7)])
def test_mma_weight_image_layout_is_the_c_layout(mma_plan_header, ci, co):
    """Every weight of the plain bf16 image (``mma_weight_image_plain``)
    sits where the C side's ``image_offset`` puts it, rounded to bf16, and
    the image's size is ``conv_image_elems``'s; the rest of it is zero."""
    w = torch.arange(1, co * 9 * ci + 1, dtype=torch.float32).reshape(co, 9 * ci) % 251 - 125
    img = fr.mma_weight_image_plain(w, ci).reshape(-1)
    assert img.dtype == torch.bfloat16
    assert img.numel() == fr.mma_weight_image_elems(ci, co) \
        == mma_plan_header.conv_image_elems(ci, co)
    o, tap, c = np.meshgrid(np.arange(co), np.arange(9), np.arange(ci), indexing="ij")
    off = torch.from_numpy(np.vectorize(mma_plan_header.image_offset)(ci, co, o, tap, c).reshape(-1))
    assert torch.equal(img[off].float(), w.reshape(-1))  # integers below 256 are exact in bf16
    mask = torch.ones_like(img, dtype=torch.bool)
    mask[off] = False
    assert not img[mask].float().any()


@pytest.fixture(scope="module")
def plan_header(tmp_path_factory):
    """``csrc/tiled_tf32_plan.cuh`` compiled by g++ behind a C interface."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the plan's header for the host")
    d = tmp_path_factory.mktemp("tiled_tf32_plan")
    (d / "plan.cc").write_text(
        '#include "tiled_tf32_plan.cuh"\n'
        'namespace tt = tiled_tf32;\n'
        'extern "C" void res_plan(int H, int W, int* th, int* tw) { tt::res_plan(H, W, th, tw); }\n'
        'extern "C" void feat_plan(int H, int W, int* ph, int* pw) { tt::feat_plan(H, W, ph, pw); }\n'
        'extern "C" long long smem_bytes(int pool, int th, int tw) {\n'
        '  return tt::smem_bytes(pool != 0, th, tw); }\n'
        'extern "C" long long conv_image_floats(int ci, int co, int group) {\n'
        '  return tt::conv_image_floats(ci, co, group); }\n'
        'extern "C" long long image_offset(int ci, int group, int o, int tap, int c) {\n'
        '  return tt::image_offset(ci, group, o, tap, c); }\n')
    lib = d / "libplan.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(build.CSRC), "-o",
                    str(lib), str(d / "plan.cc")], check=True, capture_output=True)
    host = ctypes.CDLL(str(lib))
    i32, i64, ip = ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    host.res_plan.argtypes = host.feat_plan.argtypes = [i32, i32, ip, ip]
    host.smem_bytes.argtypes = [i32] * 3
    host.conv_image_floats.argtypes = [i32] * 3
    host.image_offset.argtypes = [i32] * 5
    host.smem_bytes.restype = host.conv_image_floats.restype = host.image_offset.restype = i64
    return host


# (H, W) for the host plan comparison: the flagship's, ragged and extreme frames
HOST_PLAN_FRAMES = [(64, 64), (32, 32), (16, 16), (200, 150), (8, 4000), (61, 1001), (1, 1),
                    (1, 300), (300, 1), (2, 150), (3, 7), (128, 128), (192, 192), (9, 13),
                    (17, 33), (1000, 2), (2, 1000), (5, 128), (127, 129)]


@pytest.mark.parametrize("H, W", HOST_PLAN_FRAMES)
def test_tiled_tf32_plan_in_python_is_the_c_plan(plan_header, H, W):
    """The Python plans and shared bytes are the C entries' own
    (``tiled_tf32::res_plan``, ``feat_plan``, ``smem_bytes``), compiled
    here from the header the kernels include; the res stage's halo-padded
    rows fit its two warpgroups' 144 positions."""
    th, tw = ctypes.c_int(), ctypes.c_int()
    plan = fr.res_stage_tiled_plan(64, H, W, "tf32")
    plan_header.res_plan(H, W, ctypes.byref(th), ctypes.byref(tw))
    assert (plan.rows, plan.cols) == (th.value, tw.value)
    assert plan.rows * (plan.cols + 2) - 2 <= fr.TF32_RES_HALO
    assert plan.smem == plan_header.smem_bytes(0, th.value, tw.value) <= fr.TF32_TILED_SMEM_MAX
    plan = fr.feat_pool_tiled_plan(16, 64, H, W, "tf32")
    plan_header.feat_plan(H, W, ctypes.byref(th), ctypes.byref(tw))
    assert (plan.rows, plan.cols) == (th.value, tw.value)
    assert plan.smem == plan_header.smem_bytes(1, 2 * th.value + 1, 2 * tw.value + 1) \
        <= fr.TF32_TILED_SMEM_MAX


@pytest.mark.parametrize("ci, co, group", [(64, 64, 64), (128, 128, 64), (64, 128, 32),
                                           (6, 20, 32), (264, 264, 64), (16, 300, 32)])
def test_tf32_weight_image_layout_is_the_c_layout(plan_header, ci, co, group):
    """Every weight of the plain image (``tf32_weight_image_plain``) sits
    where the C side's ``image_offset`` puts it, hi then lo, and the image's
    size is ``conv_image_floats``'s; the rest of it is zero."""
    w = torch.arange(1, co * 9 * ci + 1, dtype=torch.float32).reshape(co, 9 * ci)
    img = fr.tf32_weight_image_plain(w, ci, group).reshape(-1)
    assert img.numel() == fr.tf32_weight_image_floats(ci, co, group) \
        == plan_header.conv_image_floats(ci, co, group)
    half = 9 * fr.TF32_TILED_KC * group
    o, tap, c = np.meshgrid(np.arange(co), np.arange(9), np.arange(ci), indexing="ij")
    off = np.vectorize(plan_header.image_offset)(ci, group, o, tap, c).reshape(-1)
    want = w.reshape(co, 9, ci).reshape(-1)
    hi = img[torch.from_numpy(off)]
    lo = img[torch.from_numpy(off + half)]
    assert torch.equal(hi + lo, want)  # an integer below 2^22 is two TF32 values exactly
    mask = torch.ones_like(img, dtype=torch.bool)
    mask[torch.from_numpy(off)] = False
    mask[torch.from_numpy(off + half)] = False
    assert not img[mask].any()


def test_weight_images_are_kept_per_route():
    """A weight tensor given to both tiled routes gets an image for each (the
    f32 route's split, the bf16 route's rounding), even at one size."""
    fr._IMAGES.clear()
    w = torch.randn(2, 4, 8, 72)
    for route in ("tf32", "mma"):
        image, fresh = fr._weight_image(w, 100, 0, route)
        assert fresh
        fr._keep_image(w, 0, image, route)
    assert not fr._weight_image(w, 100, 0, "tf32")[1]
    assert not fr._weight_image(w, 100, 0, "mma")[1]
    assert fr._weight_image(w, 100, 0, "tf32")[0] is not fr._weight_image(w, 100, 0, "mma")[0]
    fr._IMAGES.clear()


def test_tf32_weight_image_is_split_once_per_tensor():
    """The f32 tiled wrappers' image of a weight tensor is split again only
    when the tensor is another object, was changed in place, or comes on
    another stream; the newest few are kept."""
    fr._IMAGES.clear()

    def image_of(w, floats=100, stream=0):  # as the wrappers ask, then keep after a launch
        image, split = fr._weight_image(w, floats, stream)
        if split:
            fr._keep_image(w, stream, image)
        return image, split

    w = torch.randn(2, 4, 8, 72)
    assert fr._weight_image(w, 100, stream=0)[1]          # not kept until its launch is in
    image, split = image_of(w)
    assert split and image.numel() == 100
    again, split = image_of(w)
    assert not split and again is image
    assert image_of(w, stream=1)[1]                       # another stream
    w.add_(1.0)                                           # changed in place
    assert image_of(w)[1]
    assert image_of(w.clone())[1]                         # another tensor, same values
    for _ in range(fr._IMAGES_KEPT):
        image_of(torch.randn(3), floats=4)
    assert image_of(w)[1]                                 # evicted by newer images
    assert len(fr._IMAGES) == fr._IMAGES_KEPT
    fr._IMAGES.clear()


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
