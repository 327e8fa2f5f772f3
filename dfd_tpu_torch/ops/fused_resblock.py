"""Fused IMPALA torso kernels: one stage's residual pair, and its feature block.

Replaces the Pallas TPU kernels ``dfd_tpu/ops/fused_resblock.py``:

- :func:`fused_res_stage` (``fused_res_stage`` -> ``_stage_call`` ->
  ``_stage_kernel``): a stage's two residual blocks, four times
  ``h <- conv3x3(relu(h * s_j + t_j)) + b_j`` with the block input added
  after each second conv;
- :func:`fused_feat_pool` (``fused_feat_pool`` -> ``_featpool_call`` ->
  ``_featpool_kernel``): ``x * s + t`` -> 3x3 conv + b -> 3x3 max with -inf
  padding, kept at the even positions: BN -> conv -> maxpool(3, 2, 1).  The
  TPU kernel writes the dense max map and its caller slices ``[::2, ::2]``;
  the CUDA kernel writes only the pooled outputs.

Operands are population-batched, the JAX package's member ``vmap`` written
out: ``x [M, B, C, H, W]`` float32, conv weights in the tap order of
:func:`reorder_conv_weight`, and per-member BN folds (:func:`fold_bn_eval`).
Each wrapper runs a CUDA kernel on CUDA tensors and its plain PyTorch
version (``*_plain``) on CPU tensors; other devices, dtypes, shapes or
layouts raise.  On the card both routes run on the tensor cores, the route
following ``compute_dtype``:

- ``None``: float32-accurate products as three TF32 products of split
  operands (3xTF32: ``a * b ~ lo_a * hi_b + hi_a * lo_b + hi_a * hi_b``)
  summed in float32 (``csrc/fused_resblock_tf32.cu``,
  ``res_stage_tf32_kernel``, ``feat_pool_tf32_kernel``), counted in
  ``launches``;
- ``torch.bfloat16``: both conv operands rounded to bf16 and the products
  summed in float32, as the TPU kernel's bf16 dot with
  ``preferred_element_type=float32`` does (``csrc/fused_resblock_mma.cu``,
  ``res_stage_mma_kernel``, ``feat_pool_mma_kernel``), counted in
  ``mma_launches``.

A failed build or launch raises; nothing falls back to another route.

Both keep the taps out of memory altogether.  Each route has two forms,
chosen by its launch plan (:func:`res_stage_tf32_plan`,
:func:`feat_pool_tf32_plan`, :func:`res_stage_mma_plan`,
:func:`feat_pool_mma_plan`) from the shapes alone:

- the cluster form, where a cluster of at most 8 blocks holds a frame's band
  of rows with every channel in shared memory (and, in f32, at most 256
  output channels): the whole stage or feature block in one launch;
- the tiled form everywhere else (a :class:`TiledPlan`): each conv an
  implicit GEMM over tiles of outputs x a group of output channels (64; the
  f32 feature pool 32; bf16 convs past 64 channels both groups of 64 in one
  block) with the input channels streamed through shared memory, so any C,
  H and W runs.  The res stage is then four launches, its convs' outputs in
  device memory (one scratch buffer beside ``out``); the feature pool one.
  The weights go to the kernels as an image of their layout, made once for
  each weight tensor the wrapper is given: in f32 split into TF32 hi and lo
  (:func:`tf32_weight_image_plain` is its plain version), in bf16 rounded
  (:func:`mma_weight_image_plain`).  The image is kept while the same
  tensor object, unmodified, comes back on the same stream (a rollout's
  steps reuse their prepared weights).  Counted in ``tiled_launches`` (f32)
  and ``tiled_mma_launches`` (bf16), one a call.

:func:`fused_supported` (the TPU's lane rule ``H * W % 128 == 0``) is kept
only as the IMPALA model's gate, so the port runs the same layers through
the kernels as the JAX package, at every shape it admits.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dfd_tpu_torch.ops import build


def fused_supported(H: int, W: int) -> bool:
    """The JAX model's gate for the fused kernels (a TPU lane-tile rule)."""
    return (H * W) % 128 == 0


def reorder_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """[..., co, ci, kh, kw] OIHW conv weights -> [..., co, 9ci], rows
    ordered (kw, kh, ci): the kernels' tap order."""
    lead = w.shape[:-4]
    co = w.shape[-4]
    return w.permute(*range(len(lead)), -4, -1, -2, -3).reshape(*lead, co, -1)


def fold_bn_eval(bn_params, bn_state, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN-eval (x - mean) / sqrt(var + eps) * gamma + beta -> (scale, shift);
    per-member gamma, beta [M, C] and shared statistics [C] give [M, C]."""
    scale = bn_params["w"] / torch.sqrt(bn_state["var"] + eps)
    shift = bn_params["b"] - bn_state["mean"] * scale
    return scale, shift


def stage_weights(params, state, stage: int, eps: float):
    """One stage's residual-pair tensors stacked in the kernel's layout:
    w [M, 4, C, 9C], b, s, t [M, 4, C] (conv j = 2 * block + conv)."""
    ws, bs, ss, ts = [], [], [], []
    for r in (1, 2):
        for c in (1, 2):
            conv = params[f"res{r}_{stage}_conv{c}"]
            bn = f"res{r}_{stage}_bn{c}"
            ws.append(reorder_conv_weight(conv["w"]))
            bs.append(conv["b"])
            sc, sh = fold_bn_eval(params[bn], state[bn], eps)
            ss.append(sc)
            ts.append(sh)
    stack = lambda xs: torch.stack(xs, dim=-2)
    return torch.stack(ws, dim=-3).contiguous(), stack(bs), stack(ss), stack(ts)


def feat_weights(params, state, stage: int, eps: float):
    """One stage's feature-block tensors: w [M, co, 9ci], b [M, co], s, t [M, ci]."""
    conv = params[f"feat{stage}_conv"]
    sc, sh = fold_bn_eval(params[f"feat{stage}_bn"], state[f"feat{stage}_bn"], eps)
    return reorder_conv_weight(conv["w"]).contiguous(), conv["b"].contiguous(), sc, sh


# -- plain PyTorch versions ------------------------------------------------------------


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype is None else x.to(compute_dtype).to(torch.float32)


def _conv3x3(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """3x3 "same" conv of h [M, B, ci, H, W] with w [M, co, 9ci] in tap
    order and b [M, co]: zero-padded shifted slices stacked as taps
    (kw, kh, ci), one batched product per member, then the bias."""
    M, B, ci, H, W = h.shape
    hp = F.pad(h, (1, 1, 1, 1))
    taps = torch.stack([hp[..., kh:kh + H, kw:kw + W] for kw in range(3) for kh in range(3)], 2)
    taps = taps.reshape(M, B, 9 * ci, H * W).transpose(1, 2).reshape(M, 9 * ci, B * H * W)
    y = torch.bmm(_round(w, compute_dtype), _round(taps, compute_dtype))
    y = y.reshape(M, -1, B, H, W).transpose(1, 2)
    return y + b[:, None, :, None, None]


def _bc(v: torch.Tensor) -> torch.Tensor:
    """[M, C] -> [M, 1, C, 1, 1], to broadcast over [M, B, C, H, W]."""
    return v[:, None, :, None, None]


def fused_res_stage_plain(x, w, b, s, t, compute_dtype=None) -> torch.Tensor:
    for r in range(2):
        res = h = x
        for c in range(2):
            j = 2 * r + c
            h = torch.relu(h * _bc(s[:, j]) + _bc(t[:, j]))
            h = _conv3x3(h, w[:, j], b[:, j], compute_dtype)
        x = res + h
    return x


def fused_feat_pool_plain(x, w, b, s, t, compute_dtype=None) -> torch.Tensor:
    """The dense conv output's 3x3 maxima (-inf padding) at the even
    positions: ``max_pool2d(3, 2, 1)``, the same values as the dense max map
    sliced ``[::2, ::2]``."""
    M, B = x.shape[:2]
    y = _conv3x3(x * _bc(s) + _bc(t), w, b, compute_dtype)
    pooled = F.max_pool2d(y.reshape(M * B, *y.shape[2:]), 3, stride=2, padding=1)
    return pooled.reshape(M, B, *pooled.shape[1:])


# -- the kernels -----------------------------------------------------------------------


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check_stage(x, w, b, s, t) -> None:
    _expect(x.ndim == 5, f"x must be [M, B, C, H, W], got {tuple(x.shape)}")
    M, _, C = x.shape[:3]
    _expect(tuple(w.shape) == (M, 4, C, 9 * C), f"w must be [M, 4, C, 9C] = {(M, 4, C, 9 * C)}, "
                                                f"got {tuple(w.shape)}")
    for name, v in (("b", b), ("s", s), ("t", t)):
        _expect(tuple(v.shape) == (M, 4, C), f"{name} must be [M, 4, C] = {(M, 4, C)}, "
                                             f"got {tuple(v.shape)}")


def _check_feat(x, w, b, s, t) -> None:
    _expect(x.ndim == 5, f"x must be [M, B, ci, H, W], got {tuple(x.shape)}")
    M, _, ci = x.shape[:3]
    _expect(w.ndim == 3 and w.shape[0] == M and w.shape[2] == 9 * ci,
            f"w must be [M, co, 9ci] with M = {M}, 9ci = {9 * ci}, got {tuple(w.shape)}")
    co = w.shape[1]
    # b/s/t are 1-D per member: the column-vector [c, 1] form of the TPU
    # kernel's Mosaic layout is refused, not reshaped
    for name, v, c in (("b", b, co), ("s", s, ci), ("t", t, ci)):
        _expect(tuple(v.shape) == (M, c), f"{name} must be 1-D per member, [M, {c}], "
                                          f"got {tuple(v.shape)}")


def _on_cpu(x, *operands, compute_dtype) -> bool:
    """Checks what the kernels need of the operands on any device, so that
    the CPU refuses what the card does; then whether they lie on the CPU
    (else on one CUDA device).  The caller computes the launch plan, which
    refuses shapes no block fits, before it branches too."""
    _expect(x.device.type in ("cpu", "cuda"),
            f"x must lie on the CPU or a CUDA device, got {x.device}")
    for v in (x,) + operands:
        _expect(v.device == x.device, f"every operand must lie on {x.device}, got {v.device}")
        _expect(v.dtype == torch.float32 and v.is_contiguous(),
                "every operand must be a contiguous float32 tensor")
    _expect(compute_dtype in (None, torch.bfloat16),
            f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
    return x.device.type == "cpu"


# The kernels' launch plans.  The bf16 cluster entry points recompute the
# shared memory from the same parameters and refuse a plan that does not fit;
# the f32 ones and every tiled one compute the plan themselves and refuse one
# that differs.
SMEM_MAX = 232_448  # bytes of shared memory an H100 block can use
FEAT_GROUP = 64     # output channels of one bf16 cluster feature-pool block
TF32_MAX_ROWS = 256  # output channels an f32 cluster block takes: 8 warps of 32


class TiledPlan(NamedTuple):
    """The tiled form's launch plan.  A block computes ``rows x cols``
    outputs (the res stage's conv outputs; the feature pool's pooled
    outputs, from (2 rows + 1) x (2 cols + 1) dense ones) of ``group``
    output channels, ``tiles`` tiles a frame, streaming the input channels
    ``kc`` at a time through a ring of ``stages`` slots in ``smem`` bytes of
    shared memory."""

    rows: int
    cols: int
    tiles: int
    group: int
    kc: int
    smem: int
    stages: int = 2


TILED_KC = {"tf32": 16, "mma": 16}  # input channels of a chunk: two k8 / one k16 step a tap


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _tf32_tiles(co: int) -> Tuple[int, int]:
    """(weight rows the warps read, positions a chunk covers at most) of the
    f32 kernels: a warp takes one m16 tile x 128 positions at up to 16
    output channels, else two x 64, and the 8 warps spread over the channel
    groups first."""
    mt = 1 if co <= 16 else 2
    rows = -(-co // (16 * mt)) * 16 * mt
    return rows, 8 // (rows // (16 * mt)) * 8 * (16 // mt)


def _res_stage_tf32_cluster(C: int, H: int, W: int):
    """(cluster, band, tap group, shared bytes) of ``res_stage_tf32_kernel``:
    the fewest blocks a frame (1, 2, 4 or 8) whose bands of ``band`` image
    rows, two halo-padded f32 buffers of every channel, fit beside two
    buffers of weights in groups of 9, 3 or 1 taps (the largest that fits);
    None where no cluster fits or C is past ``TF32_MAX_ROWS``."""
    rows, _ = _tf32_tiles(C)
    if rows > TF32_MAX_ROWS:
        return None
    kp = -(-C // 8) * 8
    for cluster in (1, 2, 4, 8):
        band = -(-H // cluster)
        for wt in (9, 3, 1):
            smem = 4 * (2 * (band + 2) * (W + 2) * (kp + 4) + 2 * rows * (wt * kp + 4))
            if smem <= SMEM_MAX:
                return cluster, band, wt, smem
    return None


def _feat_pool_tf32_cluster(ci: int, co: int, H: int, W: int):
    """(pooled rows a block, bands, tap group, shared bytes) of
    ``feat_pool_tf32_kernel``: the most pooled rows, spread evenly over the
    bands, whose dense rows one chunk of the block's warps covers (the dense
    map then overlays the conv's buffers), and the largest tap group that
    fits; fewer rows while nothing fits; None where nothing fits or co is
    past ``TF32_MAX_ROWS``."""
    rows, cap = _tf32_tiles(co)
    if rows > TF32_MAX_ROWS:
        return None
    kp, Ho = -(-ci // 8) * 8, (H + 1) // 2
    pb = min(Ho, max(1, (cap // W - 1) // 2))
    while True:
        bands = -(-Ho // pb)
        pb = -(-Ho // bands)
        dr = 2 * pb + 1
        for wt in (9, 3, 1):
            conv = 4 * ((dr + 2) * (W + 2) * (kp + 4) + 2 * rows * (wt * kp + 4))
            dense = 4 * co * dr * W
            smem = max(conv, dense) if dr * W <= cap else conv + dense
            if smem <= SMEM_MAX:
                return pb, bands, wt, smem
        if pb == 1:
            return None
        pb -= 1


def _res_stage_mma_cluster(C: int, H: int, W: int):
    """(cluster, band, shared bytes) of ``res_stage_mma_kernel``: the fewest
    blocks a frame (2, 4 or 8) whose bands of ``band`` image rows, two
    halo-padded bf16 buffers of every channel, fit beside a weight tap; None
    where none fits."""
    kp = _pad16(C)
    for cluster in (2, 4, 8):
        band = -(-H // cluster)
        smem = 4 * (band + 2) * (W + 2) * (kp + 8) + 2 * kp * (kp + 8) + 4 * kp * C
        if smem <= SMEM_MAX:
            return cluster, band, smem
    return None


def _feat_pool_mma_cluster(ci: int, co: int, H: int, W: int):
    """(pooled rows a block, bands, shared bytes) of ``feat_pool_mma_kernel``:
    at most 256 dense positions a block (one chunk of its 8 warps, so the
    dense map overlays the conv's buffers), the pooled rows spread evenly
    over the bands; None where even one pooled row does not fit."""
    kp, mp, Ho = _pad16(ci), min(FEAT_GROUP, _pad16(co)), (H + 1) // 2
    pb = min(Ho, max(1, (256 // W - 1) // 2))
    while True:
        bands = -(-Ho // pb)
        pb = -(-Ho // bands)
        dr = 2 * pb + 1
        conv = 2 * (dr + 2) * (W + 2) * (kp + 8) + 2 * mp * (kp + 8) + 4 * mp * ci
        dense = 4 * mp * dr * W  # overlays the conv's buffers when one chunk covers the band
        smem = max(conv, dense) if dr * W <= 256 else conv + dense
        if smem <= SMEM_MAX:
            return pb, bands, smem
        if pb == 1:
            return None
        pb -= 1


# -- the tiled forms' plans ------------------------------------------------------------

# The f32 tiled forms (csrc/tiled_tf32_plan.cuh): blocks of 16 warps, K in chunks of 16
# input channels, two of each buffer; the res stage 64 output channels x 128 positions a
# block (whose halo-padded rows fit 144), the feature pool 32 x 320 dense positions.
TF32_TILED_KC, TF32_TILED_STAGES = TILED_KC["tf32"], 2
TF32_RES_GROUP, TF32_RES_SLOTS, TF32_RES_HALO = 64, 128, 144
TF32_POOL_GROUP, TF32_POOL_SLOTS = 32, 320
TF32_TILED_SMEM_MAX = SMEM_MAX - 256  # the rest holds the kernel's static mbarriers


def _tiled_smem(route: str, co: int, th: int, tw: int, pool: bool) -> int:
    """Shared bytes of a tiled block of th x tw conv outputs.  f32
    (``tiled_tf32::smem_bytes``): two of each buffer for 16 input channels
    (the raw operand tile landing in rows of 4-float pieces, its hi and lo
    planes, the group's weights as hi and lo) from a 128-byte boundary, or
    what overlays them after the products (the K halves' sums, then the
    pool's dense map), whichever is larger.  bf16: :func:`_mma_smem` with
    its ring's slots."""
    if route == "mma":
        return _mma_smem(pool, co, th, tw, _mma_stages(pool, co, th, tw))
    npt = (th + 2) * (tw + 2)
    group = TF32_POOL_GROUP if pool else TF32_RES_GROUP
    landing = TF32_TILED_KC * (th + 2) * 4 * -(-(tw + 5) // 4)
    planes = 2 * TF32_TILED_KC * (npt if pool else max(npt, TF32_RES_HALO + 2 * (tw + 2) + 2))
    ring = 4 * TF32_TILED_STAGES * (landing + planes + 18 * TF32_TILED_KC * group) + 128
    return max(ring, 4 * (8 * 32 * 40 + group * th * tw) if pool else 4 * 8 * 32 * 36)


def _spread(n: int, per: int) -> Tuple[int, int]:
    """(per tile, tiles): n items in tiles of at most ``per``, spread evenly."""
    tiles = -(-n // per)
    return -(-n // tiles), tiles


def _res_tile_tf32(H: int, W: int) -> Tuple[int, int]:
    """``tiled_tf32::res_plan`` before the spread: 16 columns (all of W where
    it is narrower), as many rows as fill 128 positions (all of H where it is
    shorter, the columns then widened to fill them), fewer rows (then
    columns) while its halo-padded rows pass 144 positions or the buffers
    do not fit."""
    w = min(W, 16)
    h = min(H, TF32_RES_SLOTS // w)
    if h == H:
        w = min(W, TF32_RES_SLOTS // h)
    while h * (w + 2) - 2 > TF32_RES_HALO or \
            _tiled_smem("tf32", TF32_RES_GROUP, h, w, False) > TF32_TILED_SMEM_MAX:
        if h > 1:
            h -= 1
        else:
            w -= 1
    return h, w


def _pool_tile_tf32(H: int, W: int) -> Tuple[int, int]:
    """``tiled_tf32::feat_plan`` before the spread: 8 x 8 pooled outputs (289
    dense of the block's 320), a side short of 8 giving its positions to the
    other, fewer while the ring does not fit."""
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    r, c = min(Ho, 8), min(Wo, 8)
    if r < 8:
        c = min(Wo, max(1, (TF32_POOL_SLOTS // (2 * r + 1) - 1) // 2))
    elif c < 8:
        r = min(Ho, max(1, (TF32_POOL_SLOTS // (2 * c + 1) - 1) // 2))
    while (r > 1 or c > 1) and _tiled_smem("tf32", TF32_POOL_GROUP, 2 * r + 1, 2 * c + 1,
                                            True) > TF32_TILED_SMEM_MAX:
        if r >= c:
            r -= 1
        else:
            c -= 1
    return r, c


# The bf16 tiled forms (csrc/tiled_mma_plan.cuh): blocks of 4 warpgroups, each 64 output
# channels x 152 positions of the tile's halo-padded rows on wgmma; one group of 64 output
# channels a block over 4 x 152 positions, or both groups of a conv past 64 channels over
# 2 x 152; K in chunks of 16 input channels through a ring of 3 slots where they fit, else 2.
MMA_TILED_KC, MMA_GROUP, MMA_N = TILED_KC["mma"], 64, 152
MMA_TILED_SMEM_MAX = SMEM_MAX - 256  # the rest holds the kernel's static mbarriers
MMA_BOX_MAX = 251  # the widest tile whose landing rows fit a tensor map's 256-float box


def _mma_block_groups(co: int) -> int:
    """``tiled_mma::block_groups``: groups of 64 output channels a block takes."""
    return 2 if co > MMA_GROUP else 1


def _mma_slots(co: int) -> int:
    """``tiled_mma::block_slots``: halo-padded positions a block's products cover."""
    return 4 // _mma_block_groups(co) * MMA_N


def _mma_image_groups(co: int) -> int:
    """``tiled_mma::image_groups``: groups of a conv's image, whole blocks' worth."""
    gb = _mma_block_groups(co)
    return gb * -(-(-(-co // MMA_GROUP)) // gb)


def _mma_smem(pool: bool, co: int, th: int, tw: int, stages: int, planar: bool = False) -> int:
    """``tiled_mma::smem_bytes``: ``stages`` ring slots from a 128-byte
    boundary, each the block's bf16 weights and, for an f32 operand, its
    landing tile in rows of 4-float pieces (two slots of bf16 planes beside
    them), for a ``planar`` one (the res stage's convs 1-3) its bf16 planes;
    or the block's sums (the pool's dense map; rows of the tile's outputs
    rounded to 4 plus 4, ``stage_stride``) and the res stage's next affine,
    which overlay them after the products, whichever is larger."""
    landing = 4 * MMA_TILED_KC * (th + 2) * 4 * -(-(tw + 5) // 4)
    planes = 2 * MMA_TILED_KC * 8 * -(-max((th + 2) * (tw + 2),
                                             _mma_slots(co) + 2 * (tw + 2) + 2) // 8)
    weights = 2 * _mma_block_groups(co) * 9 * MMA_TILED_KC * MMA_GROUP
    ring = (stages * (planes + weights) if planar else stages * (landing + weights) + 2 * planes)
    sums = 4 * _mma_block_groups(co) * MMA_GROUP * (4 * -(-(th * tw) // 4) + 4 + (0 if pool else 2))
    return max(ring + 128, sums)


def _mma_stages(pool: bool, co: int, th: int, tw: int, planar: bool = False) -> int:
    """``tiled_mma::stages``: ring slots, for an f32 operand 3 where they
    fit, else 2; for a planar one 4, 3 or 2."""
    for stages in ((4, 3) if planar else (3,)):
        if _mma_smem(pool, co, th, tw, stages, planar) <= MMA_TILED_SMEM_MAX:
            return stages
    return 2


def _res_tile_mma(C: int, H: int, W: int) -> Tuple[int, int]:
    """``tiled_mma::res_plan`` before the spread: whole rows of at most
    (slots + 2) / 4 - 2 columns, as many rows as the block's halo-padded
    positions take (all of H where it is shorter, the columns then widened
    to fill them, up to ``MMA_BOX_MAX``), fewer rows (then columns) while
    two ring slots do not fit."""
    slots = _mma_slots(C)
    w = min(W, (slots + 2) // 4 - 2)
    h = min(H, (slots + 2) // (w + 2))
    if h == H:
        w = min(W, MMA_BOX_MAX, (slots + 2) // h - 2)
    while _mma_smem(False, C, h, w, 2) > MMA_TILED_SMEM_MAX:
        if h > 1:
            h -= 1
        else:
            w -= 1
    return h, w


def _pool_tile_mma(co: int, H: int, W: int) -> Tuple[int, int]:
    """``tiled_mma::feat_plan`` before the spread: 8 pooled rows and as many
    columns as the halo-padded dense rows take (all of them where they fit,
    the rows then widened), fewer while two ring slots or the dense map do
    not fit."""
    Ho, Wo, slots = (H + 1) // 2, (W + 1) // 2, _mma_slots(co)
    r = min(Ho, 8)
    c = min(Wo, max(1, ((slots + 2) // (2 * r + 1) - 3) // 2))
    if c == Wo:
        r = min(Ho, max(1, ((slots + 2) // (2 * c + 3) - 1) // 2))
    while (r > 1 or c > 1) and ((2 * r + 1) * (2 * c + 3) - 2 > slots or _mma_smem(
            True, co, 2 * r + 1, 2 * c + 1, 2) > MMA_TILED_SMEM_MAX):
        if r >= c:
            r -= 1
        else:
            c -= 1
    return r, c


@functools.lru_cache(maxsize=None)
def res_stage_tiled_plan(C: int, H: int, W: int, route: str) -> TiledPlan:
    """The tiled res stage's tile: ``tiled_tf32::res_plan``
    (:func:`_res_tile_tf32`) or ``tiled_mma::res_plan``
    (:func:`_res_tile_mma`), then spread evenly over the frame.  The C
    entry computes the same."""
    if route == "tf32":
        (h, w), group = _res_tile_tf32(H, W), TF32_RES_GROUP
    else:
        (h, w), group = _res_tile_mma(C, H, W), _mma_block_groups(C) * MMA_GROUP
    th, ntr = _spread(H, h)
    tw, ntc = _spread(W, w)
    stages = TF32_TILED_STAGES if route == "tf32" else _mma_stages(False, C, th, tw)
    return TiledPlan(th, tw, ntr * ntc, group, TILED_KC[route],
                     _tiled_smem(route, C, th, tw, False), stages)


@functools.lru_cache(maxsize=None)
def feat_pool_tiled_plan(ci: int, co: int, H: int, W: int, route: str) -> TiledPlan:
    """The tiled feature pool's tile of pooled outputs:
    ``tiled_tf32::feat_plan`` (:func:`_pool_tile_tf32`) or
    ``tiled_mma::feat_plan`` (:func:`_pool_tile_mma`), then spread evenly.
    The C entry computes the same."""
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    if route == "tf32":
        (r, c), group = _pool_tile_tf32(H, W), TF32_POOL_GROUP
    else:
        (r, c), group = _pool_tile_mma(co, H, W), _mma_block_groups(co) * MMA_GROUP
    ph, ntr = _spread(Ho, r)
    pw, ntc = _spread(Wo, c)
    th, tw = 2 * ph + 1, 2 * pw + 1
    stages = TF32_TILED_STAGES if route == "tf32" else _mma_stages(True, co, th, tw)
    return TiledPlan(ph, pw, ntr * ntc, group, TILED_KC[route],
                     _tiled_smem(route, co, th, tw, True), stages)


def tf32_weight_image_floats(ci: int, co: int, group: int) -> int:
    """Floats of one conv's f32 weight image for one member
    (``tiled_tf32::conv_image_floats``): every group of ``group`` output
    channels x every chunk of 16 input channels, each as hi and lo planes
    [2, 9 taps, 4, group, 4]."""
    return -(-co // group) * -(-ci // TF32_TILED_KC) * 2 * 9 * TF32_TILED_KC * group


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_weight_image_plain(w: torch.Tensor, ci: int, group: int) -> torch.Tensor:
    """The f32 tiled forms' weight image (``split_weights_kernel``) of w
    [..., co, 9 ci] in tap order: [..., groups, chunks, 2 (hi, lo), 9 taps,
    4 planes, group rows, 4 channels], zero past co and ci, with hi =
    tf32(w) and lo = tf32(w - hi)."""
    lead, co = w.shape[:-2], w.shape[-2]
    ng, nk, kc = -(-co // group), -(-ci // TF32_TILED_KC), TF32_TILED_KC
    v = F.pad(w.reshape(*lead, co, 9, ci), (0, nk * kc - ci, 0, 0, 0, ng * group - co))
    v = v.reshape(*lead, ng, group, 9, nk, kc // 4, 4)
    n = len(lead)
    v = v.permute(*range(n), n, n + 3, n + 2, n + 4, n + 1, n + 5)  # [ng, nk, 9, 4, group, 4]
    hi = _tf32_round(v)
    lo = _tf32_round(v - hi)
    return torch.stack([hi, lo], dim=n + 2).contiguous()


def mma_weight_image_elems(ci: int, co: int) -> int:
    """bf16 values of one conv's bf16 weight image for one member
    (``tiled_mma::conv_image_elems``): every chunk of 16 input channels x
    every group of 64 output channels (whole blocks' worth), each [9 taps, 2
    planes, 64 rows, 8]."""
    return -(-ci // MMA_TILED_KC) * _mma_image_groups(co) * 9 * MMA_TILED_KC * MMA_GROUP


def mma_weight_image_plain(w: torch.Tensor, ci: int) -> torch.Tensor:
    """The bf16 tiled forms' weight image (``round_weights_kernel``) of w
    [..., co, 9 ci] in tap order: [..., chunks, image groups, 9 taps, 2
    planes, 64 rows, 8 channels] in bf16 (round to nearest), zero past co
    and ci."""
    lead, co = w.shape[:-2], w.shape[-2]
    ng, nk, kc = _mma_image_groups(co), -(-ci // MMA_TILED_KC), MMA_TILED_KC
    v = F.pad(w.reshape(*lead, co, 9, ci), (0, nk * kc - ci, 0, 0, 0, ng * MMA_GROUP - co))
    v = v.reshape(*lead, ng, MMA_GROUP, 9, nk, kc // 8, 8)
    n = len(lead)
    v = v.permute(*range(n), n + 3, n, n + 2, n + 4, n + 1, n + 5)  # [nk, ng, 9, 2, 64, 8]
    return v.to(torch.bfloat16).contiguous()


# -- each route's plan: the cluster form where it fits, else the tiled form -------------


@functools.lru_cache(maxsize=None)
def res_stage_tf32_plan(C: int, H: int, W: int) -> Union[Tuple[int, int, int, int], TiledPlan]:
    """The f32 res stage's plan: ``(cluster, band, tap group, shared bytes)``
    of ``res_stage_tf32_kernel`` where a cluster fits, else the tiled form's
    :class:`TiledPlan`."""
    return _res_stage_tf32_cluster(C, H, W) or res_stage_tiled_plan(C, H, W, "tf32")


@functools.lru_cache(maxsize=None)
def feat_pool_tf32_plan(ci: int, co: int, H: int,
                        W: int) -> Union[Tuple[int, int, int, int], TiledPlan]:
    """The f32 feature pool's plan: ``(pooled rows a block, bands, tap group,
    shared bytes)`` of ``feat_pool_tf32_kernel`` where a band fits, else the
    tiled form's :class:`TiledPlan`."""
    return _feat_pool_tf32_cluster(ci, co, H, W) or feat_pool_tiled_plan(ci, co, H, W, "tf32")


@functools.lru_cache(maxsize=None)
def res_stage_mma_plan(C: int, H: int, W: int) -> Union[Tuple[int, int, int], TiledPlan]:
    """The bf16 res stage's plan: ``(cluster, band, shared bytes)`` of
    ``res_stage_mma_kernel`` where a cluster fits, else the tiled form's
    :class:`TiledPlan`."""
    return _res_stage_mma_cluster(C, H, W) or res_stage_tiled_plan(C, H, W, "mma")


@functools.lru_cache(maxsize=None)
def feat_pool_mma_plan(ci: int, co: int, H: int, W: int) -> Union[Tuple[int, int, int], TiledPlan]:
    """The bf16 feature pool's plan: ``(pooled rows a block, bands, shared
    bytes)`` of ``feat_pool_mma_kernel`` where a band fits, else the tiled
    form's :class:`TiledPlan`."""
    return _feat_pool_mma_cluster(ci, co, H, W) or feat_pool_tiled_plan(ci, co, H, W, "mma")


def _bind_tiled(lib: ctypes.CDLL, route: str) -> None:
    """The tiled entries' arguments: a weight image buffer after t, and at
    the end whether to make the weights' image in it (split or round)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    res = getattr(lib, f"dfd_res_stage_tiled_{route}")
    feat = getattr(lib, f"dfd_feat_pool_tiled_{route}")
    res.argtypes = [vp] * 8 + [i32] * 8 + [vp]
    feat.argtypes = [vp] * 7 + [i32] * 9 + [vp]
    res.restype = feat.restype = i32


# The tiled forms' weight images (f32: split into TF32 hi and lo; bf16: rounded), most
# recent last: a rollout passes the same prepared weight tensors at every step
# (ImpalaPolicy.prepare), so their image is made once and reused while the tensor is the
# same object at the same version on the same stream, for the same route.  Each entry
# holds its tensor, so no other tensor can take its memory.
_IMAGES: "collections.OrderedDict" = collections.OrderedDict()
_IMAGES_KEPT = 6


def _weight_image(w: torch.Tensor, floats: int, stream: int,
                  route: str = "tf32") -> Tuple[torch.Tensor, bool]:
    """(an image buffer of ``floats`` 4-byte words for w, whether the kernel
    must make w's image in it); a new buffer is kept by :func:`_keep_image`
    once its launch is in."""
    key = (id(w), stream, route)
    hit = _IMAGES.get(key)
    if hit is not None and hit[0] is w and hit[1] == w._version and hit[2].numel() == floats:
        _IMAGES.move_to_end(key)
        return hit[2], False
    return torch.empty(floats, device=w.device), True


def _keep_image(w: torch.Tensor, stream: int, image: torch.Tensor, route: str = "tf32") -> None:
    key = (id(w), stream, route)
    _IMAGES[key] = (w, w._version, image)
    _IMAGES.move_to_end(key)
    while len(_IMAGES) > _IMAGES_KEPT:
        _IMAGES.popitem(last=False)


@functools.lru_cache(maxsize=None)
def _tf32_kernels() -> ctypes.CDLL:
    lib = build.load("fused_resblock_tf32")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_tf32.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.dfd_res_stage_tf32.restype = i32
    lib.dfd_feat_pool_tf32.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.dfd_feat_pool_tf32.restype = i32
    _bind_tiled(lib, "tf32")
    return lib


@functools.lru_cache(maxsize=None)
def _mma_kernels() -> ctypes.CDLL:
    lib = build.load("fused_resblock_mma")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.dfd_res_stage_mma.restype = i32
    lib.dfd_feat_pool_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.dfd_feat_pool_mma.restype = i32
    lib.dfd_tiled_mma_kernels.argtypes = []
    lib.dfd_tiled_mma_kernels.restype = ctypes.c_longlong
    _bind_tiled(lib, "mma")
    return lib


def fused_res_stage(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
                    t: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One IMPALA stage's residual pair for every member and frame.

    x [M, B, C, H, W]; w [M, 4, C, 9C] (``reorder_conv_weight``); b, s, t
    [M, 4, C] (conv biases, folded BN scale and shift).  Returns
    [M, B, C, H, W] float32."""
    _check_stage(x, w, b, s, t)
    on_cpu = _on_cpu(x, w, b, s, t, compute_dtype=compute_dtype)
    M, B, C, H, W = x.shape
    plan = (res_stage_tf32_plan if compute_dtype is None else res_stage_mma_plan)(C, H, W)
    if on_cpu:
        return fused_res_stage_plain(x, w, b, s, t, compute_dtype)
    out = torch.empty_like(x)
    f32 = compute_dtype is None
    lib = _tf32_kernels() if f32 else _mma_kernels()
    what = "fused_res_stage" + ("" if f32 else " (bf16)")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), t.data_ptr())
        if isinstance(plan, TiledPlan):
            # f32: the odd convs' outputs; bf16: two buffers of bf16 planes (each conv's
            # operand, M B ceil(C / 8) H W 8 values)
            scratch = torch.empty_like(x) if f32 else torch.empty(
                M * B * 8 * -(-C // 8) * H * W, device=x.device)
            route = "tf32" if f32 else "mma"
            floats = (tf32_weight_image_floats(C, C, plan.group) if f32
                      else mma_weight_image_elems(C, C) // 2)
            wimg, fresh = _weight_image(w, M * 4 * floats, stream, route)
            build.raise_on(getattr(lib, f"dfd_res_stage_tiled_{route}")(
                *ptrs, wimg.data_ptr(), scratch.data_ptr(), out.data_ptr(), M, B, C, H, W,
                plan.rows, plan.cols, int(fresh), stream), what + " (tiled)")
            if fresh:
                _keep_image(w, stream, wimg, route)
            if f32:
                fused_res_stage.tiled_launches += 1
            else:
                fused_res_stage.tiled_mma_launches += 1
        elif f32:
            cluster, band, wt, _ = plan
            build.raise_on(lib.dfd_res_stage_tf32(*ptrs, out.data_ptr(), M, B, C, H, W, cluster,
                                                  band, wt, stream), what)
            fused_res_stage.launches += 1
        else:
            cluster, band, _ = plan
            build.raise_on(lib.dfd_res_stage_mma(*ptrs, out.data_ptr(), M, B, C, H, W, cluster,
                                                 band, stream), what)
            fused_res_stage.mma_launches += 1
    return out


fused_res_stage.launches = 0
fused_res_stage.mma_launches = 0
fused_res_stage.tiled_launches = 0
fused_res_stage.tiled_mma_launches = 0


def fused_feat_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
                    t: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One IMPALA stage's feature block (BN -> 3x3 conv -> maxpool 3x3 s2 p1)
    for every member and frame.

    x [M, B, ci, H, W]; w [M, co, 9ci] (``reorder_conv_weight``); b [M, co];
    s, t [M, ci] (folded BN scale and shift).  Returns
    [M, B, co, ceil(H/2), ceil(W/2)] float32."""
    _check_feat(x, w, b, s, t)
    on_cpu = _on_cpu(x, w, b, s, t, compute_dtype=compute_dtype)
    M, B, ci, H, W = x.shape
    co = w.shape[1]
    plan = (feat_pool_tf32_plan if compute_dtype is None else feat_pool_mma_plan)(ci, co, H, W)
    if on_cpu:
        return fused_feat_pool_plain(x, w, b, s, t, compute_dtype)
    out = torch.empty((M, B, co, (H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                      device=x.device)
    f32 = compute_dtype is None
    lib = _tf32_kernels() if f32 else _mma_kernels()
    what = "fused_feat_pool" + ("" if f32 else " (bf16)")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), t.data_ptr(),
                out.data_ptr())
        if isinstance(plan, TiledPlan):
            route = "tf32" if f32 else "mma"
            floats = (tf32_weight_image_floats(ci, co, plan.group) if f32
                      else mma_weight_image_elems(ci, co) // 2)
            wimg, fresh = _weight_image(w, M * floats, stream, route)
            build.raise_on(getattr(lib, f"dfd_feat_pool_tiled_{route}")(
                *ptrs[:5], wimg.data_ptr(), ptrs[5], M, B, ci, co, H, W, plan.rows, plan.cols,
                int(fresh), stream), what + " (tiled)")
            if fresh:
                _keep_image(w, stream, wimg, route)
            if f32:
                fused_feat_pool.tiled_launches += 1
            else:
                fused_feat_pool.tiled_mma_launches += 1
        elif f32:
            pb, _, wt, _ = plan
            build.raise_on(lib.dfd_feat_pool_tf32(*ptrs, M, B, ci, co, H, W, pb, wt, stream), what)
            fused_feat_pool.launches += 1
        else:
            pb, _, _ = plan
            build.raise_on(lib.dfd_feat_pool_mma(*ptrs, M, B, ci, co, H, W, pb, stream), what)
            fused_feat_pool.mma_launches += 1
    return out


fused_feat_pool.launches = 0
fused_feat_pool.mma_launches = 0
fused_feat_pool.tiled_launches = 0
fused_feat_pool.tiled_mma_launches = 0
