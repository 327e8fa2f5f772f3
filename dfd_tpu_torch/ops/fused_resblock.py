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

Both keep the taps out of memory altogether.  Unlike the TPU kernels they
take any C, H and W, up to the shared memory a block holds (the launch
plans :func:`res_stage_tf32_plan`, :func:`feat_pool_tf32_plan`,
:func:`res_stage_mma_plan`, :func:`feat_pool_mma_plan`);
:func:`fused_supported` (the TPU's lane rule ``H * W % 128 == 0``) is kept
only as the IMPALA model's gate, so the port runs the same layers through
the kernels as the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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


# The kernels' launch plans.  The bf16 entry points recompute the shared
# memory from the same parameters and refuse a plan that does not fit; the
# f32 ones compute the plan themselves and refuse one that differs.
SMEM_MAX = 232_448  # bytes of shared memory an H100 block can use
FEAT_GROUP = 64     # output channels of one bf16 feature-pool block
TF32_MAX_ROWS = 256  # output channels an f32 block takes: 8 warps of 32


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


@functools.lru_cache(maxsize=None)
def res_stage_tf32_plan(C: int, H: int, W: int) -> Tuple[int, int, int, int]:
    """(cluster, band, tap group, shared bytes) of ``res_stage_tf32_kernel``:
    the fewest blocks a frame (1, 2, 4 or 8) whose bands of ``band`` image
    rows, two halo-padded f32 buffers of every channel, fit beside two
    buffers of weights in groups of 9, 3 or 1 taps (the largest that fits)."""
    rows, _ = _tf32_tiles(C)
    _expect(rows <= TF32_MAX_ROWS, f"the f32 res stage takes at most {TF32_MAX_ROWS} channels, "
                                   f"got C={C}")
    kp = -(-C // 8) * 8
    for cluster in (1, 2, 4, 8):
        band = -(-H // cluster)
        for wt in (9, 3, 1):
            smem = 4 * (2 * (band + 2) * (W + 2) * (kp + 4) + 2 * rows * (wt * kp + 4))
            if smem <= SMEM_MAX:
                return cluster, band, wt, smem
    raise ValueError(f"the f32 res stage's band of C={C} x W={W} does not fit in "
                     f"{SMEM_MAX} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def feat_pool_tf32_plan(ci: int, co: int, H: int, W: int) -> Tuple[int, int, int, int]:
    """(pooled rows a block, bands, tap group, shared bytes) of
    ``feat_pool_tf32_kernel``: the most pooled rows, spread evenly over the
    bands, whose dense rows one chunk of the block's warps covers (the dense
    map then overlays the conv's buffers), and the largest tap group that
    fits; fewer rows while nothing fits."""
    rows, cap = _tf32_tiles(co)
    _expect(rows <= TF32_MAX_ROWS, f"the f32 feature pool takes at most {TF32_MAX_ROWS} output "
                                   f"channels, got co={co}")
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
        _expect(pb > 1, f"the f32 feature pool's rows of ci={ci} x W={W} do not fit in "
                        f"{SMEM_MAX} bytes of shared memory")
        pb -= 1


@functools.lru_cache(maxsize=None)
def res_stage_mma_plan(C: int, H: int, W: int) -> Tuple[int, int, int]:
    """(cluster, band, shared bytes) of ``res_stage_mma_kernel``: the fewest
    blocks a frame (2, 4 or 8) whose bands of ``band`` image rows, two
    halo-padded bf16 buffers of every channel, fit beside a weight tap."""
    kp = _pad16(C)
    for cluster in (2, 4, 8):
        band = -(-H // cluster)
        smem = 4 * (band + 2) * (W + 2) * (kp + 8) + 2 * kp * (kp + 8) + 4 * kp * C
        if smem <= SMEM_MAX:
            return cluster, band, smem
    raise ValueError(f"the bf16 res stage's band of C={C} x W={W} does not fit in "
                     f"{SMEM_MAX} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def feat_pool_mma_plan(ci: int, co: int, H: int, W: int) -> Tuple[int, int, int]:
    """(pooled rows a block, bands, shared bytes) of ``feat_pool_mma_kernel``:
    at most 256 dense positions a block (one chunk of its 8 warps, so the
    dense map overlays the conv's buffers), the pooled rows spread evenly
    over the bands."""
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
        _expect(pb > 1, f"the bf16 feature pool's rows of ci={ci} x W={W} do not fit in "
                        f"{SMEM_MAX} bytes of shared memory")
        pb -= 1


@functools.lru_cache(maxsize=None)
def _tf32_kernels() -> ctypes.CDLL:
    lib = build.load("fused_resblock_tf32")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_tf32.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.dfd_res_stage_tf32.restype = i32
    lib.dfd_feat_pool_tf32.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    lib.dfd_feat_pool_tf32.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _mma_kernels() -> ctypes.CDLL:
    lib = build.load("fused_resblock_mma")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_stage_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.dfd_res_stage_mma.restype = i32
    lib.dfd_feat_pool_mma.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.dfd_feat_pool_mma.restype = i32
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), t.data_ptr(),
                out.data_ptr())
        if compute_dtype is None:
            cluster, band, wt, _ = plan
            build.raise_on(_tf32_kernels().dfd_res_stage_tf32(*ptrs, M, B, C, H, W, cluster, band,
                                                              wt, stream), "fused_res_stage")
            fused_res_stage.launches += 1
        else:
            cluster, band, _ = plan
            build.raise_on(_mma_kernels().dfd_res_stage_mma(*ptrs, M, B, C, H, W, cluster, band,
                                                            stream), "fused_res_stage (bf16)")
            fused_res_stage.mma_launches += 1
    return out


fused_res_stage.launches = 0
fused_res_stage.mma_launches = 0


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), t.data_ptr(),
                out.data_ptr())
        if compute_dtype is None:
            pb, _, wt, _ = plan
            build.raise_on(_tf32_kernels().dfd_feat_pool_tf32(*ptrs, M, B, ci, co, H, W, pb, wt,
                                                              stream), "fused_feat_pool")
            fused_feat_pool.launches += 1
        else:
            pb, _, _ = plan
            build.raise_on(_mma_kernels().dfd_feat_pool_mma(*ptrs, M, B, ci, co, H, W, pb,
                                                            stream), "fused_feat_pool (bf16)")
            fused_feat_pool.mma_launches += 1
    return out


fused_feat_pool.launches = 0
fused_feat_pool.mma_launches = 0
