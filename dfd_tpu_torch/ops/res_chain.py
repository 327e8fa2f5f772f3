"""The TPU probes' fused residual-conv chain, in both layouts.

Replaces the Pallas TPU probe kernels ``tools/probe_pallas_wide.py::probe_stage``
(``make_fused_n``, ``make_fused_m``) and ``tools/probe_pallas_pool.py::main``
(``fused_kernel_sq``, ``make_fused_m``).  For each member p, ``J`` times (J = 4
in the probes)::

    x <- x + 0.25 * relu(W_j . pat(x) + b_j)

with ``pat(x)`` the 3x3 zero-padded taps of every position, ordered
(dx, dy, c) as the probes' ``build_pat`` concatenates them, which is the order
of :func:`dfd_tpu_torch.ops.fused_resblock.reorder_conv_weight`.  Layouts:

- ``"channel_major"`` (the probes' N-major): x ``[P, C, S]``, W ``[P, J, C, 9C]``;
- ``"channel_minor"`` (the probes' M-major): x ``[P, S, C]``, W ``[P, J, 9C, C]``;

b ``[P, J, C]``, S = H·W, all float32.  ``compute_dtype=torch.bfloat16``
rounds both conv operands to bf16 and accumulates in float32.

:func:`res_chain` runs the CUDA kernel (``csrc/res_chain.cu``) on CUDA tensors
and :func:`res_chain_plain` on CPU tensors; other devices, dtypes or shapes
raise.  The plain version builds the taps as the probes do, with rolls over
the flattened S and boundary masks.  ``res_chain.launches`` counts kernel
launches, one a call.  The kernel runs the products on the tensor cores
(bf16 ``mma.sync``, or f32-accurate 3xTF32 ones for float32) with the whole
chain in shared memory, a cluster of blocks a member splitting its image
rows, its output channels or both, as :func:`res_chain_plan` lays out and
the C entry point recomputes; a shape no plan fits raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from dfd_tpu_torch.ops import build

LAYOUTS = ("channel_major", "channel_minor")


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x if compute_dtype is None else x.to(compute_dtype).to(torch.float32)


def build_pat(x: torch.Tensor, H: int, W: int, minor: bool) -> torch.Tensor:
    """The probes' ``build_pat``: [P, C, S] -> [P, 9C, S] (channel-major) or
    [P, S, C] -> [P, S, 9C] (channel-minor), rows (dx, dy, c), by circular
    rolls over S masked at the image's edges."""
    S = H * W
    s = torch.arange(S, device=x.device)
    shape = (S, 1) if minor else (1, S)
    mask = lambda ok: ok.to(torch.float32).reshape(shape)
    ml, mr = mask(s % W != 0), mask(s % W != W - 1)
    mt, mb = mask(s // W != 0), mask(s // W != H - 1)
    axis, cat = (1, 2) if minor else (2, 1)
    up = torch.roll(x, W, axis) * mt                 # x[y - 1]
    dn = torch.roll(x, S - W, axis) * mb             # x[y + 1]
    pat3 = torch.cat([up, x, dn], cat)
    left = torch.roll(pat3, 1, axis) * ml            # x[.., x - 1]
    right = torch.roll(pat3, S - 1, axis) * mr       # x[.., x + 1]
    return torch.cat([left, pat3, right], cat)


def res_chain_plain(x, w, b, H: int, W: int, layout: str = "channel_major",
                    compute_dtype=None) -> torch.Tensor:
    minor = layout == "channel_minor"
    for j in range(w.shape[1]):
        pat = _round(build_pat(x, H, W, minor), compute_dtype)
        wj = _round(w[:, j], compute_dtype)
        if minor:
            y = torch.bmm(pat, wj) + b[:, j, None, :]
        else:
            y = torch.bmm(wj, pat) + b[:, j, :, None]
        x = x + torch.relu(y) * 0.25
    return x


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check(x, w, b, H: int, W: int, layout: str, compute_dtype) -> None:
    _expect(layout in LAYOUTS, f"layout must be one of {LAYOUTS}, got {layout!r}")
    _expect(compute_dtype in (None, torch.bfloat16),
            f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
    _expect(x.ndim == 3, f"x must be [P, C, S] or [P, S, C], got {tuple(x.shape)}")
    minor = layout == "channel_minor"
    P, S, C = (x.shape[0], x.shape[1], x.shape[2]) if minor else (x.shape[0], x.shape[2],
                                                                  x.shape[1])
    _expect(H > 0 and W > 0 and S == H * W, f"S = {S} must equal H * W = {H} * {W}")
    J = w.shape[1] if w.ndim == 4 else 0
    want_w = (P, J, 9 * C, C) if minor else (P, J, C, 9 * C)
    _expect(J > 0 and tuple(w.shape) == want_w, f"w must be {want_w} with J > 0, "
                                                f"got {tuple(w.shape)}")
    _expect(tuple(b.shape) == (P, J, C), f"b must be {(P, J, C)}, got {tuple(b.shape)}")


SMEM_MAX = 232_448  # bytes of shared memory an H100 block can use
NUM_SMS = 132
MAX_TILES = 16      # m16 x n8 tiles a warp holds: 64 f32 sums a thread


class Plan(NamedTuple):
    """A launch of ``res_chain_kernel``: ``rs`` bands of ``band`` image rows
    x ``cs`` groups of ``cw`` output channels a member (a cluster of
    ``rs * cs`` blocks); ``warps_m`` x ``8 // warps_m`` warps of ``mt`` m16
    x ``nt`` n8 tiles; weights in groups of ``wt`` taps; ``smem`` bytes of
    dynamic shared memory."""

    rs: int
    cs: int
    band: int
    cw: int
    wt: int
    mt: int
    warps_m: int
    nt: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_smem(C: int, W: int, band: int, arows: int, wt: int, minor: bool, bf16: bool) -> int:
    """The halo-padded operand tile (bf16 or f32, every channel) and two f32
    weight buffers of ``wt`` taps for ``arows`` output rows."""
    kp = _cdiv(C, 16 if bf16 else 8) * (16 if bf16 else 8)
    tile = (band + 2) * (W + 2) * (kp + (8 if bf16 else 4)) * (2 if bf16 else 4)
    wbuf = 4 * (wt * kp * (arows + (4 if bf16 else 8)) if minor else arows * (wt * kp + 4))
    return tile + 2 * wbuf


@functools.lru_cache(maxsize=None)
def res_chain_plan(P: int, C: int, H: int, W: int, layout: str = "channel_major",
                   bf16: bool = False) -> Plan:
    """The cluster with the least work a block after the waves
    (``ceil(P * cl / 132) / cl``), then of its splits into ``rs`` row bands
    x ``cs`` channel groups that fit (no block empty, at most 64 sums a
    thread, the tile and a weight group in shared memory) the one with the
    fewest bands (each band streams its group's weights whole), then the
    fewest blocks; the largest tap group (9, 3, 1) that fits."""
    _expect(min(P, C, H, W) > 0, f"P, C, H and W must be positive, got {(P, C, H, W)}")
    minor = layout == "channel_minor"
    best, best_key = None, None
    for cl in (1, 2, 4, 8):
        work = _cdiv(P * cl, NUM_SMS) / cl
        for cs in (c for c in (1, 2, 4, 8) if c <= cl):
            rs = cl // cs
            band, cw = _cdiv(H, rs), _cdiv(_cdiv(C, cs), 16) * 16
            if (rs - 1) * band >= H or (cs - 1) * cw >= C:
                continue
            mt = min(4, cw // 16)
            warps_m = next((m for m in (1, 2, 4, 8) if m >= _cdiv(cw, 16 * mt)), None)
            if warps_m is None:
                continue
            nt = _cdiv(band * W, 8 * (8 // warps_m))
            if mt * nt > MAX_TILES:
                continue
            fits = [(wt, s) for wt in (9, 3, 1)
                    if (s := plan_smem(C, W, band, 16 * mt * warps_m, wt, minor, bf16)) <= SMEM_MAX]
            if not fits:
                continue
            if best is None or (work, rs) < best_key:
                best, best_key = Plan(rs, cs, band, cw, fits[0][0], mt, warps_m, nt,
                                      fits[0][1]), (work, rs)
    _expect(best is not None, f"no res_chain plan fits C={C} at {H}x{W} in {SMEM_MAX} bytes of "
                              f"shared memory a block")
    return best


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("res_chain")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_chain.argtypes = [vp] * 4 + [i32] * 15 + [vp]
    lib.dfd_res_chain.restype = i32
    return lib


def res_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, H: int, W: int,
              layout: str = "channel_major",
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The probes' chain for every member (see the module docstring); returns
    a float32 tensor of x's shape and layout."""
    _check(x, w, b, H, W, layout, compute_dtype)
    # what the kernel needs, checked on any device so that the CPU refuses
    # what the card does, the plan included
    _expect(x.device.type in ("cpu", "cuda"),
            f"x must lie on the CPU or a CUDA device, got {x.device}")
    for v in (x, w, b):
        _expect(v.device == x.device, f"every operand must lie on {x.device}, got {v.device}")
        _expect(v.dtype == torch.float32 and v.is_contiguous(),
                "every operand must be a contiguous float32 tensor")
    minor = layout == "channel_minor"
    P, J = w.shape[:2]
    C = x.shape[2] if minor else x.shape[1]
    bf16 = compute_dtype is not None
    p = res_chain_plan(P, C, H, W, layout, bf16)
    if x.device.type == "cpu":
        return res_chain_plain(x, w, b, H, W, layout, compute_dtype)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_res_chain(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), P, J, C, H, W, int(minor),
            int(bf16), *p[:-1], stream,
        ), "res_chain")
    res_chain.launches += 1
    return out


res_chain.launches = 0
