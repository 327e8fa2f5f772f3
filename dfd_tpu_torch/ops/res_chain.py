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
launches.  What bounds the kernel on an H100 is the FMAs (see the CUDA
source); it runs them on the CUDA cores in float32 for both types.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("res_chain")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_res_chain.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    lib.dfd_res_chain.restype = i32
    return lib


def res_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, H: int, W: int,
              layout: str = "channel_major",
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The probes' chain for every member (see the module docstring); returns
    a float32 tensor of x's shape and layout."""
    _check(x, w, b, H, W, layout, compute_dtype)
    if x.device.type == "cpu":
        return res_chain_plain(x, w, b, H, W, layout, compute_dtype)
    _expect(x.device.type == "cuda", f"x must lie on the CPU or a CUDA device, got {x.device}")
    for v in (x, w, b):
        _expect(v.device == x.device, f"every operand must lie on {x.device}, got {v.device}")
        _expect(v.dtype == torch.float32 and v.is_contiguous(),
                "every operand must be a contiguous float32 tensor")
    minor = layout == "channel_minor"
    P, J = w.shape[:2]
    C = x.shape[2] if minor else x.shape[1]
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if J > 1 else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_res_chain(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            P, J, C, H, W, int(minor), int(compute_dtype is not None), stream,
        ), "res_chain")
    res_chain.launches += 1
    return out


res_chain.launches = 0
