"""Data-movement kernels: roll, strided copy, column gather, transpose, scaled concat.

Replaces the Pallas TPU probe kernels of ``tools/probe_pallas_torso.py::main``
(``roll_lanes``, ``roll_sublanes``, ``roll_lanes64``, ``sub_sublane``,
``sub_lane``, ``sub_mid``, ``reshape_split_lanes``, ``concat_sublanes``) and
``tools/probe_pallas_pool.py::main`` (``k_take``, ``k_slice``, ``k_transpose``),
the relayouts a fused IMPALA torso needs (tap shifts, the stride-2 pool
subsample, layout changes):

- :func:`roll`: ``torch.roll`` of a 2-D tensor along one axis;
- :func:`strided_copy`: a contiguous copy of a strided view of up to three
  axes, such as ``x[::2, :]``, ``x[:, ::2]``, ``x3[:, ::2, :]`` or
  ``x.view(128, 16, 64)``.  A contiguous reshape is a view in PyTorch; it is
  still copied here, as the TPU kernel copies it;
- :func:`gather_cols`: ``x[:, idx]`` by an int32 index vector;
- :func:`transpose`: ``x.t()`` made contiguous;
- :func:`concat_scaled`: ``torch.cat([x * s for s in scales], 0)``.

Each wrapper runs its CUDA kernel (``csrc/relayout.cu``) on a CUDA tensor and
its plain PyTorch version (``*_plain``, which is also the PyTorch library call
for the same function) on a CPU tensor; other devices, dtypes or shapes raise.
Every output is bit-exact against the plain version.  ``launches`` on each
wrapper counts kernel launches.  What bounds them on an H100 is bytes: each
input read once and each output written once, at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from dfd_tpu_torch.ops import build

MAX_SCALES = 8


# -- plain PyTorch versions ------------------------------------------------------------


def roll_plain(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(x, shift, axis)


def strided_copy_plain(view: torch.Tensor) -> torch.Tensor:
    return view.clone(memory_format=torch.contiguous_format)


def gather_cols_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(1, idx)


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def concat_scaled_plain(x: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    return torch.cat([x * float(s) for s in scales], 0)


# -- the kernels -----------------------------------------------------------------------


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check_cuda(x: torch.Tensor, contiguous: bool = True) -> None:
    _expect(x.device.type == "cuda", f"x must lie on the CPU or a CUDA device, got {x.device}")
    _expect(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _expect(not contiguous or x.is_contiguous(), "x must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("relayout")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
        ("dfd_roll", [vp, vp, i64, i64, i64, i32, vp]),
        ("dfd_strided_copy", [vp, vp] + [i64] * 6 + [vp]),
        ("dfd_gather_cols", [vp, vp, vp, i64, i64, i64, vp]),
        ("dfd_transpose", [vp, vp, i32, i32, vp]),
        ("dfd_concat_scaled", [vp, vp, i64, vp, i32, vp]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    return lib


def _launch(x: torch.Tensor, name: str, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(getattr(_kernels(), name)(*args, stream), name)


def roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """``torch.roll(x, shift, axis)`` of a 2-D float32 x."""
    _expect(x.ndim == 2 and axis in (0, 1, -1, -2), f"a 2-D x and axis 0 or 1 expected, got "
                                                    f"{tuple(x.shape)} and {axis}")
    if x.device.type == "cpu":
        return roll_plain(x, shift, axis)
    _check_cuda(x)
    axis %= 2
    out = torch.empty_like(x)
    rows, cols = x.shape
    _launch(x, "dfd_roll", x.data_ptr(), out.data_ptr(), rows, cols, shift % x.shape[axis], axis)
    roll.launches += 1
    return out


def strided_copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``view``, a strided view (1 to 3 axes) of a
    float32 tensor: ``view.clone(memory_format=torch.contiguous_format)``."""
    _expect(1 <= view.ndim <= 3, f"a view of 1 to 3 axes expected, got {tuple(view.shape)}")
    if view.device.type == "cpu":
        return strided_copy_plain(view)
    _check_cuda(view, contiguous=False)
    out = torch.empty(view.shape, dtype=torch.float32, device=view.device)
    if out.numel() == 0:
        return out
    pad = 3 - view.ndim
    sizes = (1,) * pad + tuple(view.shape)
    strides = (0,) * pad + tuple(view.stride())
    _launch(view, "dfd_strided_copy", view.data_ptr(), out.data_ptr(), *sizes, *strides)
    strided_copy.launches += 1
    return out


def gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]`` of a 2-D float32 x by a 1-D int32 ``idx``.  On the card
    an index outside ``[0, x.shape[1])`` gives NaN (the plain version raises)."""
    _expect(x.ndim == 2 and idx.ndim == 1, f"x [R, C] and idx [n] expected, got "
                                           f"{tuple(x.shape)} and {tuple(idx.shape)}")
    _expect(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return gather_cols_plain(x, idx)
    _check_cuda(x)
    _expect(idx.device == x.device and idx.is_contiguous(),
            f"idx must be contiguous and lie on {x.device}, got {idx.device}")
    out = torch.empty((x.shape[0], idx.shape[0]), dtype=torch.float32, device=x.device)
    _launch(x, "dfd_gather_cols", x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], idx.shape[0])
    gather_cols.launches += 1
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x.t().contiguous()`` of a 2-D float32 x."""
    _expect(x.ndim == 2, f"a 2-D x expected, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return transpose_plain(x)
    _check_cuda(x)
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=torch.float32, device=x.device)
    _launch(x, "dfd_transpose", x.data_ptr(), out.data_ptr(), rows, cols)
    transpose.launches += 1
    return out


def concat_scaled(x: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    """``torch.cat([x * s for s in scales], 0)``, at most 8 scales."""
    _expect(1 <= len(scales) <= MAX_SCALES, f"1 to {MAX_SCALES} scales expected, "
                                            f"got {len(scales)}")
    _expect(x.ndim >= 1, "x must have at least one axis")
    if x.device.type == "cpu":
        return concat_scaled_plain(x, scales)
    _check_cuda(x)
    out = torch.empty((len(scales) * x.shape[0], *x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    host = (ctypes.c_float * len(scales))(*(float(s) for s in scales))
    _launch(x, "dfd_concat_scaled", x.data_ptr(), out.data_ptr(), x.numel(), host, len(scales))
    concat_scaled.launches += 1
    return out


KERNELS = (roll, strided_copy, gather_cols, transpose, concat_scaled)
for _fn in KERNELS:
    _fn.launches = 0
