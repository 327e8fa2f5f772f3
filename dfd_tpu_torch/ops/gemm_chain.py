"""Chains of dependent float32 matrix products in one kernel launch.

Replaces the Pallas TPU probe kernels ``tools/probe_pallas_gemm.py::gemm_chain``
(``k_acc``, ``k_feed``), ``tools/probe_pallas_torso.py::gemm_chain`` (``k``) and
the Sel-GEMM (``k_sel``) of ``tools/probe_pallas_pool.py``: ``iters`` products
of ``a [M, K]`` by ``b [K, N]`` inside one launch, the question being what a
product costs inside a chain (fixed against proportional cost):

- ``"acc"``: the sum of the ``iters`` products, in iteration order;
- ``"acc_scaled"``: the sum of each product times ``1 / iters`` (as float32),
  the torso probe's variant;
- ``"feed"``: ``y <- (a * (1 + y[0, 0] * 1e-20)) @ b`` from ``y = 0``, the
  last product returned.  ``1 + y * 1e-20`` rounds to 1 in float32 for any
  ``|y| < 6e12``, so the result equals ``a @ b`` at every shape the probes
  use; both versions still apply the scale.

:func:`gemm_chain` runs the CUDA kernel (``csrc/gemm_chain.cu``) on CUDA
tensors and :func:`gemm_chain_plain` on CPU tensors; other devices, dtypes or
shapes raise.  The products are full float32 on both (the TPU probes ran
float32 dots at the TPU's default precision, bf16 passes; no TF32 here).
``gemm_chain.launches`` counts kernel launches.

What bounds the kernel on an H100 is the FMAs, 2·M·K·N·iters FLOPs at 67
TFLOP/s, not the bytes (each operand is read once); see the CUDA source for
the tiling and for how ``feed``'s grid-wide dependency is carried.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dfd_tpu_torch.ops import build

MODES = ("acc", "acc_scaled", "feed")


def _inv(iters: int) -> float:
    """1 / iters rounded once to float32, as the probes' f32 ``1.0 / ITER``."""
    return float(np.float32(1.0 / iters))


def gemm_chain_plain(a: torch.Tensor, b: torch.Tensor, iters: int, mode: str = "acc"):
    """The chain as ``iters`` PyTorch products, summed in iteration order."""
    if mode == "feed":
        y = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
        for _ in range(iters):
            y = (a * (1.0 + y[0, 0] * 1e-20)) @ b
        return y
    inv = _inv(iters)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for _ in range(iters):
        y = a @ b
        acc = acc + (y * inv if mode == "acc_scaled" else y)
    return acc


def _check(a: torch.Tensor, b: torch.Tensor, iters: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a [M, K] and b [K, N] expected, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if a.shape[0] == 0 or b.shape[1] == 0:
        raise ValueError(f"M and N must be > 0, got {a.shape[0]} and {b.shape[1]}")


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("gemm_chain")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dfd_gemm_chain.argtypes = [vp] * 4 + [i32] * 5 + [ctypes.c_float, vp]
    lib.dfd_gemm_chain.restype = i32
    return lib


def gemm_chain(a: torch.Tensor, b: torch.Tensor, iters: int, mode: str = "acc") -> torch.Tensor:
    """``iters`` chained products of a [M, K] and b [K, N] (see the module
    docstring for the modes) -> [M, N] float32."""
    _check(a, b, iters, mode)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_chain_plain(a, b, iters, mode)
    for name, v in (("a", a), ("b", b)):
        if v.device.type != "cuda" or v.device != a.device:
            raise ValueError(f"{name} must lie on the CPU or on the CUDA device of a, "
                             f"got {v.device}")
        if v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    carry = torch.empty(2, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_gemm_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, iters,
            MODES.index(mode), _inv(iters), stream,
        ), "gemm_chain")
    gemm_chain.launches += 1
    return out


gemm_chain.launches = 0
