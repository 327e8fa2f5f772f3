"""JAX's counter-keyed standard normal on the card: ``normal_kernel``.

Not a Pallas kernel: this replaces XLA's ``jax.random.normal`` in
``dfd_tpu/core/noise.py::CounterNoise.generate`` (the trainer's default
``noise_backend="jax"``), which draws member i's noise as
``normal(fold_in(fold_in(key(seed), epoch), i), (d,))``.  The JAX package
materializes eps [P, d] (2.0 GB at ``impala_prod_bf16``'s P = 64,
d = 7,872,651), so the port does too, in one kernel that writes eps and,
where asked, the perturbed rows theta + sigma * eps beside it.

The function, JAX 0.9.0's ``_normal_real`` with ``jax_threefry_partitionable``
on, element j of a draw with key (k1, k2):

- bits = b1 ^ b2 of ``threefry2x32((k1, k2), (j >> 32, j & 0xFFFFFFFF))``;
- u = max(lo, f * 2 + lo), f the float of ``(bits >> 9) | 0x3F800000``
  minus 1, lo = nextafter(-1, 0): ``uniform(lo, 1)``, whose ``hi - lo``
  rounds to 2 in float32 (the product is exact, so XLA's fused multiply-add
  and two roundings agree);
- eps = sqrt(2) * erf_inv(u), erf_inv as XLA lowers it in float32:
  w = -log1p(u * -u); t = w - 2.5 where w < 5, else sqrt(w) - 3; Giles'
  9-coefficient polynomial in t by Horner's rule, each step one fused
  multiply-add as XLA contracts it on the CPU; times u; u * inf where
  |u| == 1.

The perturbed rows are ``fma(sigma, eps, theta)``, as XLA contracts
``theta + sigma * eps``.

Antithetic pairs: members 2k and 2k + 1 share draw k with signs + and -,
so one draw feeds two rows and each normal is computed once.  A block of
rows starting at an odd member begins with the odd half of a pair
(``odd_first``).

:func:`normal` runs the CUDA kernel (``csrc/noise.cu``) on a CUDA tensor
and the plain PyTorch version on a CPU one; ``normal.launches`` counts its
launches.  :func:`normal_plain` computes the hash in int64 arithmetic
masked to 32 bits and each fused multiply-add exactly (float64, rounded to
odd, then to float32), a few rows at a time so its intermediates stay
small; ``log1p`` and ``sqrt`` are PyTorch's, on the card the same CUDA
library functions the kernel calls, so the two agree bit for bit there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dfd_tpu_torch.ops import build

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# erf_inv's coefficients, highest first, for w < 5 and for w >= 5, as the
# float32 constants of XLA's lowering (jax.lax.erf_inv compiled on the CPU)
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
PLAIN_ELEMENTS = 1 << 24  # elements of a row block of normal_plain's int64 intermediates


def draw_count(rows: int, antithetic: bool, odd_first: bool) -> int:
    """Draws (keys) that ``rows`` consecutive members take."""
    if not antithetic:
        return rows
    return (rows + int(odd_first) + 1) // 2 if rows else 0


def _threefry(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + k1) & _MASK, (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = (((b << r) & _MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum is rounded to odd there (its exact
    error from TwoSum), and rounding that to float32 is the correct
    rounding of the exact result."""
    p = a.double() * b.double() if torch.is_tensor(b) else a.double() * float(b)
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _uniform_bits(keys: torch.Tensor, d: int) -> torch.Tensor:
    """The uint32 bits (as int64) of ``d`` elements of each draw in
    ``keys`` ([n, 2] int32 holding uint32 words)."""
    k = keys.to(torch.int64) & _MASK
    j = torch.arange(d, dtype=torch.int64, device=keys.device)
    b1, b2 = _threefry(k[:, :1], k[:, 1:], (j >> 32)[None], (j & _MASK)[None])
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u in [nextafter(-1, 0), 1) from the bits, as ``jax.random.uniform``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * 2.0 + LO, LO)


def erf_inv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv in XLA's operation order (see the module docstring)."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, ERFINV_SMALL[i], ERFINV_LARGE[i]).to(torch.float32)
    p = coef(0)
    for i in range(1, len(ERFINV_SMALL)):
        p = fma32(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal_plain(keys: torch.Tensor, rows: int, d: int, antithetic: bool = False,
                 odd_first: bool = False) -> torch.Tensor:
    """eps [rows, d] float32 of ``rows`` consecutive members from their
    draws' ``keys`` [n, 2] (int32 holding the uint32 words), on keys'
    device."""
    draws = draw_count(rows, antithetic, odd_first)
    out = torch.empty((draws, d), dtype=torch.float32, device=keys.device)
    step = max(1, PLAIN_ELEMENTS // max(d, 1))
    for r0 in range(0, draws, step):
        u = uniform_from_bits(_uniform_bits(keys[r0:r0 + step], d))
        out[r0:r0 + step] = erf_inv_xla(u) * SQRT2
    if not antithetic:
        return out
    member = torch.arange(rows, device=keys.device) + int(odd_first)
    sign = torch.where(member % 2 == 0, 1.0, -1.0).to(torch.float32)[:, None]
    return out[member // 2] * sign


def perturbed_plain(eps: torch.Tensor, theta: torch.Tensor, sigma: float) -> torch.Tensor:
    """theta + sigma * eps [rows, d] with one rounding, as XLA contracts it."""
    return fma32(eps, float(np.float32(sigma)), theta[None, :].expand_as(eps))


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("noise")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dfd_normal.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, ctypes.c_float, vp]
    lib.dfd_normal.restype = i32
    return lib


def _check(keys, rows, d, antithetic, odd_first, theta, eps) -> bool:
    """Checks what the kernel needs on any device, so that the CPU refuses
    what the card does; then whether the operands lie on the CPU."""
    draws = draw_count(rows, antithetic, odd_first)
    if keys.dtype != torch.int32 or tuple(keys.shape) != (draws, 2) or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous int32 [{draws}, 2] tensor for {rows} rows, "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if rows < 0 or d < 0:
        raise ValueError(f"rows and d must be >= 0, got rows={rows}, d={d}")
    if odd_first and not antithetic:
        raise ValueError("odd_first pairs rows: it needs antithetic")
    if theta is None and not eps:
        raise ValueError("nothing to write: pass theta or eps=True")
    if theta is not None and (theta.dtype != torch.float32 or tuple(theta.shape) != (d,)
                              or not theta.is_contiguous() or theta.device != keys.device):
        raise ValueError(f"theta must be a contiguous float32 [{d}] tensor on {keys.device}")
    if keys.device.type == "cpu":
        return True
    if keys.device.type != "cuda":
        raise ValueError(f"keys must lie on the CPU or a CUDA device, got {keys.device}")
    return False


def normal(keys: torch.Tensor, rows: int, d: int, *, antithetic: bool = False,
           odd_first: bool = False, theta: Optional[torch.Tensor] = None, sigma: float = 0.0,
           eps: bool = True, theta_row: bool = False
           ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(eps [rows, d] or None, perturbed [rows + theta_row, d] or None) of
    ``rows`` consecutive members from their draws' ``keys``.

    ``eps`` asks for the noise; ``theta`` for the perturbed rows
    ``theta + sigma * eps`` in the same pass, with ``theta`` itself as one
    more last row where ``theta_row`` (the eval slot the population rollout
    carries).  One launch a call, none when there is nothing to compute."""
    on_cpu = _check(keys, rows, d, antithetic, odd_first, theta, eps)
    if on_cpu:
        e = normal_plain(keys, rows, d, antithetic, odd_first)
        pert = None
        if theta is not None:
            pert = perturbed_plain(e, theta, sigma)
            if theta_row:
                pert = torch.cat([pert, theta[None]])
        return (e if eps else None), pert
    dev = keys.device
    e = torch.empty((rows, d), dtype=torch.float32, device=dev) if eps else None
    pert = None
    if theta is not None:
        pert = torch.empty((rows + int(theta_row), d), dtype=torch.float32, device=dev)
        if theta_row:
            pert[rows] = theta
    if rows == 0 or d == 0:
        return e, pert
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_normal(
            keys.data_ptr(), ptr(theta), ptr(e), ptr(pert), d, rows, keys.shape[0],
            int(antithetic), int(odd_first), float(sigma), stream,
        ), "normal")
    normal.launches += 1
    return e, pert


normal.launches = 0
