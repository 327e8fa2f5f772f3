"""The perturbation noise of ``noise_backend="jax"``, written out plainly.

Member i's noise in an epoch is ``jax.random.normal(fold_in(fold_in(key(seed),
epoch), i), (d,))`` with ``jax_threefry_partitionable`` on: element j takes
the bits ``b1 ^ b2`` of ``threefry2x32(key, (j >> 32, j & 0xFFFFFFFF))``, a
uniform ``u = max(lo, f * 2 + lo)`` in [nextafter(-1, 0), 1) from their high
23 bits, and ``sqrt(2) * erfinv(u)``.  Here the hash runs in int32 torch
arithmetic, whose sums wrap as uint32's do, and ``erfinv`` in float64,
rounded once to float32; the program's kernel evaluates XLA's float32
polynomial, so the two agree to a float32 rounding or two.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.procmaze import fold_in

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
BLOCK_ELEMENTS = 1 << 26  # elements of one block of int32 intermediates


def member_keys(seed: int, epoch: int, members: np.ndarray) -> np.ndarray:
    """uint32 key words [n, 2] of ``members`` in ``epoch``."""
    base = np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)
    epoch_key = fold_in(base, np.uint32(epoch & _MASK))
    return fold_in(epoch_key, np.asarray(members, np.int64).astype(np.uint32))


def _rotl(b: torch.Tensor, r: int) -> torch.Tensor:
    """b rotated left by r as 32 bits, in int32 (its right shift is signed)."""
    return (b << r) | ((b >> (32 - r)) & ((1 << r) - 1))


def _threefry(k1, k2, x1, x2):
    """threefry2x32 on int32 tensors holding uint32 bits (sums wrap)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = x1 + k1, x2 + k2
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + (i + 1)
    return a, b


def normal(keys: np.ndarray, d: int, device) -> torch.Tensor:
    """float32 [n, d]: the normals of each key in ``keys`` [n, 2]."""
    if d >= 1 << 31:
        raise ValueError("the counters' high word is taken as 0: d must be below 2**31")
    k = torch.as_tensor(np.ascontiguousarray(keys, np.uint32).view(np.int32), device=device)
    out = torch.empty((k.shape[0], d), dtype=torch.float32, device=device)
    cols = max(1, min(d, BLOCK_ELEMENTS))
    for c0 in range(0, d, cols):
        j = torch.arange(c0, min(d, c0 + cols), dtype=torch.int32, device=device)[None]
        rows = max(1, BLOCK_ELEMENTS // j.numel())
        for r0 in range(0, k.shape[0], rows):
            kk = k[r0:r0 + rows]
            b1, b2 = _threefry(kk[:, :1], kk[:, 1:], torch.zeros_like(j), j)
            f = ((((b1 ^ b2) >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
            u = torch.clamp_min(f * 2.0 + _LO, _LO).double()
            out[r0:r0 + rows, c0:c0 + j.shape[1]] = (math.sqrt(2.0) * torch.erfinv(u)).float()
    return out
