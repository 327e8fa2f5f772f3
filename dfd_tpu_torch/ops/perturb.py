"""Counter-hash perturbation kernels: perturb and combine.

Replaces the Pallas TPU kernels ``dfd_tpu/ops/perturb.py::pallas_perturb``
(``_perturb_call`` -> ``_perturb_kernel``, noise from ``_noise_tile``) and
``::pallas_combine`` (``_combine_call`` -> ``_combine_kernel``).  Both
regenerate the population noise eps[i, j] from an integer hash of
(seed, epoch, member, chunk_idx, lane) at chunk = 1024 plus Box-Muller, so
eps is never stored:

- :func:`perturb`: theta_i = theta + sigma * eps_i -> [P, d];
- :func:`combine`: g = sum_i coef_i * eps_i -> [d].

Both take ``first``, the member that row (or coefficient) 0 stands for, so
a rank of a mesh perturbs and combines its own shard of the population
alone (members ``first .. first + P - 1``; even under ``antithetic``).

Each wrapper runs its CUDA kernel (``csrc/perturb.cu``) on a CUDA tensor and
its plain PyTorch version (:func:`perturb_plain`, :func:`combine_plain`) on a
CPU tensor; any other device raises.  ``launches`` on each wrapper counts
calls; each call launches one kernel.

What bounds them on an H100: perturb, the bytes (it writes P * d floats:
2.0 GB at ``impala_prod_bf16``'s P = 64, d = 7,872,651, 0.61 ms at 3.35
TB/s, against about 36 operations an element); combine, the operations (P
normals for each of its d outputs, only P + d floats moved).  The kernels
keep eps out of device memory entirely and compute each (member, chunk) key
once a block, not once an element.  Perturb's threads own 4 columns of a
chunk each and loop over a slice of the members, so theta is read once a
slice, and store each row as aligned float4s (a row that starts off a
16-byte boundary is stored shifted by up to 3 columns, its ends element by
element).  Combine's threads own 4 lanes each; where the lanes alone give
too few blocks (``mlp_trap``'s d = 5197), the members are split over groups
of a block's threads and over a cluster of blocks (:func:`combine_plan`),
and the partial sums are added in a fixed order (groups, then ranks), so two
calls give the same bits; antithetic pairs stage ``c[2m] - c[2m + 1]`` and
compute each draw's normal once.  See ``csrc/perturb.cu``.
||eps_i||^2 is a torch reduction over the rounded outputs outside the kernel
(:func:`noise_sumsq`), as in the JAX package.

The plain versions run the hash in int64 masked to 32 bits: the low 32 bits
of a wrapped int64 product are exact, so the bits equal the uint32 stream.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from dfd_tpu_torch.ops import build

CHUNK = 1024  # the stream's lane period (dfd_tpu.ops.perturb.DEFAULT_CHUNK)
_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MUL1 = 0x85EBCA6B
_MUL2 = 0xC2B2AE35


def _fmix32(x):
    """murmur3 32-bit finalizer on int64 tensors (or ints) holding uint32."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _MUL2) & _MASK
    return x ^ (x >> 16)


def _key_base(base_seed: int, epoch: int) -> int:
    return _fmix32((((base_seed & _MASK) * _GOLDEN) & _MASK) ^ (epoch & _MASK))


def noise_bits(base_seed: int, epoch: int, P: int, d: int, antithetic: bool = False,
               device="cpu", first: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uint32 hash draws behind eps of members first .. first + P -
    1, as int64 [P, d] tensors."""
    rows = torch.arange(first, first + P, dtype=torch.int64, device=device)
    members = rows // 2 if antithetic else rows
    j = torch.arange(d, dtype=torch.int64, device=device)
    chunks = torch.arange((d + CHUNK - 1) // CHUNK, dtype=torch.int64, device=device)
    key = _fmix32(_key_base(base_seed, epoch) ^ ((members * _MUL1) & _MASK))
    key = _fmix32(key[:, None] ^ ((chunks * _MUL2) & _MASK)[None, :])  # [P, n_chunks]
    mix = ((j % CHUNK) * _GOLDEN & _MASK)[None, :] ^ key[:, j // CHUNK]
    return _fmix32(mix ^ 0x1234567), _fmix32(mix ^ 0x89ABCDE)


def noise_plain(base_seed: int, epoch: int, P: int, d: int, antithetic: bool = False,
                device="cpu", first: int = 0) -> torch.Tensor:
    """eps [P, d] float32 of members first .. first + P - 1: Box-Muller over
    :func:`noise_bits`, in the JAX package's operation order."""
    b1, b2 = noise_bits(base_seed, epoch, P, d, antithetic, device, first)
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-7
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    if antithetic:
        rows = torch.arange(P, device=device)
        z = z * torch.where(rows % 2 == 0, 1.0, -1.0).to(torch.float32)[:, None]
    return z


def perturb_plain(flat: torch.Tensor, sigma: float, base_seed: int, epoch: int, P: int,
                  antithetic: bool = False, first: int = 0) -> torch.Tensor:
    eps = noise_plain(base_seed, epoch, P, flat.shape[0], antithetic, flat.device, first)
    return flat[None, :] + sigma * eps


def combine_plain(coefs: torch.Tensor, base_seed: int, epoch: int, d: int,
                  antithetic: bool = False, first: int = 0) -> torch.Tensor:
    eps = noise_plain(base_seed, epoch, coefs.shape[0], d, antithetic, coefs.device, first)
    return coefs @ eps


COMBINE_THREADS = 256
COMBINE_RESIDENT = 132 * 8  # blocks in flight: eight an SM of the H100's 132
MIN_PER_GROUP = 4


@functools.lru_cache(maxsize=None)
def combine_plan(P: int, d: int, antithetic: bool = False) -> Tuple[int, int, int]:
    """(lt, mg, cl) of ``combine_kernel``: ``lt`` threads own 4 lanes each
    of a tile of ``4 * lt`` lanes, ``mg = 256 // lt`` groups of them split
    the block's members (draws: pairs under antithetic), and a cluster of
    ``cl`` blocks a tile splits them further.  From one group of 256
    threads, each step halves lt (down to 16), then doubles cl (up to 8),
    while each group keeps ``MIN_PER_GROUP`` draws and the grid has fewer
    than eight waves of ``COMBINE_RESIDENT`` blocks; the plan kept is the one
    whose last wave is least empty (the fewest waves a block)."""
    draws = (P + 1) // 2 if antithetic else P
    blocks = lambda q: -(-d // (4 * q[0])) * q[2]
    waves = lambda q: -(-blocks(q) // COMBINE_RESIDENT)
    p = best = (COMBINE_THREADS, 1, 1)
    while blocks(p) < 8 * COMBINE_RESIDENT and p[1] * p[2] * 2 * MIN_PER_GROUP <= draws:
        lt, mg, cl = p
        if lt > 16:
            p = (lt // 2, mg * 2, cl)
        elif cl < 8:
            p = (lt, mg, cl * 2)
        else:
            break
        if waves(p) * blocks(best) < waves(best) * blocks(p):
            best = p
    return best


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.load("perturb")
    vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.dfd_perturb.argtypes = [vp, vp, i32, i32, ctypes.c_float, u32, u32, i32, vp]
    lib.dfd_perturb.restype = i32
    lib.dfd_combine.argtypes = [vp, vp, i32, i32, u32, u32, i32, i32, i32, i32, vp]
    lib.dfd_combine.restype = i32
    lib.dfd_perturb_from.argtypes = [vp, vp, i32, i32, ctypes.c_float, u32, u32, i32, u32, vp]
    lib.dfd_perturb_from.restype = i32
    lib.dfd_combine_from.argtypes = [vp, vp, i32, i32, u32, u32, i32, u32, i32, i32, i32, vp]
    lib.dfd_combine_from.restype = i32
    return lib


def _first_draw(first: int, antithetic: bool) -> int:
    """The stream's draw of member ``first``: the member, or its pair."""
    if first < 0 or (antithetic and first % 2):
        raise ValueError(f"first must be >= 0 (and even under antithetic), got {first}")
    return first // 2 if antithetic else first


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """Checks what the kernels need of ``t`` on any device, so that the CPU
    refuses what the card does; then whether ``t`` lies on the CPU (else it
    must lie on a CUDA device)."""
    if t.dtype != torch.float32 or t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D float32 tensor")
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the CPU or a CUDA device, got {t.device}")
    return False


def perturb(flat: torch.Tensor, sigma: float, base_seed: int, epoch: int, P: int,
            antithetic: bool = False, first: int = 0) -> torch.Tensor:
    """theta_i = theta + sigma * eps_i for the P members from ``first`` ->
    [P, d], with eps regenerated in the kernel."""
    draw = _first_draw(first, antithetic)
    if _on_cpu("flat", flat):
        return perturb_plain(flat, sigma, base_seed, epoch, P, antithetic, first)
    d = flat.shape[0]
    out = torch.empty((P, d), dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_perturb_from(
            flat.data_ptr(), out.data_ptr(), P, d, float(sigma),
            int(base_seed) & _MASK, int(epoch) & _MASK, int(antithetic), draw & _MASK, stream,
        ), "perturb")
    perturb.launches += 1
    return out


perturb.launches = 0


def noise_sumsq(perturbed: torch.Tensor, flat: torch.Tensor, sigma: float) -> torch.Tensor:
    """||eps_i||^2 [P] from the rounded perturbed rows, as the JAX package
    takes it (``((out - theta)^2).sum() / sigma^2``)."""
    diff = perturbed - flat[None, :]
    return (diff * diff).sum(dim=1) / (sigma * sigma)


def combine(coefs: torch.Tensor, base_seed: int, epoch: int, d: int,
            antithetic: bool = False, first: int = 0) -> torch.Tensor:
    """g[d] = sum_i coefs[i] * eps(first + i)[d], regenerating eps in the
    kernel (one launch a call, summed in a fixed order: two calls on the
    same inputs give the same bits).

    For the FD estimator pass ``coefs = fitness / (sigma * noise_sumsq)``."""
    draw = _first_draw(first, antithetic)
    if _on_cpu("coefs", coefs):
        return combine_plain(coefs, base_seed, epoch, d, antithetic, first)
    g = torch.empty((d,), dtype=torch.float32, device=coefs.device)
    with torch.cuda.device(coefs.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_combine_from(
            coefs.data_ptr(), g.data_ptr(), coefs.shape[0], d,
            int(base_seed) & _MASK, int(epoch) & _MASK, int(antithetic), draw & _MASK,
            *combine_plan(coefs.shape[0], d, bool(antithetic)), stream,
        ), "combine")
    combine.launches += 1
    return g


combine.launches = 0
