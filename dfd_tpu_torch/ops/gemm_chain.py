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
shapes raise.  The products are float32-accurate on both: full float32 in
the plain version (the TPU probes ran float32 dots), three TF32 tensor-core
products of split operands in the kernel (3xTF32, about 22 of float32's 24
bits a product).  ``gemm_chain.launches`` counts kernel launches.

What bounds the kernel on an H100 is the products, 2·M·K·N·iters FLOPs at
495 / 3 = 165 TFLOP/s as 3xTF32 (67 on the CUDA cores), not the bytes (each
operand is read once).  :func:`gemm_chain_plan` chooses its tiles: each
block keeps its operand panels in shared memory, split into TF32 hi and lo
planes once, for the whole chain; its warps split K, and a cluster of blocks
splits K further where the panels would not fit a block.  A chain whose own
float32 sum cannot resolve products rounded otherwise than PyTorch's takes
the ordered route (:func:`ordered_route`).  See the CUDA source for the
products, the reductions and how ``feed``'s grid-wide dependency is carried.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from dfd_tpu_torch.ops import build

MODES = ("acc", "acc_scaled", "feed")
SMEM_MAX = 232_448   # bytes of shared memory an H100 block can use
NUM_SMS = 132        # an H100 SXM's streaming multiprocessors
# block shapes (warps along M, warps along N, m16 tiles a warp, n8 tiles a
# warp), largest first: the block's tile is 16 * WM * MT rows by 8 * WN * NT
# columns; the kernel is instantiated for each (MT, NT).  Each is the
# fastest for some probe shape (tools/torch_gemm_chain_sweep.py).
WARP_TILES = ((2, 2, 2, 4), (2, 2, 2, 2), (1, 1, 1, 4), (1, 1, 1, 2), (1, 1, 1, 1))
CLUSTERS = (1, 2, 4, 8)  # blocks that split K
WARP_K = (1, 2, 4, 8)    # warps of a block that split K (at most 8 warps a block)
ORDERED_LIMIT = 1e-5     # see ordered_route


class GemmChainPlan(NamedTuple):
    wm: int         # warps along M
    wn: int         # warps along N
    wk: int         # warps along K: the block's K slices, summed through shared memory
    mt: int         # m16 tiles a warp
    nt: int         # n8 tiles a warp
    cluster: int    # blocks a tile, each a slice of K, reduced through distributed smem
    ks: int         # K a block keeps: ceil(K / cluster) padded to 8
    blocks: int
    smem: int       # dynamic shared memory a block, bytes
    cost: int       # the model's cycles an iteration


def _plan_smem(bm: int, bn: int, ks: int, wk: int, cluster: int) -> int:
    """The A panel [bm, ks] and the B panel [ks, bn] as hi and lo TF32
    planes; the partials [bm, bn + 8] of the block's K slices past the first
    and, with a cluster, two buffers of the block's sum."""
    return 8 * (bm * ks + ks * bn) + (wk - 1 + (2 if cluster > 1 else 0)) * 4 * bm * (bn + 8)


def _plan_cost(M: int, N: int, wm: int, wn: int, wk: int, mt: int, nt: int, cluster: int,
               ks: int, smem: int, resident: bool):
    """The modelled cycles of one iteration (see :func:`gemm_chain_plan`),
    or None where a block does not fit an SM or, ``resident``, the blocks do
    not fit the card at once."""
    warps = wm * wn * wk
    per_sm = min(SMEM_MAX // max(smem, 1), 2048 // (64 + 16 * mt * nt) // warps, 64 // warps, 32)
    if per_sm == 0:
        return None
    blocks = -(-M // (16 * wm * mt)) * -(-N // (8 * wn * nt)) * cluster
    waves = -(-blocks // (NUM_SMS * per_sm))
    if resident and waves > 1:
        return None
    w_sm = warps * min(per_sm, -(-blocks // NUM_SMS))   # warps on a busy SM
    steps = -(-(ks // 8) // wk)                          # k8 steps a warp
    latency = steps * (40 + 40 * mt * nt)
    through = 3 * w_sm * steps * mt * nt
    fixed = 100 + (200 + 20 * (wk - 1) * mt * nt if wk > 1 else 0) + (800 if cluster > 1 else 0)
    return waves * (max(latency, through) + fixed)


def ordered_route(iters: int, mode: str) -> bool:
    """Whether a chain takes the ordered route: its products as FMAs in k
    order on the CUDA cores, not 3xTF32 on the tensor cores.

    The float32 sum of ``iters`` equal products rounds each add by up to half
    an ulp of the running sum, the same way while the sum stays in a binade:
    up to ``iters * 2**-25`` of the result, in the plain version as in the
    kernel.  Products one ulp apart can round those adds the other way at
    every step, so past ``ORDERED_LIMIT`` (the probes' limit, 1e-5 of the
    scale) a chain holds its plain version only with products rounded as
    PyTorch's are (cuBLAS's sequential FMAs at the probes' narrow shapes):
    the gemm probe's 1024-product chain.  ``feed`` sums nothing."""
    return mode != "feed" and iters * 2.0 ** -25 > ORDERED_LIMIT


@functools.lru_cache(maxsize=None)
def gemm_chain_plan(M: int, K: int, N: int, ordered: bool = False,
                    resident: bool = False) -> GemmChainPlan:
    """The launch plan of ``gemm_chain_kernel`` for a [M, K] x [K, N] chain:
    over every block shape of ``WARP_TILES``, K split of ``WARP_K`` and
    cluster of ``CLUSTERS`` whose panels fit a block's shared memory, the
    least modelled time of one iteration (the first such on a tie).

    The model (:func:`_plan_cost`), in cycles: a warp's k8 step takes
    40 + 40 MT NT cycles of latency alone, and an SM's warps share 3 MT NT
    cycles a step of its tensor cores; an SM holds as many blocks as its
    shared memory, registers (64 + 16 MT NT a thread, assumed) and threads
    allow, and the blocks run in waves over the 132 SMs; an iteration adds
    100 cycles, a K split 200 + 20 (wk - 1) MT NT and a cluster's reduction
    800.  The constants were fitted to every plan timed at the probes'
    shapes on an H100 80GB HBM3 (``tools/torch_gemm_chain_sweep.py``), where
    its choice came within 7 % of the fastest.  The ordered route (:func:`ordered_route`)
    takes one m16 x n8 tile a block, no K split and no cluster; ``resident``
    (``feed``'s cooperative launch) keeps every block on the card at once.
    The CUDA entry point computes the same plan and refuses another."""
    if M <= 0 or N <= 0 or K < 0:
        raise ValueError(f"gemm_chain needs M, N > 0 and K >= 0, got {M}, {K}, {N}")
    best = None
    for cluster in CLUSTERS[:1] if ordered else CLUSTERS:
        ks = (-(-K // cluster) + 7) // 8 * 8
        for wm, wn, mt, nt in WARP_TILES[-1:] if ordered else WARP_TILES:
            for wk in (1,) if ordered else WARP_K:
                if wm * wn * wk > 8 or (wk > 1 and wk > ks // 8):
                    break
                smem = _plan_smem(16 * wm * mt, 8 * wn * nt, ks, wk, cluster)
                cost = _plan_cost(M, N, wm, wn, wk, mt, nt, cluster, ks, smem, resident)
                if cost is None or smem > SMEM_MAX:
                    continue
                if best is None or cost < best.cost:
                    blocks = -(-M // (16 * wm * mt)) * -(-N // (8 * wn * nt)) * cluster
                    best = GemmChainPlan(wm, wn, wk, mt, nt, cluster, ks, blocks, smem, cost)
    if best is None:
        raise ValueError(f"gemm_chain's panels of [{M}, {K}] x [{K}, {N}] do not fit in "
                         f"{SMEM_MAX} bytes of shared memory on a cluster of up to "
                         f"{CLUSTERS[-1]} blocks" + (", all blocks resident at once" if resident else ""))
    return best


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
    lib.dfd_gemm_chain.argtypes = [vp] * 4 + [i32] * 5 + [ctypes.c_float] + [i32] * 8 + [vp]
    lib.dfd_gemm_chain.restype = i32
    return lib


def gemm_chain(a: torch.Tensor, b: torch.Tensor, iters: int, mode: str = "acc") -> torch.Tensor:
    """``iters`` chained products of a [M, K] and b [K, N] (see the module
    docstring for the modes) -> [M, N] float32."""
    _check(a, b, iters, mode)
    # what the kernel needs, checked on any device so that the CPU refuses
    # what the card does, the plan included
    for name, v in (("a", a), ("b", b)):
        if v.device.type not in ("cpu", "cuda") or v.device != a.device:
            raise ValueError(f"{name} must lie on the CPU or on the CUDA device of a, "
                             f"got {v.device}")
        if v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    M, K = a.shape
    N = b.shape[1]
    ordered = ordered_route(iters, mode)
    plan = gemm_chain_plan(M, K, N, ordered, resident=mode == "feed")
    if a.device.type == "cpu":
        return gemm_chain_plain(a, b, iters, mode)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    carry = torch.empty(2, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.raise_on(_kernels().dfd_gemm_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), carry.data_ptr(), M, K, N, iters,
            MODES.index(mode), _inv(iters), plan.wm, plan.wn, plan.wk, plan.mt, plan.nt,
            plan.cluster, plan.ks, int(ordered), stream,
        ), "gemm_chain")
    gemm_chain.launches += 1
    return out


gemm_chain.launches = 0
