"""Hopper probe of in-kernel GEMM chains: the counterpart of ``tools/probe_pallas_gemm.py``.

    python -m dfd_tpu_torch.probes.gemm

The same ten calls as the TPU probe's ``main``: two large products (the
clock check), a chain-length sweep at 1024x144x16 (32, 256 and 1024 products
in one launch: fixed against proportional cost), the accumulate-free
``feed`` chain, and four padded or small shapes, each a
:func:`dfd_tpu_torch.ops.gemm_chain.gemm_chain` of ``iters`` products on
``RandomState(0)`` inputs scaled by 0.01.  Beside the kernel: its plain
version (``iters`` PyTorch products) and the library route, one ``torch.mm``
of the same multiply-adds (the operands repeated along the depth, so that one
cuBLAS call sums the ``iters`` products; ``feed``'s is ``a @ b``, the value
its chain ends on).  The plain version and the library route take full
float32 products (TF32 off); the kernel takes f32-accurate 3xTF32 ones on the
tensor cores.  Each row gives both bounds of the products, as 3xTF32 at
165 TFLOP/s (``bound_ms``) and on the CUDA cores at 67 (``cuda_core_bound_ms``),
the kernel's ratio to the library route and its launch plan.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dfd_tpu_torch.ops.gemm_chain import (gemm_chain, gemm_chain_plain, gemm_chain_plan,
                                          ordered_route)
from dfd_tpu_torch.probes import _common as c
from dfd_tpu_torch.utils.profiling import BYTES_RATE, F32_RATE, TF32X3_RATE

# (M, K, N, iters, mode): tools/probe_pallas_gemm.py::main, in its order
CASES = (
    (512, 512, 512, 128, "acc"),
    (512, 1024, 512, 128, "acc"),
    (1024, 144, 16, 32, "acc"),
    (1024, 144, 16, 256, "acc"),
    (1024, 144, 16, 1024, "acc"),
    (1024, 144, 16, 256, "feed"),
    (1024, 144, 128, 256, "acc"),
    (1024, 128, 128, 256, "acc"),
    (128, 128, 128, 256, "acc"),
    (8, 128, 128, 256, "acc"),
)


def chain_flops(M: int, K: int, N: int, iters: int, mode: str) -> float:
    """2 M K N a product, plus the chain's own element-wise work: the sum's
    adds (and scales), or feed's scaling of A."""
    per = {"acc": M * N, "acc_scaled": 2 * M * N, "feed": M * K}[mode]
    return float(iters) * (2 * M * K * N + per)


def chain_case(probe: str, case: str, a: torch.Tensor, b: torch.Tensor, iters: int, mode: str,
               dev: torch.device, n: int) -> dict:
    """One chain: the kernel against its plain version, the library route
    checked against the plain version too, and all three timed."""
    M, K = a.shape
    N = b.shape[1]
    if mode == "feed":
        library = lambda: torch.mm(a, b)
    else:
        a_rep = a.repeat(1, iters)
        b_rep = b.repeat(iters, 1)
        if mode == "acc_scaled":
            b_rep = b_rep * float(np.float32(1.0 / iters))
        library = lambda: torch.mm(a_rep, b_rep)
    plain = lambda: gemm_chain_plain(a, b, iters, mode)
    # the library route sums all iters * K products in one dot, in cuBLAS's
    # order (up to 147,456 terms), hence ten times the chains' tolerance
    c.check_match(f"{probe}: {case}: library route", library(), plain(), 10 * c.TOL_F32)
    return gemm_row(probe, case, lambda: gemm_chain(a, b, iters, mode), plain, library, M, K, N,
                    iters, chain_flops(M, K, N, iters, mode), dev, n, mode)


def gemm_row(probe: str, case: str, run, plain, library, M: int, K: int, N: int, iters: int,
             flops: float, dev: torch.device, n: int, mode: str = "acc") -> dict:
    """One ``gemm_chain`` case measured (``_common.measure``), with both
    bounds (3xTF32 first), the ratio to the library route and the plan."""
    nbytes = 4.0 * (M * K + K * N + M * N)
    row = c.measure(probe, case, "gemm_chain", run, plain, tol=c.TOL_F32, flops=flops,
                    rate=TF32X3_RATE, nbytes=nbytes, dev=dev, n=n, library=library)
    row["cuda_core_bound_ms"] = max(flops / F32_RATE, nbytes / BYTES_RATE) * 1e3
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["us_per_gemm"] = row["ms"] * 1e3 / iters
    row["tflops"] = 2.0 * M * K * N * iters / (row["ms"] * 1e-3) / 1e12
    p = gemm_chain_plan(M, K, N, ordered_route(iters, mode), resident=mode == "feed")
    row["plan"] = (f"{p.wm}x{p.wn}x{p.wk} warps of {p.mt}x{p.nt} m16n8 tiles, cluster "
                   f"{p.cluster}, {p.blocks} blocks" + (", ordered FMAs" if ordered_route(iters, mode) else ""))
    return row


def run(device=None, cases=CASES, n: int = 5) -> list:
    """Every case of ``cases`` ((M, K, N, iters, mode) tuples), ``n`` timed
    calls each."""
    dev = c.probe_device(device)
    rows = []
    for M, K, N, iters, mode in cases:
        rng = np.random.RandomState(0)
        a = torch.from_numpy(rng.randn(M, K).astype(np.float32) * 0.01).to(dev)
        b = torch.from_numpy(rng.randn(K, N).astype(np.float32) * 0.01).to(dev)
        rows.append(chain_case("gemm", f"[{mode}] [{M}x{K}]x[{K}x{N}] iters={iters}", a, b,
                               iters, mode, dev, n))
    return rows


def main() -> int:
    c.print_rows(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
