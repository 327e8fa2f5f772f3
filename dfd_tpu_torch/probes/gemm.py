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
its chain ends on).  Products are full float32 everywhere (no TF32).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dfd_tpu_torch.ops.gemm_chain import gemm_chain, gemm_chain_plain
from dfd_tpu_torch.probes import _common as c
from dfd_tpu_torch.utils.profiling import F32_RATE

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
    row = c.measure(probe, case, "gemm_chain", lambda: gemm_chain(a, b, iters, mode), plain,
                    tol=c.TOL_F32, flops=chain_flops(M, K, N, iters, mode), rate=F32_RATE,
                    nbytes=4.0 * (M * K + K * N + M * N), dev=dev, n=n, library=library)
    row["us_per_gemm"] = row["ms"] * 1e3 / iters
    row["tflops"] = 2.0 * M * K * N * iters / (row["ms"] * 1e-3) / 1e12
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
