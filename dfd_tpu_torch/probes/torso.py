"""Hopper probe of a fused torso's building blocks: the counterpart of
``tools/probe_pallas_torso.py``.

    python -m dfd_tpu_torch.probes.torso

The TPU probe asked which relayouts Mosaic lowers inside a kernel and what a
conv-shaped product costs in either orientation.  Here every relayout is a
kernel of :mod:`dfd_tpu_torch.ops.relayout` on the probe's ``x [128, 1024]``
(``RandomState(0)``): rolls by 1 along either axis and by 64 along the last,
the strided slices ``x[::2, :]``, ``x[:, ::2]`` and ``x3[:, ::2, :]`` of
``x3 = x.view(128, 16, 64)``, the reshape copy to ``[128, 16, 64]`` and the
row concat ``[x, 2x, 3x]``; each is held bit-exact to its PyTorch expression,
which is also the library call timed beside it, but for the concat: its
PyTorch expression is ``torch.cat`` of three products, and its library call
is one broadcasting multiply (:func:`concat_library`).  The seven product
shapes (stage-0 and stage-1 res convs as im2col or split products, big dimension
in M or in N, and the 3-channel feature conv) run as
:func:`dfd_tpu_torch.ops.gemm_chain.gemm_chain` chains of 256 products
summed as ``acc + y / 256`` (mode ``acc_scaled``), on ``RandomState(0)``
inputs drawn in order.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dfd_tpu_torch.ops import relayout as rl
from dfd_tpu_torch.probes import _common as c
from dfd_tpu_torch.probes.gemm import chain_case
from dfd_tpu_torch.utils.profiling import F32_RATE

ITERS = 256
SCALES = (1.0, 2.0, 3.0)  # the concat's
# (name, M, K, N): tools/probe_pallas_torso.py::main's shapes, in its order
GEMM_SHAPES = (
    ("im2col M-major [1024,144]x[144,16]", 1024, 144, 16),
    ("im2col N-major [16,144]x[144,1024]", 16, 144, 1024),
    ("split  M-major [1024,48]x[48,48]", 1024, 48, 48),
    ("split  N-major [48,48]x[48,1024]", 48, 48, 1024),
    ("s1 im2col N-major [32,288]x[288,256]", 32, 288, 256),
    ("s1 split  N-major [96,96]x[96,256]", 96, 96, 256),
    ("feat0 im2col N-major [16,27]x[27,4096]", 16, 27, 4096),
)


def relayout_cases(x: torch.Tensor):
    """(name, kernel, kernel call, plain call, bytes) of the probe's eight
    relayouts of ``x [R, L]`` (L a multiple of 64)."""
    R, L = x.shape
    x3 = x.view(R, L // 64, 64)
    nb = 4.0 * x.numel()
    return (
        ("roll lanes (axis=1, shift=1)", rl.roll, lambda: rl.roll(x, 1, 1),
         lambda: rl.roll_plain(x, 1, 1), 2 * nb),
        ("roll sublanes (axis=0, shift=1)", rl.roll, lambda: rl.roll(x, 1, 0),
         lambda: rl.roll_plain(x, 1, 0), 2 * nb),
        ("roll lanes shift=64", rl.roll, lambda: rl.roll(x, 64, 1),
         lambda: rl.roll_plain(x, 64, 1), 2 * nb),
        ("strided slice sublanes x[::2, :]", rl.strided_copy, lambda: rl.strided_copy(x[::2, :]),
         lambda: rl.strided_copy_plain(x[::2, :]), nb),
        ("strided slice lanes x[:, ::2]", rl.strided_copy, lambda: rl.strided_copy(x[:, ::2]),
         lambda: rl.strided_copy_plain(x[:, ::2]), nb),
        ("strided slice mid dim of 3D x[:, ::2, :]", rl.strided_copy,
         lambda: rl.strided_copy(x3[:, ::2, :]), lambda: rl.strided_copy_plain(x3[:, ::2, :]),
         nb),
        (f"reshape [{R},{L}]->[{R},{L // 64},64] (split lanes)", rl.strided_copy,
         lambda: rl.strided_copy(x3), lambda: rl.strided_copy_plain(x3), 2 * nb),
        ("concat along sublanes x3", rl.concat_scaled, lambda: rl.concat_scaled(x, SCALES),
         lambda: rl.concat_scaled_plain(x, SCALES), 4 * nb),
    )


def concat_library(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One PyTorch call computing ``concat_scaled(x, scales)``: a
    broadcasting multiply by the float32 ``scales`` on x's device (each
    product rounded once, as the kernel's), its ``[k, *x.shape]`` result
    seen as ``[k * x.shape[0], *x.shape[1:]]``.  A yardstick only: the port
    never calls it."""
    k = scales.numel()
    return (x.unsqueeze(0) * scales.view(k, *[1] * x.ndim)).view(k * x.shape[0], *x.shape[1:])


def relayout_row(probe: str, name: str, kernel, run, plain, nbytes: float, dev, n: int,
                 library=None) -> dict:
    """One relayout case; its plain version is also its library call unless
    ``library`` is given."""
    return c.measure(probe, name, kernel.__name__, run, plain, tol=c.TOL_EXACT, flops=0.0,
                     rate=F32_RATE, nbytes=nbytes, dev=dev, n=n, library=library,
                     plain_is_library=library is None)


def run(device=None, rows: int = 128, cols: int = 1024, gemm_shapes=GEMM_SHAPES,
        iters: int = ITERS, n: int = 5) -> list:
    """The eight relayouts of ``x [rows, cols]`` and the product chains of
    ``gemm_shapes`` ((name, M, K, N) tuples, ``iters`` products each)."""
    dev = c.probe_device(device)
    x = torch.from_numpy(np.random.RandomState(0).randn(rows, cols).astype(np.float32)).to(dev)
    scales = torch.tensor(SCALES, dtype=torch.float32, device=dev)
    out = [relayout_row("torso", *case, dev=dev, n=n,
                        library=(lambda: concat_library(x, scales))
                        if case[1] is rl.concat_scaled else None)
           for case in relayout_cases(x)]
    rng = np.random.RandomState(0)
    for name, M, K, N in gemm_shapes:
        a = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.randn(K, N).astype(np.float32)).to(dev)
        out.append(chain_case("torso", f"[gemm] {name} iters={iters}", a, b, iters,
                              "acc_scaled", dev, n))
    return out


def main() -> int:
    c.print_rows(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
