"""Hopper probe of the stride-2 pool subsample and the 16-channel fused chain:
the counterpart of ``tools/probe_pallas_pool.py``.

    python -m dfd_tpu_torch.probes.pool

The pool keeps the even (y, x) positions of a channel-major ``[C, H*W]``
buffer.  The TPU probe's candidates, on its ``x [16, 4096]``
(``RandomState(0)``, 64x64 positions), each a kernel here:

- A: a column gather by the even positions' int32 indices
  (:func:`dfd_tpu_torch.ops.relayout.gather_cols`);
- B: ``lax.slice`` with stride 2 on the last axis, ``x[:, ::2]``
  (:func:`~dfd_tpu_torch.ops.relayout.strided_copy`);
- C: a transpose, ``[16, 4096]`` and ``[48, 1024]`` (``RandomState(1)``)
  (:func:`~dfd_tpu_torch.ops.relayout.transpose`);
- D: a Sel-GEMM, ``x @ Sel`` with Sel the 0/1 ``[4096, 1024]`` selection
  matrix (:func:`~dfd_tpu_torch.ops.gemm_chain.gemm_chain`, one product).

A and D are also held to ``x[:, idx]`` through their plain versions.  Then
the fused 4x residual-conv chain at 16 channels, 32x32, P = 64
(``RandomState(2)``), as the TPU probe ran it: channel-major f32,
channel-minor f32 and bf16, each beside the lowered patches route (see
:mod:`dfd_tpu_torch.probes.wide`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dfd_tpu_torch.ops import relayout as rl
from dfd_tpu_torch.ops.gemm_chain import gemm_chain, gemm_chain_plain
from dfd_tpu_torch.probes import _common as c
from dfd_tpu_torch.probes.gemm import gemm_row
from dfd_tpu_torch.probes.torso import relayout_row
from dfd_tpu_torch.probes.wide import chain_rows

# the chains the TPU probe ran: (tag, layout, compute dtype)
CHAINS = (("f32", "channel_major", None), ("f32", "channel_minor", None),
          ("bf16", "channel_minor", torch.bfloat16))


def even_positions(H: int, W: int) -> np.ndarray:
    """Flat indices of the even (y, x) positions of an H x W image, int32."""
    yy, xx = np.meshgrid(np.arange(0, H, 2), np.arange(0, W, 2), indexing="ij")
    return (yy * W + xx).reshape(-1).astype(np.int32)


def run(device=None, C: int = 16, H: int = 64, W: int = 64, P: int = 64, Cs: int = 16,
        Hs: int = 32, Ws: int = 32, n: int = 20) -> list:
    """Candidates A-D on ``x [C, H*W]`` and the three chains at ``P``
    members of ``Cs`` channels, ``Hs`` x ``Ws``."""
    dev = c.probe_device(device)
    S = H * W
    x = torch.from_numpy(np.random.RandomState(0).randn(C, S).astype(np.float32)).to(dev)
    idx_np = even_positions(H, W)
    idx = torch.from_numpy(idx_np).to(dev)
    want = x[:, idx.long()]
    xt = torch.from_numpy(np.random.RandomState(1).randn(48, 1024).astype(np.float32)).to(dev)
    sel_np = np.zeros((S, S // 4), np.float32)
    sel_np[idx_np, np.arange(S // 4)] = 1.0
    sel = torch.from_numpy(sel_np).to(dev)
    nb = 4.0 * x.numel()
    rows = [
        relayout_row("pool", "A column gather (jnp.take lanes)", rl.gather_cols,
                     lambda: rl.gather_cols(x, idx), lambda: rl.gather_cols_plain(x, idx),
                     nb / 2 + 4.0 * idx.numel(), dev, n),
        relayout_row("pool", "B lax.slice stride-2 lanes", rl.strided_copy,
                     lambda: rl.strided_copy(x[:, ::2]), lambda: rl.strided_copy_plain(x[:, ::2]),
                     nb, dev, n),
        relayout_row("pool", f"C transpose [{C},{S}]->[{S},{C}]", rl.transpose,
                     lambda: rl.transpose(x), lambda: rl.transpose_plain(x), 2 * nb, dev, n),
        relayout_row("pool", "C2 transpose [48,1024]->[1024,48]", rl.transpose,
                     lambda: rl.transpose(xt), lambda: rl.transpose_plain(xt),
                     8.0 * xt.numel(), dev, n),
        gemm_row("pool", f"D Sel-GEMM [{C},{S}]x[{S},{S // 4}]", lambda: gemm_chain(x, sel, 1),
                 lambda: gemm_chain_plain(x, sel, 1), lambda: torch.mm(x, sel), C, S, S // 4, 1,
                 2.0 * C * S * (S // 4), dev, n),
    ]
    # A and D keep exactly the even positions (their kernels equal these)
    c.check_match("pool: A against x[:, idx]", rl.gather_cols_plain(x, idx), want, c.TOL_EXACT)
    c.check_match("pool: D against x[:, idx]", gemm_chain_plain(x, sel, 1), want, c.TOL_F32)

    rng = np.random.RandomState(2)
    xs = torch.from_numpy(rng.randn(P, Cs, Hs * Ws).astype(np.float32) * 0.1).to(dev)
    ws = torch.from_numpy(rng.randn(P, 4, Cs, Cs * 9).astype(np.float32) * 0.05).to(dev)
    bs = torch.from_numpy(rng.randn(P, 4, Cs).astype(np.float32) * 0.01).to(dev)
    return rows + chain_rows("pool", xs, ws, bs, Hs, Ws, CHAINS, dev, n)


def main() -> int:
    c.print_rows(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
