"""Unrolled dense solvers for tiny SPD systems, over leading batch axes.

The counterpart of ``dfd_tpu.ops.smallsolve``: a Cholesky factorization and
two triangular substitutions unrolled over the (small, static) dimension n,
every step an elementwise op over the batch, in the JAX package's order of
operations.  This is the solver of the swimmer's plain step
(``ops/swimmer.py::swimmer_step_plain``); the card runs the same solve
inside ``swimmer_step_kernel``, one episode a thread.

Intended for n <= ~16 (the unrolled op count grows as n^2).
"""

from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A [..., n, n]``, column by column."""
    n = A.shape[-1]
    cols = []  # cols[j] = full column j of L, rows < j zeroed
    for j in range(n):
        r = A[..., :, j]
        for k in range(j):
            r = r - cols[k] * cols[k][..., j:j + 1]
        diag = torch.sqrt(r[..., j:j + 1])
        col = r / diag
        col = torch.cat([torch.zeros_like(col[..., :j]), col[..., j:]], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def solve_triangular_lower_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L y = b`` for lower-triangular L [..., n, n], b [..., n]."""
    n = L.shape[-1]
    ys = []
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[..., i, k] * ys[k]
        ys.append(acc / L[..., i, i])
    return torch.stack(ys, dim=-1)


def solve_triangular_upper_unrolled(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``U x = b`` for upper-triangular U [..., n, n], b [..., n]."""
    n = U.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = b[..., i]
        for k in range(i + 1, n):
            acc = acc - U[..., i, k] * xs[k]
        xs[i] = acc / U[..., i, i]
    return torch.stack(xs, dim=-1)


def spd_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for SPD ``A [..., n, n]``, ``b [..., n]``: the unrolled
    Cholesky and the two unrolled substitutions."""
    L = cholesky_unrolled(A)
    y = solve_triangular_lower_unrolled(L, b)
    return solve_triangular_upper_unrolled(L.transpose(-1, -2), y)
