"""The collectives of the population mesh, the counterpart of
``dfd_tpu.parallel.collectives``.

Two things cross ranks each epoch, both as one ``all_reduce`` sum:

- :func:`gather_members` (:func:`gather_results`): the per-member results
  (rewards, entropies, steps, novelty, sampled statistics), each rank
  writing its own rows of a
  zero-filled ``[P, k]`` buffer, so every rank ends with the whole
  population's, exactly (x + 0 = x).  A sum, not an ``all_gather``: it runs
  on NCCL, on gloo with CPU tensors and on gloo with CUDA tensors, which
  gloo's ``all_gather`` refuses;
- :func:`all_sum`: the partial combine g_r = sum over the rank's members of
  f_i sigma eps_i / ||sigma eps_i||^2, d floats, as
  :func:`shard_map_combine` spells it out.

On a mesh without a process group (a mesh of one) every collective returns
its input untouched; in a group of one rank they run, and sum one rank.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

from dfd_tpu_torch.core import welford
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.fd.combine import combine_gradient
from dfd_tpu_torch.parallel.mesh import PopMesh, pop_sharding


def all_sum(mesh: PopMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, in place; identical bits on
    every rank."""
    if mesh.group is None:
        return x
    if not mesh.timed:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
        return x
    # timed: the wait for the slowest rank (a barrier once x is ready here)
    # apart from the all-reduce itself
    sync = (lambda: torch.cuda.synchronize(x.device)) if x.device.type == "cuda" else (lambda: 0)
    sync()
    t0 = time.perf_counter()
    dist.barrier(group=mesh.group)
    t1 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    sync()
    mesh.wait_s += t1 - t0
    mesh.collective_s += time.perf_counter() - t1
    return x


def gather_members(mesh: PopMesh, rows: torch.Tensor, n: int) -> torch.Tensor:
    """The whole population's ``[n, ...]`` on every rank from each rank's
    own rows ``[n / W, ...]`` (the members :func:`pop_sharding` gives it):
    a zero-filled buffer with the rank's rows written in, summed over the
    ranks.  float32 rows only, so the sum is exact."""
    if mesh.group is None:
        return rows
    if rows.dtype != torch.float32:
        raise ValueError(f"gather_members sums float32 rows, got {rows.dtype}")
    mine = pop_sharding(mesh, n)
    full = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=torch.float32, device=rows.device)
    full[mine.start:mine.stop] = rows
    return all_sum(mesh, full)


def gather_results(mesh: PopMesh, table: torch.Tensor, stats, n: int):
    """The whole population's per-member scalars ``[n, k]`` and, where
    ``stats`` (a float32 ``WelfordState`` of this rank's rows) is given,
    sampled statistics on every rank, from this rank's rows: one
    :func:`gather_members` of the columns side by side.  ``stats`` None
    gives None."""
    rows, k = table.shape
    cols = [table]
    if stats is not None:
        cols += [stats.mean.reshape(rows, -1), stats.m2.reshape(rows, -1), stats.count[:, None]]
    full = gather_members(mesh, torch.cat(cols, dim=1), n)
    if stats is None:
        return full, None
    w = stats.mean[0].numel()
    shape = (n,) + tuple(stats.mean.shape[1:])
    return full[:, :k], welford.WelfordState(full[:, k:k + w].reshape(shape),
                                             full[:, k + w:k + 2 * w].reshape(shape),
                                             full[:, k + 2 * w].contiguous())


def shard_map_combine(noise: CounterNoise, mesh: PopMesh, epoch: int,
                      member_ids: Sequence[int], fitness: torch.Tensor, sigma: float,
                      axis: str = "pop") -> torch.Tensor:
    """g[d] summed over the ranks of each rank's combine over its own
    contiguous shard of ``member_ids`` (the eps regenerated by the port's
    noise path: ``normal_kernel`` on the card); only the d-vector crosses
    ranks.  ``fitness`` [P] is the whole population's, on every rank."""
    if axis != mesh.axis:
        raise ValueError(f"no mesh axis {axis!r} (the mesh's is {mesh.axis!r})")
    ids = [int(i) for i in member_ids]
    mine = pop_sharding(mesh, len(ids))
    eps = noise.generate_block(epoch, ids[mine.start:mine.stop])
    g = combine_gradient(eps, fitness[mine.start:mine.stop], sigma)
    return all_sum(mesh, g)
