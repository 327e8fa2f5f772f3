"""The population mesh over ``torch.distributed``, the counterpart of
``dfd_tpu.parallel.mesh``.

JAX shards the population over a 1-D ``Mesh(("pop",))`` of every chip:
parameters are replicated, and the only traffic in the steady state is the
O(d) reduction of the fitness-weighted combine.  The port follows
PyTorch's idiom instead: one process per card, joined by a process group
(NCCL between cards, gloo on the CPU), every rank running the same host
code on the same seeds.  A rank holds the contiguous members ``[r P / W,
(r + 1) P / W)`` of a population of P (:func:`pop_sharding`); because the
noise is counter-keyed (``core/noise.py``), each rank regenerates its own
members' perturbations, and what crosses ranks is each epoch's per-member
results and the partial combine (``parallel/collectives.py``).

Without an initialized process group a mesh is a mesh of one: rank 0 of 1,
and every collective is the identity, so a trainer on it equals one
without a mesh bit for bit; in a process group of one rank the collectives
run and sum that rank's alone, exactly.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from dfd_tpu_torch.core.device import resolve_device


class PopMesh:
    """One rank's view of the population axis: its process group (None for
    a mesh of one), rank, world size and device.  Where ``timed`` is set,
    each collective synchronises the device before and after and waits at a
    barrier first: ``wait_s`` accumulates the seconds at the barriers (the
    wait for the slowest rank), ``collective_s`` those of the collectives
    themselves."""

    def __init__(self, device, group=None, rank: int = 0, size: int = 1, axis: str = "pop"):
        self.device = torch.device(device)
        self.group = group
        self.rank, self.size = int(rank), int(size)
        self.axis = axis
        self.shape = {axis: self.size}  # as a JAX mesh's
        self.timed = False
        self.wait_s = self.collective_s = 0.0

    def __repr__(self) -> str:
        return f"PopMesh({self.axis}: rank {self.rank} of {self.size} on {self.device})"


def make_pop_mesh(devices: Union[None, str, torch.device] = None,
                  axis: str = "pop") -> PopMesh:
    """This process's mesh over the default process group, a mesh of one
    where none is initialized.  ``devices``: this rank's device, None for
    the card ``cuda:{LOCAL_RANK}`` (``"cpu"`` where the caller asks)."""
    device = resolve_device(f"cuda:{os.environ.get('LOCAL_RANK', '0')}" if devices is None
                            else devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return PopMesh(device, axis=axis)
    group = dist.group.WORLD
    return PopMesh(device, group, dist.get_rank(group), dist.get_world_size(group), axis)


def pop_sharding(mesh: PopMesh, n: int) -> range:
    """The members of a population of ``n`` that ``mesh``'s rank holds:
    ``[r n / W, (r + 1) n / W)``; ``n`` must divide evenly."""
    if n % mesh.size != 0:
        raise ValueError(f"the population ({n}) must divide over the mesh's {mesh.size} ranks")
    per = n // mesh.size
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: PopMesh, n: int) -> range:
    """Every member of a population of ``n``: what each rank holds of a
    replicated tensor."""
    return range(n)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda", backend: Optional[str] = None) -> None:
    """Join a process group of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port``) as rank ``process_id``: NCCL
    where ``device`` is a card, gloo on the CPU, unless ``backend`` says
    (gloo also carries CUDA tensors, for ranks that share one card, which
    NCCL refuses).  A no-op at one process or fewer, as the JAX package's
    ``jax.distributed.initialize`` call is."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
