"""Fitness and the fitness-weighted gradient combine (reference
finite_differences.py:40-49, networking/server.py:75-95).

    g = sum_i f_i * (sigma eps_i) / || sigma eps_i ||^2

The trainer's ``noise_backend="pallas"`` path regenerates eps inside the
combine kernel (:func:`dfd_tpu_torch.ops.perturb.combine`);
:func:`combine_gradient` is the dense form over a materialized eps (the
default ``noise_backend="jax"``), a GEMV left to PyTorch as the JAX package
leaves its einsum to XLA, and :func:`combine_gradient_chunked` its
memory-bounded form under population chunking.
"""

from __future__ import annotations

import torch

from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.ops.standardize import population_std, standardize


def fitness_from_rewards(rewards: torch.Tensor, baseline, tie_signs: torch.Tensor) -> torch.Tensor:
    """Baseline-subtract + standardize, with the reference's tie-break.

    An all-equal batch would hit the std == 0 passthrough; the reference
    jiggles each reward by +-1e-12 so it standardizes to random signs
    (reference worker/agent.py:68-69).  As in the JAX package the fitness of
    an exactly constant batch IS the random +-1 signs, which the caller
    draws (``tie_signs``, shape of ``rewards``)."""
    shifted = rewards - baseline
    std = population_std(shifted)
    return torch.where(std == 0, tie_signs, standardize(shifted))


def combine_gradient(eps: torch.Tensor, fitness: torch.Tensor, sigma: float) -> torch.Tensor:
    """g[d] = sum_i fitness_i * (sigma eps_i) / ||sigma eps_i||^2  from
    materialized noise eps [P, d]."""
    sq = torch.sum(eps * eps, dim=-1) * (sigma * sigma)
    w = fitness * sigma / torch.clamp_min(sq, 1e-30)
    return w @ eps


def combine_gradient_chunked(noise: CounterNoise, epoch: int, member_ids, fitness: torch.Tensor,
                             sigma: float, chunk: int) -> torch.Tensor:
    """Memory-bounded combine: regenerates eps ``chunk`` members at a time
    (one ``normal_kernel`` launch each) and adds each chunk's
    :func:`combine_gradient` in chunk order, so only chunk x d of noise is
    ever live.  ``member_ids`` are consecutive."""
    ids = [int(i) for i in member_ids]
    P = len(ids)
    if chunk < 1 or P % chunk != 0:
        raise ValueError(f"population_chunk must divide the population: {P} % {chunk} != 0")
    g = torch.zeros(noise.n_params, dtype=torch.float32, device=fitness.device)
    for c in range(0, P, chunk):
        eps = noise.generate_block(epoch, ids[c:c + chunk])
        g = g + combine_gradient(eps, fitness[c:c + chunk], sigma)
    return g
