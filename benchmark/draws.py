"""Every random number an epoch consumes, made by the benchmark from the seed.

The trainer takes its draws from a ``draw_source(epoch)``; the benchmark
hands it this one, and the reference the same, so both sides roll out the
same episodes.  Epoch k's draws come from a ``torch.Generator`` on the
device seeded from (seed, k) alone, in the shapes and distributions of the
trainer's own ``make_draws``: Gumbel noise [P + 1, E, T, A] for each
sampled action, the uniforms [P + 1, E, T] of the sampled observation
statistics, the tie signs [P], zeta's permutation [Z] and each episode's
level [P + 1, E]; the evaluation slot, row P, repeats its episode 0.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def epoch_seed(seed: int, epoch: int) -> int:
    """A 63-bit generator seed of (seed, epoch)."""
    return (seed * _GOLDEN + epoch * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def source(seed: int, P: int, E: int, T: int, Z: int, n_actions: int, num_levels: int,
           device) -> Callable[[int], Tuple[torch.Tensor, ...]]:
    """``epoch -> (gumbel, stats_uniform, tie_signs, zeta_perm, levels)``."""
    device = torch.device(device)

    def draws(epoch: int):
        gen = torch.Generator(device=device)
        gen.manual_seed(epoch_seed(seed, epoch))
        u = torch.rand((P + 1, E, T, n_actions), generator=gen, device=device)
        gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
        stats = torch.rand((P + 1, E, T), generator=gen, device=device)
        ties = (2 * torch.randint(0, 2, (P,), generator=gen, device=device) - 1).to(torch.float32)
        perm = torch.randperm(Z, generator=gen, device=device)
        levels = torch.randint(0, num_levels, (P + 1, E), generator=gen, device=device)
        for x in (gumbel, stats, levels):
            x[P] = x[P, :1]
        return gumbel, stats, ties, perm, levels

    return draws
