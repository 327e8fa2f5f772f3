"""Level curricula over procedural environments (a copy of
``dfd_tpu.utils.curriculum``, which needs no JAX).

procgen-style training often starts on a few levels and widens the
distribution as the policy gains competence (the ``num_levels`` /
``start_level`` contract of reference utils/init_helper.py:9-12).  Narrow
early distributions turn the population's fitness differences from level
luck back into signal.

:func:`train_level_curriculum` drives a :class:`VectorizedTrainer` through
level phases, swapping the environment between phases with
``trainer.set_env(env.with_levels(...))``; parameters, BN statistics, omega,
observation statistics, zeta and the strategy archive carry across phases.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def train_level_curriculum(
    trainer,
    phases: Sequence[Tuple[int, int]],
    start_level: Optional[int] = None,
    fast: bool = True,
    sync_every: int = 10,
) -> None:
    """Train through ``phases`` = [(n_epochs, num_levels), ...].

    The trainer's env must implement ``with_levels(num_levels, start_level)``
    (e.g. :class:`~dfd_tpu_torch.envs.procmaze.ProcMazeEnv`).  The first
    phase also swaps the env if its level count differs from the env's
    current one.
    """
    for n_epochs, num_levels in phases:
        env = trainer.env
        if num_levels != env.num_levels or (
            start_level is not None and start_level != env.start_level
        ):
            trainer.set_env(env.with_levels(num_levels=num_levels, start_level=start_level))
        if fast:
            trainer.train_fast(n_epochs, sync_every=min(sync_every, n_epochs))
        else:
            trainer.train(n_epochs)
