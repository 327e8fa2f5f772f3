"""Environment interface for the batched rollout engine.

A :class:`TorchEnv` steps a whole population of episodes at once: ``reset``
and ``step`` are side-effect-free maps over an explicit state tuple whose
tensors carry a leading population axis ``[M]`` on the env's device.  This
is the counterpart of ``dfd_tpu.envs.base.JaxEnv``, whose single-episode
functions the JAX package vmaps.

A JAX env draws its reset from a key; a port env takes that draw as an
argument.  Each env declares the trailing shape of one reset draw
(``reset_shape``: ``()`` for a level id, ``(4,)`` for PixelGrid's agent and
goal cells or CartPole's start state, ``(2 * ndof - 2,)`` for the swimmer's
angles and velocities), draws it from a ``torch.Generator``
(``sample_reset``, the trainer's own draws: int64 cells or levels, float32
uniforms for the physics envs) and computes the JAX env's own draw from its
reset key on the host (``reset_draw``, for the eval panel's fixed levels and
the parity tests).
"""

from __future__ import annotations

import abc
from typing import Any, Tuple

import numpy as np
import torch

from dfd_tpu_torch.envs import _levels

EnvState = Any  # a tuple of [M, ...] tensors


class TorchEnv(abc.ABC):
    """Stateless, population-batched environment definition."""

    #: shape of one observation
    obs_shape: Tuple[int, ...]
    #: number of discrete actions, or None for continuous
    n_actions: int | None = None
    #: dimension of a continuous action, or None for discrete
    action_dim: int | None = None
    #: natural episode length cap for this env (used as the rollout horizon)
    max_episode_steps: int = 1000
    #: number of levels a reset draws from (1 for envs without levels)
    num_levels: int = 1
    #: trailing shape of one reset draw
    reset_shape: Tuple[int, ...] = ()
    #: device the env's tensors live on
    device: torch.device

    @property
    def discrete(self) -> bool:
        return self.n_actions is not None

    @property
    def action_width(self) -> int:
        """The width of one action's draws: ``n_actions`` Gumbel draws for a
        discrete env, ``action_dim`` normals for a continuous one."""
        return self.n_actions if self.discrete else self.action_dim

    @property
    def reset_high(self) -> int:
        """Exclusive upper bound of each reset draw's integers: the level count."""
        return self.num_levels

    def sample_reset(self, shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
        """Reset draws [*shape, *reset_shape] from ``generator``, on its
        device: by default int64 in ``[0, reset_high)``; an env whose reset
        draws floats (the physics envs) overrides this."""
        return torch.randint(0, self.reset_high, tuple(shape) + tuple(self.reset_shape),
                             generator=generator, device=generator.device)

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        """The JAX env's reset draw under each reset key (key words [..., 2]
        uint32): [..., *reset_shape], int64 or float32 as ``sample_reset``
        draws; by default its level draw ``randint(key, (), 0, num_levels)``
        (0 for envs without levels)."""
        return _levels.randint(np.asarray(keys, np.uint32), (), 0, self.num_levels)

    @abc.abstractmethod
    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Start ``n`` episodes; returns (state, first observations [n, *obs]).

        ``reset_level`` [n, *reset_shape] holds each episode's reset draw
        (by default its level in ``[0, num_levels)``); envs without levels or
        start states ignore it."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Advance every episode one step; returns (state, obs, reward, done)."""
