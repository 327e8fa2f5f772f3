"""Environment interface for the batched rollout engine.

A :class:`TorchEnv` steps a whole population of episodes at once: ``reset``
and ``step`` are side-effect-free maps over an explicit state tuple whose
tensors carry a leading population axis ``[M]`` on the env's device.  This
is the counterpart of ``dfd_tpu.envs.base.JaxEnv``, whose single-episode
functions the JAX package vmaps.
"""

from __future__ import annotations

import abc
from typing import Any, Tuple

import torch

EnvState = Any  # a tuple of [M, ...] tensors


class TorchEnv(abc.ABC):
    """Stateless, population-batched environment definition."""

    #: shape of one observation
    obs_shape: Tuple[int, ...]
    #: number of discrete actions, or None for continuous
    n_actions: int | None = None
    #: natural episode length cap for this env (used as the rollout horizon)
    max_episode_steps: int = 1000
    #: number of levels a reset draws from (1 for envs without levels)
    num_levels: int = 1
    #: device the env's tensors live on
    device: torch.device

    @property
    def discrete(self) -> bool:
        return self.n_actions is not None

    @abc.abstractmethod
    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Start ``n`` episodes; returns (state, first observations [n, *obs]).

        ``reset_level`` [n] int64 holds each episode's level draw in
        ``[0, num_levels)``; envs without levels ignore it."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Advance every episode one step; returns (state, obs, reward, done)."""
