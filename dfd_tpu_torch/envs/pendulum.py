"""Pendulum (gymnasium Pendulum-v1 dynamics), batched over the population.

The same env as ``dfd_tpu.envs.pendulum.PendulumEnv``: the continuous
proving ground for the Gaussian MLP policy.  One action in [-1, 1] scaled to
the torque range; reward the negative cost of angle, speed and torque;
``done`` on step 200.  A reset draws the angle in [-pi, pi) and the angular
speed in [-1, 1) (``reset_shape = (2,)``); the JAX env draws them as two
scalar uniforms under ``split(key)``, which :meth:`PendulumEnv.reset_draw`
reproduces on the host.  Plain PyTorch: a step is a few elementwise ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


class PendulumState(NamedTuple):
    theta: torch.Tensor      # [N]
    theta_dot: torch.Tensor  # [N]
    t: torch.Tensor          # [N] int64


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """((x + pi) mod 2 pi) - pi, the modulus floored as ``jnp.remainder``
    takes it: the truncated remainder, moved by 2 pi where its sign differs."""
    y = x + math.pi
    r = torch.fmod(y, 2 * math.pi)
    r = torch.where(r < 0, r + 2 * math.pi, r)
    return r - math.pi


class PendulumEnv(TorchEnv):
    n_actions = None
    action_dim = 1
    obs_shape = (3,)
    max_episode_steps = 200
    reset_shape = (2,)

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def sample_reset(self, shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
        """Reset draws [*shape, 2] float32: the angle uniform in [-pi, pi),
        the speed in [-1, 1)."""
        u = torch.rand(tuple(shape) + (2,), generator=generator, device=generator.device)
        scale = torch.tensor([2 * math.pi, 2.0], device=generator.device)
        return u * scale - scale / 2

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        """The JAX env's (angle, speed) [..., 2] under each reset key."""
        k = _levels.split(np.asarray(keys, np.uint32), 2)
        theta = _levels.uniform(k[..., 0, :], (), -math.pi, math.pi)
        theta_dot = _levels.uniform(k[..., 1, :], (), -1.0, 1.0)
        return np.stack([theta, theta_dot], axis=-1)

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[PendulumState, torch.Tensor]:
        """``reset_level`` [n, 2]: each episode's angle and angular speed."""
        draw = reset_level.to(device=self.device, dtype=torch.float32)
        if tuple(draw.shape) != (n, 2):
            raise ValueError(f"reset_level must have shape ({n}, 2), got {tuple(draw.shape)}")
        state = PendulumState(draw[:, 0], draw[:, 1],
                              torch.zeros(n, dtype=torch.int64, device=self.device))
        return state, self._obs(state)

    def step(self, state: PendulumState, action: torch.Tensor):
        u = torch.clamp(action.reshape(-1).to(torch.float32) * MAX_TORQUE, -MAX_TORQUE, MAX_TORQUE)
        th = _angle_normalize(state.theta)
        cost = th ** 2 + 0.1 * state.theta_dot ** 2 + 0.001 * u ** 2
        new_dot = state.theta_dot + (3 * G / (2 * L) * torch.sin(state.theta)
                                     + 3.0 / (M * L ** 2) * u) * DT
        new_dot = torch.clamp(new_dot, -MAX_SPEED, MAX_SPEED)
        new_theta = state.theta + new_dot * DT
        new = PendulumState(new_theta, new_dot, state.t + 1)
        done = new.t >= self.max_episode_steps
        return new, self._obs(new), -cost, done

    def _obs(self, s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)
