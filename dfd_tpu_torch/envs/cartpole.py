"""CartPole (gymnasium CartPole-v1 semantics), batched over the population.

The same env as ``dfd_tpu.envs.cartpole.CartPoleEnv``: two discrete
actions push the cart left or right; reward 1 a step; ``done`` when the
cart or the pole leaves its limits, or on step 500.  A reset draws the four
state variables uniform in [-0.05, 0.05) (``reset_shape = (4,)``); the JAX
env draws them as one ``uniform(key, (4,), -0.05, 0.05)``, which
:meth:`CartPoleEnv.reset_draw` reproduces on the host.  Plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5  # half pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
RESET_RANGE = 0.05


class CartPoleState(NamedTuple):
    x: torch.Tensor          # [N]
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor          # [N] int64


class CartPoleEnv(TorchEnv):
    n_actions = 2
    obs_shape = (4,)
    max_episode_steps = 500
    reset_shape = (4,)

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def sample_reset(self, shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
        """Reset draws [*shape, 4] float32 uniform in [-0.05, 0.05)."""
        u = torch.rand(tuple(shape) + (4,), generator=generator, device=generator.device)
        return u * (2 * RESET_RANGE) - RESET_RANGE

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        """The JAX env's (x, x_dot, theta, theta_dot) [..., 4] under each reset key."""
        return _levels.uniform(np.asarray(keys, np.uint32), (4,), -RESET_RANGE, RESET_RANGE)

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[CartPoleState, torch.Tensor]:
        """``reset_level`` [n, 4]: each episode's start state."""
        draw = reset_level.to(device=self.device, dtype=torch.float32)
        if tuple(draw.shape) != (n, 4):
            raise ValueError(f"reset_level must have shape ({n}, 4), got {tuple(draw.shape)}")
        state = CartPoleState(*draw.unbind(1), torch.zeros(n, dtype=torch.int64,
                                                           device=self.device))
        return state, self._obs(state)

    def step(self, state: CartPoleState, action: torch.Tensor):
        force = torch.where(action.reshape(-1) == 1, FORCE_MAG, -FORCE_MAG)
        cos_t = torch.cos(state.theta)
        sin_t = torch.sin(state.theta)
        temp = (force + POLEMASS_LENGTH * state.theta_dot ** 2 * sin_t) / TOTAL_MASS
        theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * cos_t ** 2 / TOTAL_MASS))
        x_acc = temp - POLEMASS_LENGTH * theta_acc * cos_t / TOTAL_MASS
        new = CartPoleState(
            x=state.x + TAU * state.x_dot,
            x_dot=state.x_dot + TAU * x_acc,
            theta=state.theta + TAU * state.theta_dot,
            theta_dot=state.theta_dot + TAU * theta_acc,
            t=state.t + 1,
        )
        done = (new.x.abs() > X_LIMIT) | (new.theta.abs() > THETA_LIMIT) | (
            new.t >= self.max_episode_steps)
        reward = torch.ones_like(new.x)
        return new, self._obs(new), reward, done

    def _obs(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)
