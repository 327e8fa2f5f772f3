"""Pixel grid world, batched over the population.

The same env as ``dfd_tpu.envs.pixelgrid.PixelGridEnv`` (see its module
docstring): an agent and a goal on a G x G grid, rendered to C x (G*S) x
(G*S) frames (channel 0 the agent, 1 the goal, 2 the grid's border, each at
``intensity``; more channels are zero).  5 actions (stay/up/down/left/right)
move the agent, clipped to the grid; the reward is the L1 progress towards
the goal plus 10 on reaching it, which ends the episode, as does step
``max_steps``.

A reset draws four integers in ``[0, grid)``: the agent's row and column and
the goal's (``reset_shape = (4,)``); the JAX env draws them as
``randint(ka, (2,), 0, grid)`` and ``randint(kg, (2,), 0, grid)`` with
``ka, kg = split(key)``, which :meth:`PixelGridEnv.reset_draw` reproduces
on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv


class PixelGridState(NamedTuple):
    agent: torch.Tensor  # [M, 2] int64 row, col
    goal: torch.Tensor   # [M, 2] int64
    t: torch.Tensor      # [M] int64


class PixelGridEnv(TorchEnv):
    n_actions = 5
    reset_shape = (4,)

    def __init__(
        self,
        grid: int = 8,
        scale: int = 8,
        channels: int = 3,
        max_steps: int = 40,
        intensity: float = 255.0,
        device=None,
    ):
        """``intensity``: the value of an active cell (IMPALA reads raw
        0-255 frames; the Atari CNN expects 0-1 frames: pass 1.0)."""
        self.device = resolve_device(device)
        self.grid = grid
        self.scale = scale
        self.channels = channels
        self.max_episode_steps = max_steps
        self.intensity = float(intensity)
        self.obs_shape = (channels, grid * scale, grid * scale)
        cells = torch.arange(grid * scale, device=self.device) // scale
        self._rows, self._cols = cells[:, None], cells[None, :]
        border = (self._rows == 0) | (self._rows == grid - 1) | (self._cols == 0) | (
            self._cols == grid - 1)
        self._border = border.to(torch.float32) * self.intensity

    @property
    def reset_high(self) -> int:
        return self.grid

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        """(agent row, col, goal row, col) [..., 4] under each reset key."""
        ka_kg = _levels.split(np.asarray(keys, np.uint32), 2)
        agent = _levels.randint(ka_kg[..., 0, :], (2,), 0, self.grid)
        goal = _levels.randint(ka_kg[..., 1, :], (2,), 0, self.grid)
        return np.concatenate([agent, goal], axis=-1)

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[PixelGridState, torch.Tensor]:
        """``reset_level`` [n, 4]: each episode's agent and goal cells."""
        draw = reset_level.to(device=self.device, dtype=torch.int64)
        if draw.shape != (n, 4):
            raise ValueError(f"reset_level must have shape ({n}, 4), got {tuple(draw.shape)}")
        state = PixelGridState(agent=draw[:, :2], goal=draw[:, 2:],
                               t=torch.zeros(n, dtype=torch.int64, device=self.device))
        return state, self._render(state)

    def step(self, state: PixelGridState, action: torch.Tensor):
        a = action.to(torch.int64)
        dr = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        dc = torch.where(a == 3, -1, torch.where(a == 4, 1, 0))
        new_agent = torch.clamp(state.agent + torch.stack([dr, dc], dim=-1), 0, self.grid - 1)

        dist_old = (state.agent - state.goal).abs().sum(dim=-1)
        dist_new = (new_agent - state.goal).abs().sum(dim=-1)
        reached = dist_new == 0
        reward = (dist_old - dist_new).to(torch.float32) + 10.0 * reached.to(torch.float32)

        t = state.t + 1
        done = reached | (t >= self.max_episode_steps)
        new_state = state._replace(agent=new_agent, t=t)
        return new_state, self._render(new_state), reward, done

    def _render(self, state: PixelGridState) -> torch.Tensor:
        """[M, C, G*S, G*S] frames."""
        M, g = state.t.shape[0], self.grid * self.scale
        at = lambda rc: ((self._rows == rc[:, 0, None, None]) & (self._cols == rc[:, 1, None, None])
                         ).to(torch.float32) * self.intensity
        planes = [at(state.agent), at(state.goal), self._border.expand(M, g, g)][: self.channels]
        planes += [torch.zeros((M, g, g), device=self.device)] * (self.channels - len(planes))
        return torch.stack(planes, dim=1)
