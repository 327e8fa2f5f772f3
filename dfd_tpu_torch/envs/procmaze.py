"""Procgen-shaped procedural pixel maze, batched over the population.

The same env as ``dfd_tpu.envs.procmaze.ProcMazeEnv`` (see its module
docstring for the procgen contract it follows): a level is a deterministic
function of its integer id (wall layout, start and goal cells, a per-channel
tint), training resets draw a level uniformly from ``[start_level,
start_level + num_levels)``, 5 actions (stay/up/down/left/right) move the
agent unless a wall blocks it, and the reward is the L1 progress towards the
goal plus 10 on reaching it.  Frames are ``[C, G*S, G*S]`` float32: channel
0 the agent, 1 the goal, 2 the walls, each times its level's tint.

The level table is made once, on the host, when the env is built
(``envs/_levels.py`` reproduces ``jax.random``'s bits), for the
``num_levels`` ids the env can reset to, and lives on the device.  A reset
takes the level draw in ``[0, num_levels)`` as an argument (the
``reset_level`` field of the trainer's ``EpochDraws``) instead of a key.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs._levels import level_table
from dfd_tpu_torch.envs.base import TorchEnv

DENSITY = {"easy": 0.15, "hard": 0.3}


class ProcMazeState(NamedTuple):
    agent: torch.Tensor  # [M, 2] int64 row, col
    goal: torch.Tensor   # [M, 2] int64
    walls: torch.Tensor  # [M, G, G] bool
    tint: torch.Tensor   # [M, C] float32 per-channel intensity
    t: torch.Tensor      # [M] int64


class ProcMazeEnv(TorchEnv):
    n_actions = 5

    def __init__(
        self,
        grid: int = 8,
        scale: int = 8,
        channels: int = 3,
        max_steps: int = 48,
        num_levels: int = 200,
        start_level: int = 0,
        distribution_mode: str = "easy",
        intensity: float = 255.0,
        device=None,
    ):
        if distribution_mode not in DENSITY:
            raise ValueError(f"distribution_mode must be one of {sorted(DENSITY)}")
        self.device = resolve_device(device)
        self.grid = grid
        self.scale = scale
        self.channels = channels
        self.max_episode_steps = max_steps
        self.num_levels = int(num_levels)
        self.start_level = int(start_level)
        self.distribution_mode = distribution_mode
        self.density = DENSITY[distribution_mode]
        self.intensity = float(intensity)
        self.obs_shape = (channels, grid * scale, grid * scale)
        levels = np.arange(self.start_level, self.start_level + self.num_levels)
        t = lambda a: torch.as_tensor(a, device=self.device)
        self._start, self._goal, self._walls, self._tint = (
            t(a) for a in level_table(levels, grid, channels, self.density, self.intensity)
        )

    def with_levels(self, num_levels=None, start_level=None) -> "ProcMazeEnv":
        """A copy with a different level range; level ids are global, so a
        level replays identically under any range that holds it."""
        return type(self)(
            grid=self.grid,
            scale=self.scale,
            channels=self.channels,
            max_steps=self.max_episode_steps,
            num_levels=self.num_levels if num_levels is None else num_levels,
            start_level=self.start_level if start_level is None else start_level,
            distribution_mode=self.distribution_mode,
            intensity=self.intensity,
            device=self.device,
        )

    def level_arrays(self):
        """The level table: (start [L, 2], goal [L, 2], walls [L, G, G],
        tint [L, C]) for the ids ``start_level + arange(num_levels)``."""
        return self._start, self._goal, self._walls, self._tint

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[ProcMazeState, torch.Tensor]:
        """``reset_level`` [n]: each episode's level draw in [0, num_levels)."""
        idx = reset_level.to(device=self.device, dtype=torch.int64)
        if idx.shape != (n,):
            raise ValueError(f"reset_level must have shape ({n},), got {tuple(idx.shape)}")
        state = ProcMazeState(
            agent=self._start[idx], goal=self._goal[idx], walls=self._walls[idx],
            tint=self._tint[idx], t=torch.zeros(n, dtype=torch.int64, device=self.device),
        )
        return state, self._render(state)

    def step(self, state: ProcMazeState, action: torch.Tensor):
        a = action.to(torch.int64)
        dr = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
        dc = torch.where(a == 3, -1, torch.where(a == 4, 1, 0))
        cand = torch.clamp(state.agent + torch.stack([dr, dc], dim=-1), 0, self.grid - 1)
        rows = torch.arange(a.shape[0], device=self.device)
        blocked = state.walls[rows, cand[:, 0], cand[:, 1]]
        new_agent = torch.where(blocked[:, None], state.agent, cand)

        dist_old = (state.agent - state.goal).abs().sum(dim=-1)
        dist_new = (new_agent - state.goal).abs().sum(dim=-1)
        reached = dist_new == 0
        reward = (dist_old - dist_new).to(torch.float32) + 10.0 * reached.to(torch.float32)

        t = state.t + 1
        done = reached | (t >= self.max_episode_steps)
        new_state = state._replace(agent=new_agent, t=t)
        return new_state, self._render(new_state), reward, done

    def _render(self, state: ProcMazeState) -> torch.Tensor:
        """[M, C, G*S, G*S]: the [M, C, G, G] cell planes, each cell repeated
        ``scale`` times along both axes."""
        M, g = state.t.shape[0], self.grid
        cells = torch.arange(g, device=self.device)
        on = lambda rc: (cells[None, :, None] == rc[:, 0, None, None]) & (
            cells[None, None, :] == rc[:, 1, None, None])
        planes = torch.stack([on(state.agent), on(state.goal), state.walls], dim=1)
        planes = planes[:, : self.channels].to(torch.float32)
        if self.channels > 3:
            pad = torch.zeros((M, self.channels - 3, g, g), device=self.device)
            planes = torch.cat([planes, pad], dim=1)
        cell_frames = state.tint[:, :, None, None] * planes
        s = self.scale
        return cell_frames.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
