"""The ``simple_trap_env`` grid world, batched over the population.

The same dynamics as ``dfd_tpu.envs.trap.TrapEnv`` (the exact-parity target
environment; see its module docstring for the reference's rules): a gather
over a walkability grid that lives on the device, 9 actions over a 3x3
neighborhood (``dx = a // 3 - 1, dy = a % 3 - 1``), observation
``(x/1918, y/1071)`` in world units, reward the +x progress, and ``done``
on the 201st step.  State tensors have shape ``[M]``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs.base import TorchEnv

NODE_RADIUS = 7
MAX_X = 1918
MAX_Y = 1071
EPISODE_LENGTH = 200

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trap_map.npz")


def parse_map_text(text: str) -> np.ndarray:
    """Parse a map in the reference's text format into a walkability grid.

    Mirrors the reference parser's behavior exactly: rows are split on single
    spaces and a tile is walkable iff its token is exactly "0" (so trailing
    newline tokens make unwalkable cells).
    """
    rows = []
    for line in text.splitlines(keepends=True):
        rows.append([tok == "0" for tok in line.split(" ")])
    width = max(len(r) for r in rows)
    grid = np.zeros((len(rows), width), dtype=bool)
    for i, r in enumerate(rows):
        grid[i, : len(r)] = r
    return grid


def load_walkable_grid(path: str | None = None) -> np.ndarray:
    """Load the walkability grid from npz (default: the shipped reference
    map) or a reference-format text map."""
    if path is None:
        return np.load(_DATA)["walkable"]
    if path.endswith(".npz"):
        return np.load(path)["walkable"]
    with open(path) as f:
        return parse_map_text(f.read())


class TrapState(NamedTuple):
    ix: torch.Tensor  # [M] column index, int64
    iy: torch.Tensor  # [M] row index, int64
    t: torch.Tensor   # [M] step counter, int64


class TrapEnv(TorchEnv):
    """Deterministic grid world; exact behavioral parity with the reference."""

    n_actions = 9
    obs_shape = (2,)
    max_episode_steps = EPISODE_LENGTH + 1  # done fires on the 201st step

    def __init__(self, map_path: str | None = None, device=None):
        self.device = resolve_device(device)
        grid = load_walkable_grid(map_path)
        self._walkable = torch.as_tensor(grid, dtype=torch.bool, device=self.device)
        self.height, self.width = grid.shape
        # reference start: get_node(width*7//2, height*7//2) -> floor division
        # through world units and back (environment.py:22)
        self.start_ix = (self.width * NODE_RADIUS // 2) // NODE_RADIUS
        self.start_iy = (self.height * NODE_RADIUS // 2) // NODE_RADIUS

    def reset(self, n: int, reset_level: torch.Tensor | None = None) -> Tuple[TrapState, torch.Tensor]:
        """``reset_level`` is ignored: the trap env has one start."""
        full = lambda v: torch.full((n,), v, dtype=torch.int64, device=self.device)
        state = TrapState(ix=full(self.start_ix), iy=full(self.start_iy), t=full(0))
        return state, self._obs(state)

    def step(self, state: TrapState, action: torch.Tensor):
        a = action.to(torch.int64)
        # out-of-range actions are no-ops (node.py:9-11 guard)
        valid = (a >= 0) & (a < 9)
        a = a.clamp(0, 8)
        dx = torch.where(valid, a // 3 - 1, 0)
        dy = torch.where(valid, a % 3 - 1, 0)
        tx = state.ix + dx
        ty = state.iy + dy
        in_bounds = (tx >= 0) & (tx < self.width) & (ty >= 0) & (ty < self.height)
        # out-of-bounds links point back to the node itself (tile_map.py:20-22)
        tx = torch.where(in_bounds, tx, state.ix)
        ty = torch.where(in_bounds, ty, state.iy)
        ok = self._walkable[ty, tx]
        nx = torch.where(ok, tx, state.ix)
        ny = torch.where(ok, ty, state.iy)
        reward = (NODE_RADIUS * (nx - state.ix)).to(torch.float32)
        done = state.t >= EPISODE_LENGTH
        new_state = TrapState(ix=nx, iy=ny, t=state.t + 1)
        return new_state, self._obs(new_state), reward, done

    def _obs(self, state: TrapState) -> torch.Tensor:
        return torch.stack(
            [
                (state.ix * NODE_RADIUS).to(torch.float32) / MAX_X,
                (state.iy * NODE_RADIUS).to(torch.float32) / MAX_Y,
            ],
            dim=-1,
        )
