"""A plain ProcMaze: the benchmark's own copy of the env the program steps.

A level is a pure function of its id through JAX's threefry generator
(``key(977)``, ``fold_in(level)``, ``split(4)``, then ``randint`` and
``uniform`` draws): start and goal cells, walls at the distribution's
density with the start row and the goal column carved open, and a tint per
channel.  Five actions (stay, up, down, left, right) move the agent unless
a wall or the border blocks it; the reward is the L1 progress towards the
goal plus 10 on reaching it; an episode ends on the goal or after
``max_steps`` steps.  Frames are ``[C, G * S, G * S]`` float32: the agent,
goal and wall planes times the level's tint, each cell ``S`` pixels wide.

The generator is written out in uint32 numpy (``jax/_src/prng.py`` with
``jax_threefry_partitionable`` on); the env runs in plain torch over a batch
of episodes.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
LEVEL_SEED = 977
DENSITY = {"easy": 0.15, "hard": 0.3}


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the count pairs (x1, x2) under the keys
    (k1, k2), all uint32 and broadcasting."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, _U32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """keys [..., 2] folded with uint32 data [...] -> keys [..., 2]."""
    data = np.asarray(data, _U32)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack([b1, b2], axis=-1)


def split(key: np.ndarray, num: int) -> np.ndarray:
    """keys [..., 2] -> [..., num, 2]."""
    lo = np.arange(num, dtype=_U32)
    b1, b2 = threefry2x32(key[..., None, 0], key[..., None, 1], np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """32-bit words: keys [..., 2] -> [..., *shape] uint32."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    lead = key.shape[:-1]
    b1, b2 = threefry2x32(key[..., 0].reshape(lead + (1,)), key[..., 1].reshape(lead + (1,)),
                          hi, lo)
    return (b1 ^ b2).reshape(lead + tuple(shape))


def randint(key: np.ndarray, shape: Tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` into int32: keys [..., 2] -> [..., *shape]."""
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = _U32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        multiplier = _U32(((int(_U32(2 ** 16) % span) ** 2) & 0xFFFFFFFF) % int(span))
        offset = ((higher % span) * multiplier + lower % span) % span
    return minval + offset.astype(np.int64)


def uniform(key: np.ndarray, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32; the scale and shift rounded once,
    as XLA's fused multiply-add (exact in float64 for these operands)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def level_table(levels: np.ndarray, grid: int, channels: int, density: float,
                intensity: float):
    """(start [L, 2], goal [L, 2], walls [L, G, G] bool, tint [L, C]) of the
    level ids ``levels``."""
    levels = np.asarray(levels, np.int64)
    keys = split(fold_in(np.array([0, LEVEL_SEED], _U32), levels.astype(_U32)), 4)
    start = randint(keys[:, 0], (2,), 0, grid)
    goal = randint(keys[:, 1], (2,), 0, grid)
    walls = uniform(keys[:, 2], (grid, grid)) < np.float32(density)
    rows = np.arange(grid)[None, :, None]
    cols = np.arange(grid)[None, None, :]
    walls &= (rows != start[:, 0, None, None]) & (cols != goal[:, 1, None, None])
    L = np.arange(len(levels))
    walls[L, start[:, 0], start[:, 1]] = False
    walls[L, goal[:, 0], goal[:, 1]] = False
    tint = np.float32(intensity) * uniform(keys[:, 3], (channels,), 0.55, 1.0)
    return start, goal, walls, tint.astype(np.float32)


class MazeState(NamedTuple):
    agent: torch.Tensor  # [N, 2] int64 row, col
    goal: torch.Tensor   # [N, 2]
    walls: torch.Tensor  # [N, G, G] bool
    tint: torch.Tensor   # [N, C]
    t: torch.Tensor      # [N] int64


class Maze:
    """A batch of ProcMaze episodes on ``device``."""

    n_actions = 5

    def __init__(self, grid: int, scale: int, channels: int, num_levels: int, start_level: int,
                 distribution_mode: str, intensity: float, max_steps: int, device):
        self.grid, self.scale, self.channels = grid, scale, channels
        self.max_steps = max_steps
        self.num_levels = num_levels
        self.device = torch.device(device)
        self.obs_shape = (channels, grid * scale, grid * scale)
        table = level_table(np.arange(start_level, start_level + num_levels), grid, channels,
                            DENSITY[distribution_mode], intensity)
        self._start, self._goal, self._walls, self._tint = (
            torch.as_tensor(a, device=self.device) for a in table)

    def reset(self, levels: torch.Tensor) -> Tuple[MazeState, torch.Tensor]:
        """Episodes on the level draws ``levels`` [N] in [0, num_levels)."""
        idx = levels.to(device=self.device, dtype=torch.int64)
        state = MazeState(self._start[idx], self._goal[idx], self._walls[idx], self._tint[idx],
                          torch.zeros_like(idx))
        return state, self.render(state)

    def step(self, state: MazeState, action: torch.Tensor):
        """(state, frames, reward [N] float32, done [N]) after ``action`` [N]."""
        a = action.to(torch.int64)
        move = torch.tensor([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]], device=self.device)[a]
        cand = (state.agent + move).clamp(0, self.grid - 1)
        rows = torch.arange(a.shape[0], device=self.device)
        blocked = state.walls[rows, cand[:, 0], cand[:, 1]]
        agent = torch.where(blocked[:, None], state.agent, cand)
        before = (state.agent - state.goal).abs().sum(-1)
        after = (agent - state.goal).abs().sum(-1)
        reached = after == 0
        reward = (before - after).to(torch.float32) + 10.0 * reached.to(torch.float32)
        t = state.t + 1
        new = state._replace(agent=agent, t=t)
        return new, self.render(new), reward, reached | (t >= self.max_steps)

    def render(self, state: MazeState) -> torch.Tensor:
        g, s = self.grid, self.scale
        cells = torch.arange(g, device=self.device)
        at = lambda rc: (cells[None, :, None] == rc[:, 0, None, None]) & \
            (cells[None, None, :] == rc[:, 1, None, None])
        planes = torch.stack([at(state.agent), at(state.goal), state.walls], 1)
        planes = planes[:, :self.channels].to(torch.float32)
        if self.channels > 3:
            pad = torch.zeros((planes.shape[0], self.channels - 3, g, g), device=self.device)
            planes = torch.cat([planes, pad], 1)
        frames = state.tint[:, :, None, None] * planes
        return frames.repeat_interleave(s, 2).repeat_interleave(s, 3)

    @staticmethod
    def keep(done: torch.Tensor, new: MazeState, old: MazeState) -> MazeState:
        """``old`` where ``done`` [N], else ``new``."""
        pick = lambda n, o: torch.where(done.reshape(done.shape + (1,) * (o.ndim - 1)), o, n)
        return MazeState(*(pick(n, o) for n, o in zip(new, old)))
