"""ProcMaze level tables and JAX's reset draws, bit for bit those of
``jax.random``, in numpy.

A ProcMaze level is a pure function of its id through JAX's threefry
generator (``dfd_tpu/envs/procmaze.py::ProcMazeEnv._gen_level``):
``key(977)``, ``fold_in(level)``, ``split(4)``, then ``randint`` and
``uniform`` draws.  The port computes the table of every level an env can
reset to once, on the host, when the env is built, and moves it to the
device; nothing here runs per step.  The same functions give a JAX env's
reset draw under a known key (``TorchEnv.reset_draw``), for the trainer's
eval panel.

The generator is re-implemented in uint32 numpy arithmetic, vectorized over
levels, following ``jax/_src/prng.py`` with ``jax_threefry_partitionable``
on (the default): ``threefry_2x32`` (20 rounds, key schedule with
0x1BD11BDA), ``fold_in`` as the hash of the count pair ``(0, data)``,
``split`` and ``random_bits`` from the counts ``(hi, lo)`` of the flat index
(32-bit bits are ``bits1 ^ bits2``), ``randint`` from two bit streams folded
modulo the span, and ``uniform`` from the high 23 bits as a float in
[1, 2) minus 1, scaled with XLA's fused multiply-add and clamped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_LEVEL_SEED = 977  # jax.random.key(977) in ProcMazeEnv._gen_level


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the count pairs (x1, x2) under the keys
    (k1, k2); every argument broadcasts, all uint32."""
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


def key_data(seed: int) -> np.ndarray:
    """The key words [2] of ``jax.random.key(seed)``, seed in [0, 2**32)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return np.array([0, seed], _U32)


def fold_in(key: np.ndarray, data: np.ndarray) -> np.ndarray:
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
    """32-bit random bits: keys [..., 2] -> [..., *shape] uint32."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(lead + tuple(shape))


def randint(key: np.ndarray, shape: Tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` for int32 output: keys [..., 2] -> [..., *shape]."""
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = _U32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = _U32(((int(multiplier) ** 2) & 0xFFFFFFFF) % int(span))
        offset = (higher % span) * multiplier + lower % span
        offset = offset % span
    return minval + offset.astype(np.int64)


def uniform(key: np.ndarray, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: keys [..., 2] -> [..., *shape]."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add
    # (one rounding).  In float64 the product and the sum are exact for
    # these operands (23 + 24 significant bits, sum below 2 ** 53 ulps), so
    # one rounding to float32 gives the fused result.
    fused = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def level_table(levels: np.ndarray, grid: int, channels: int, density: float,
                intensity: float):
    """(start [L, 2], goal [L, 2], walls [L, G, G] bool, tint [L, C] f32)
    of the level ids ``levels``, as ``ProcMazeEnv._gen_level`` makes them."""
    levels = np.asarray(levels, np.int64)
    base = key_data(_LEVEL_SEED)
    keys = split(fold_in(base, levels.astype(_U32)), 4)  # [L, 4, 2]: start, goal, walls, tint
    start = randint(keys[:, 0], (2,), 0, grid)
    goal = randint(keys[:, 1], (2,), 0, grid)
    walls = uniform(keys[:, 2], (grid, grid)) < np.float32(density)
    rows = np.arange(grid)[None, :, None]
    cols = np.arange(grid)[None, None, :]
    # carve the start row and the goal column: an L-path always exists
    walls &= (rows != start[:, 0, None, None]) & (cols != goal[:, 1, None, None])
    L = np.arange(len(levels))
    walls[L, start[:, 0], start[:, 1]] = False
    walls[L, goal[:, 0], goal[:, 1]] = False
    tint = np.float32(intensity) * uniform(keys[:, 3], (channels,), 0.55, 1.0)
    return start, goal, walls, tint.astype(np.float32)
