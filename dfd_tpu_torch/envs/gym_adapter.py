"""Host adapters for gymnasium and gym-era environments, a copy of
``dfd_tpu.envs.gym_adapter``.

C-engine environments (MuJoCo, Atari, Box2D, procgen) run on the host
behind the reference-style ``reset() -> obs`` / ``step(a) -> (obs, reward,
done, info)`` surface with numpy observations, and feed the sequential and
elastic-client topologies; the policy's forward is where the card enters.
Availability-gated: each suite plugs in where its package is installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def gymnasium_available() -> bool:
    try:
        import gymnasium  # noqa: F401

        return True
    except Exception:
        return False


def procgen_available() -> bool:
    """procgen registers against gym-era gym, not gymnasium."""
    try:
        import gym  # noqa: F401
        import procgen  # noqa: F401

        return True
    except Exception:
        return False


class GymEnv:
    """Adapter for gym-era (4-tuple) environments such as procgen.

    procgen's C++ env registers ids like ``procgen:procgen-coinrun-v0``
    against the legacy ``gym`` registry (reference utils/init_helper.py:9-12
    builds it the same way); this adapter exposes the same surface as
    :class:`GymnasiumEnv` so the rest of the stack is registry-agnostic."""

    def __init__(self, env_id: str, seed: int = 0, **kwargs):
        import gym

        self._env = gym.make(env_id, **kwargs)
        self._seed: Optional[int] = seed
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    @property
    def n_actions(self):
        return getattr(self._env.action_space, "n", None)

    @property
    def obs_shape(self):
        return self._env.observation_space.shape

    def seed(self, seed: int) -> None:
        self._seed = seed
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self) -> np.ndarray:
        if self._seed is not None and hasattr(self._env, "seed"):
            self._env.seed(self._seed)
            self._seed = None
            out = self._env.reset()
        elif self._seed is not None:
            # gym>=0.26 envs dropped .seed(); the seed rides on reset().
            seed, self._seed = self._seed, None
            out = self._env.reset(seed=seed)
        else:
            out = self._env.reset()
        if isinstance(out, tuple):  # gym>=0.26 returns (obs, info)
            out = out[0]
        return np.asarray(out)

    def step(self, action):
        out = self._env.step(action)
        if len(out) == 5:  # gym>=0.26: (obs, rew, terminated, truncated, info)
            obs, reward, terminated, truncated, info = out
            return np.asarray(obs), float(reward), bool(terminated or truncated), info
        obs, reward, done, info = out
        return np.asarray(obs), float(reward), bool(done), info

    def close(self) -> None:
        self._env.close()


class GymnasiumEnv:
    """Old-gym surface (reset()->obs, step()->obs,rew,done,info) over
    gymnasium's 5-tuple API, with seed plumbing."""

    def __init__(self, env_id: str, seed: int = 0, **kwargs):
        import gymnasium

        self._env = gymnasium.make(env_id, **kwargs)
        self._seed: Optional[int] = seed
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    @property
    def n_actions(self):
        space = self._env.action_space
        return getattr(space, "n", None)

    @property
    def obs_shape(self):
        return self._env.observation_space.shape

    def seed(self, seed: int) -> None:
        self._seed = seed

    def reset(self) -> np.ndarray:
        obs, _info = self._env.reset(seed=self._seed)
        self._seed = None  # only the first reset is seeded, like gym's API
        return np.asarray(obs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(action)
        return np.asarray(obs), float(reward), bool(terminated or truncated), info

    def close(self) -> None:
        self._env.close()
