"""Gym-style host adapter over a population-batched port env, the
counterpart of ``dfd_tpu.runners.host_env.HostEnv``.

The sequential runner steps one episode at a time on the host; this adapter
keeps one episode (n = 1) of a :class:`~dfd_tpu_torch.envs.base.TorchEnv`
on the env's device and exposes the reference's ``reset() -> obs`` /
``step(a) -> (obs, reward, done, info)`` surface with numpy observations.

Resets follow the JAX adapter's key chain: the adapter holds the words of
``jax.random.key(seed)``, each reset takes ``key, sub = split(key)``
(``envs/_levels.py::split``) and starts the episode at the env's
``reset_draw(sub)``, the draw the JAX env makes from ``sub``; so a port
``HostEnv`` resets where ``dfd_tpu``'s does.

A step sends the action to the device (an int becomes a ``[1]`` tensor, a
continuous action's list a ``[1, A]`` one) through pinned memory without a
host synchronisation (``core/device.py::Staging``) and reads the
observation, the reward and the done flag back in one transfer: one
synchronisation a step.
"""

from __future__ import annotations

import numpy as np
import torch

from dfd_tpu_torch.core.device import Staging
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv

class HostEnv:
    def __init__(self, env: TorchEnv, seed: int = 0):
        self.env = env
        self._key = _levels.key_data(int(seed))
        self._state = None
        self._obs_size = int(np.prod(env.obs_shape))
        self._stage = Staging(env.device)

    @property
    def n_actions(self):
        return self.env.n_actions

    @property
    def obs_shape(self):
        return self.env.obs_shape

    def seed(self, seed: int) -> None:
        self._key = _levels.key_data(int(seed))

    def reset(self) -> np.ndarray:
        self._key, sub = _levels.split(self._key, 2)
        self._state, obs = self.env.reset(1, self._stage(self.env.reset_draw(sub[None])))
        return obs[0].to(torch.float32).cpu().numpy()

    def step(self, action):
        env = self.env
        if env.discrete:
            a = np.array([int(action)], np.int64)
        else:
            a = np.asarray(action, np.float32).reshape(1, -1)
        self._state, obs, reward, done = env.step(self._state, self._stage(a))
        # obs, reward and done cross to the host in one transfer
        packed = torch.cat([obs.reshape(-1).to(torch.float32), reward.reshape(-1).to(torch.float32),
                            done.reshape(-1).to(torch.float32)]).cpu().numpy()
        n = self._obs_size
        return packed[:n].reshape(env.obs_shape), float(packed[n]), bool(packed[n + 1]), {}
