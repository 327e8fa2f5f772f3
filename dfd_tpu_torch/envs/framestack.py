"""On-device frame stacking and channel padding for pixel envs, the port of
``dfd_tpu.envs.framestack``.

``FrameStackEnv(k)`` is the deepmind Atari pipeline's ``FrameStack(k)``:
the last k frames concatenated along the channel axis, every slot filled
with the first frame at reset.  The stack is part of the env state
(:class:`FrameStackState`, a NamedTuple of the inner env's state and the
stack [M, k * C, H, W]), so the rollout freezes a done episode's stack with
the rest of its state.  ``PadChannelsEnv`` zero-pads the channel axis up to
a policy's stacked input (the reference AtariPolicy's ``in_channels = 4``).

Both pass the inner env's reset draw through unchanged: ``reset_shape``,
``num_levels``, ``sample_reset`` and ``reset_draw`` are the inner env's.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from dfd_tpu_torch.envs.base import TorchEnv


class _Wrapper(TorchEnv):
    """The inner env's action space and reset draw."""

    def _wrap(self, env: TorchEnv) -> None:
        self.env = env
        self.device = env.device
        self.n_actions = env.n_actions
        self.action_dim = env.action_dim
        self.max_episode_steps = env.max_episode_steps
        self.num_levels = env.num_levels
        self.reset_shape = tuple(env.reset_shape)

    @property
    def reset_high(self) -> int:
        return self.env.reset_high

    def sample_reset(self, shape, generator: torch.Generator) -> torch.Tensor:
        return self.env.sample_reset(shape, generator)

    def reset_draw(self, keys: np.ndarray) -> np.ndarray:
        return self.env.reset_draw(keys)


class FrameStackState(NamedTuple):
    inner: Any           # the inner env's state
    stack: torch.Tensor  # [M, k * C, H, W] the last k frames, the newest last


class FrameStackEnv(_Wrapper):
    """Stack the last ``k`` CHW observations of ``env`` along channels."""

    def __init__(self, env: TorchEnv, k: int = 4):
        if len(env.obs_shape) != 3:
            raise ValueError(f"FrameStackEnv needs CHW frames, got obs_shape={env.obs_shape}")
        self._wrap(env)
        self.k = int(k)
        c, h, w = env.obs_shape
        self.frame_channels = c
        self.obs_shape = (self.k * c, h, w)

    def reset(self, n: int, reset_level: torch.Tensor) -> Tuple[FrameStackState, torch.Tensor]:
        state, obs = self.env.reset(n, reset_level)
        stack = obs.repeat(1, self.k, 1, 1)  # the first frame fills all k slots
        return FrameStackState(state, stack), stack

    def step(self, state: FrameStackState, action: torch.Tensor):
        new_inner, obs, reward, done = self.env.step(state.inner, action)
        stack = torch.cat([state.stack[:, self.frame_channels:], obs], dim=1)
        return FrameStackState(new_inner, stack), stack, reward, done


class PadChannelsEnv(_Wrapper):
    """Zero-pad a pixel env's channel axis up to ``to_channels``: the extra
    planes are constant zero, unused stacked-frame slots."""

    def __init__(self, env: TorchEnv, to_channels: int = 4):
        c, h, w = env.obs_shape
        if to_channels < c:
            raise ValueError(f"to_channels={to_channels} < env channels {c}")
        self._wrap(env)
        self.pad = to_channels - c
        self.obs_shape = (to_channels, h, w)

    def _padded(self, obs: torch.Tensor) -> torch.Tensor:
        z = torch.zeros((obs.shape[0], self.pad) + tuple(obs.shape[2:]), dtype=obs.dtype,
                        device=obs.device)
        return torch.cat([obs, z], dim=1)

    def reset(self, n: int, reset_level: torch.Tensor):
        state, obs = self.env.reset(n, reset_level)
        return state, self._padded(obs)

    def step(self, state, action: torch.Tensor):
        new_state, obs, reward, done = self.env.step(state, action)
        return new_state, self._padded(obs), reward, done
