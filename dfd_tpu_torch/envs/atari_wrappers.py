"""Dependency-free deepmind-style Atari preprocessing, a copy of
``dfd_tpu.envs.atari_wrappers``.

The reference builds its Atari pipeline from ``baselines.common.atari_wrappers``
(reference utils/init_helper.py:13-18): ``wrap_deepmind(make_atari(id),
frame_stack=True, scale=True)`` = noop reset (up to 30), max-over-2 +
skip-4, episodic life, fire-on-reset, 84x84 grayscale warp, /255 scale,
sign-clipped rewards, 4-frame stack.  This module builds the same pipeline
over the host-env surface (``reset() -> obs``, ``step(a) -> (obs, rew,
done, info)``) in numpy, without baselines, cv2 or ALE:

  - grayscale uses the ITU-R 601 luma weights cv2's RGB2GRAY uses;
  - the 84x84 warp is exact area interpolation (cv2 INTER_AREA), computed
    as two separable overlap-weight matmuls;
  - ALE-internal hooks (lives for episodic-life, FIRE action meanings)
    are capability-gated: they engage when the wrapped env exposes them
    (gymnasium ALE reports ``lives`` in ``info``) and disappear cleanly on
    synthetic envs, so the pipeline is testable without ALE.

The wrappers stay on the host: the frames reach the card as the policy's
input.  Output observations are (size, size, n_stack) float32 in [0, 1] —
channels-last stacks, the layout :class:`dfd_tpu_torch.models.atari.AtariCNN`
accepts directly.  Every draw (the noop counts) comes from
``np.random.default_rng(seed)``, as in the JAX package.
"""

from __future__ import annotations

from collections import deque

import numpy as np

# ITU-R 601 luma — the coefficients cv2.cvtColor(RGB2GRAY) applies.
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def area_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic overlap weights for 1-D area resize.

    Output pixel j covers the input interval [j*r, (j+1)*r), r = n_in/n_out;
    its value is the overlap-weighted mean of the covered input pixels —
    exactly cv2 INTER_AREA's downscale semantics, which are separable per
    axis, so a 2-D warp is ``W_h @ img @ W_w.T``."""
    r = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for j in range(n_out):
        lo, hi = j * r, (j + 1) * r
        i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            w[j, i] = min(hi, i + 1) - max(lo, i)
    return w / w.sum(axis=1, keepdims=True)


class WarpFrame:
    """Grayscale + area-resize to (size, size, 1) — baselines WarpFrame."""

    def __init__(self, env, size: int = 84):
        self._env = env
        self.size = size
        self._wh = None  # lazily keyed on the incoming frame shape
        self._ww = None
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    def _warp(self, frame: np.ndarray) -> np.ndarray:
        f = np.asarray(frame, np.float32)
        if f.ndim == 3:
            f = f @ _LUMA if f.shape[-1] == 3 else f[..., 0]
        if self._wh is None or self._wh.shape[1] != f.shape[0]:
            self._wh = area_resize_weights(f.shape[0], self.size)
            self._ww = area_resize_weights(f.shape[1], self.size)
        out = self._wh @ f @ self._ww.T
        return out[..., None]  # (size, size, 1)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        return self._warp(self._env.reset())

    def step(self, action):
        obs, rew, done, info = self._env.step(action)
        return self._warp(obs), rew, done, info

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class NoopResetEnv:
    """Sample 1..noop_max no-op steps after reset (baselines NoopResetEnv)."""

    def __init__(self, env, noop_max: int = 30, noop_action: int = 0, seed: int = 0):
        self._env = env
        self.noop_max = noop_max
        self.noop_action = noop_action
        self._rng = np.random.default_rng(seed)
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    def seed(self, seed):
        self._rng = np.random.default_rng(seed)
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        obs = self._env.reset()
        for _ in range(int(self._rng.integers(1, self.noop_max + 1))):
            obs, _, done, _ = self._env.step(self.noop_action)
            if done:
                obs = self._env.reset()
        return obs

    def step(self, action):
        return self._env.step(action)

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class MaxAndSkipEnv:
    """Repeat each action ``skip`` times; observe the pixelwise max of the
    last two frames; sum rewards (baselines MaxAndSkipEnv)."""

    def __init__(self, env, skip: int = 4):
        self._env = env
        self.skip = skip
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        return self._env.reset()

    def step(self, action):
        total, done, info = 0.0, False, {}
        prev = obs = None
        for i in range(self.skip):
            prev = obs if i == self.skip - 1 else prev
            obs, rew, done, info = self._env.step(action)
            total += rew
            if done:
                break
        if prev is not None:
            obs = np.maximum(prev, obs)
        return obs, total, done, info

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class EpisodicLifeEnv:
    """Life loss ends the (training) episode; the true env only resets on a
    real game-over (baselines EpisodicLifeEnv).  Lives come from the step
    ``info`` dict (gymnasium ALE populates ``info['lives']``); on envs that
    never report lives this wrapper is a transparent pass-through."""

    def __init__(self, env):
        self._env = env
        self._lives = 0
        self._real_done = True
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def _probe_lives(self):
        probe = self._env
        for _ in range(8):  # unwrap adapter/wrapper chains
            lives = getattr(probe, "lives", None)
            if lives is not None:
                return int(lives() if callable(lives) else lives)
            ale = getattr(probe, "ale", None)
            if ale is not None:
                return int(ale.lives())
            nxt = getattr(probe, "_env", None) or getattr(probe, "unwrapped", None)
            if nxt is None or nxt is probe:
                return 0
            probe = nxt
        return 0

    def reset(self):
        if self._real_done:
            obs = self._env.reset()
            self._lives = self._probe_lives()
        else:
            # life lost: advance one no-op instead of resetting the game
            obs, _, done, info = self._env.step(0)
            if done:
                obs = self._env.reset()
            self._lives = int(info.get("lives", self._probe_lives()))
        self._real_done = False
        return obs

    def step(self, action):
        obs, rew, done, info = self._env.step(action)
        self._real_done = done
        lives = int(info.get("lives", self._lives))
        if 0 < lives < self._lives:
            done = True
        self._lives = lives
        return obs, rew, done, info

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class FireResetEnv:
    """Press FIRE after reset for envs that need it (baselines FireResetEnv)."""

    def __init__(self, env, fire_action: int = 1):
        self._env = env
        self.fire_action = fire_action
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def reset(self):
        self._env.reset()
        obs, _, done, _ = self._env.step(self.fire_action)
        if done:
            obs = self._env.reset()
        return obs

    def step(self, action):
        return self._env.step(action)

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


class ScaledClipStackEnv:
    """ScaledFloatFrame + ClipRewardEnv + FrameStack fused into one hop:
    frames scaled to [0, 1] float32, rewards sign-clipped (optional), the
    last ``n_stack`` warped frames concatenated channels-last."""

    def __init__(self, env, n_stack: int = 4, scale: float = 255.0, clip_rewards: bool = True):
        self._env = env
        self.n_stack = n_stack
        self.scale = float(scale)
        self.clip_rewards = clip_rewards
        self._frames: deque = deque(maxlen=n_stack)
        self.action_space = getattr(env, "action_space", None)

    @property
    def n_actions(self):
        return getattr(self._env, "n_actions", None)

    @property
    def obs_shape(self):
        size = getattr(self._env, "size", 84)
        return (size, size, self.n_stack)

    def seed(self, seed):
        if hasattr(self._env, "seed"):
            self._env.seed(seed)

    def _obs(self):
        return np.concatenate(list(self._frames), axis=-1).astype(np.float32)

    def reset(self):
        frame = np.asarray(self._env.reset(), np.float32) / self.scale
        for _ in range(self.n_stack):
            self._frames.append(frame)
        return self._obs()

    def step(self, action):
        obs, rew, done, info = self._env.step(action)
        self._frames.append(np.asarray(obs, np.float32) / self.scale)
        if self.clip_rewards:
            info = dict(info)
            info["raw_reward"] = rew
            rew = float(np.sign(rew))
        return self._obs(), rew, done, info

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()


def _action_meanings(env):
    probe = env
    for _ in range(8):  # unwrap adapter/wrapper chains
        for attr in ("get_action_meanings",):
            fn = getattr(probe, attr, None)
            if callable(fn):
                try:
                    return fn()
                except Exception:
                    return None
        nxt = getattr(probe, "_env", None) or getattr(probe, "unwrapped", None)
        if nxt is None or nxt is probe:
            return None
        probe = nxt
    return None


def wrap_deepmind_style(
    env,
    size: int = 84,
    n_stack: int = 4,
    noop_max: int = 30,
    skip: int = 4,
    episode_life: bool = True,
    clip_rewards: bool = True,
    seed: int = 0,
):
    """Compose the full reference pipeline (utils/init_helper.py:13-18):
    make_atari's NoopReset + MaxAndSkip, then wrap_deepmind's EpisodicLife,
    FireReset (when the env declares a FIRE action), WarpFrame, scale,
    reward clip, and 4-stack.  Returns an env emitting (size, size,
    n_stack) float32 observations in [0, 1]."""
    if noop_max > 0:
        env = NoopResetEnv(env, noop_max=noop_max, seed=seed)
    if skip > 1:
        env = MaxAndSkipEnv(env, skip=skip)
    if episode_life:
        env = EpisodicLifeEnv(env)
    meanings = _action_meanings(env)
    if meanings and "FIRE" in meanings:
        env = FireResetEnv(env, fire_action=meanings.index("FIRE"))
    env = WarpFrame(env, size=size)
    return ScaledClipStackEnv(env, n_stack=n_stack, clip_rewards=clip_rewards)
