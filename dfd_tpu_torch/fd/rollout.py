"""Population rollouts — the hot path.

All M population members step in lockstep, each in E episodes: a Python
loop over T timesteps, each step one batched policy forward over the
members' own weights (E rows a member, the weights indexed, never copied)
and one batched env transition over the M * E episodes.  This is
``dfd_tpu.fd.rollout.episode_rollout`` (a ``lax.scan`` over T, vmapped over
members and, for E > 1, episodes) with both axes written out.  Post-done
steps are masked and the env state frozen after done; per-step entropy
accumulates per episode, and so do sampled Welford
observation statistics when ``normalize_obs`` is set.  Obs normalization is
their only reader, so without it they are skipped, saving their launches on
every step, and ``obs_stats`` stays empty; the JAX package computes them
anyway and XLA drops the unread work.

A recurrent policy (IMPALA's LSTM) gets the previous step's reward and its
carry at every step; both are frozen once the episode is done, as in the JAX
package.  The weight layouts a forward derives from the weights alone are
computed once per rollout (``model.prepare``).

The randomness is passed in as draws instead of keys: ``action_noise``
[M, E, T, A] (the Gumbel noise of a categorical sample, or the standard
normals of a Gaussian one), ``stats_uniform`` [M, E, T] (the per-step coin of
the sampled statistics) and ``reset_level`` [M, E, *env.reset_shape] (each
episode's reset draw: its level, cells or start state).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dfd_tpu_torch.core import welford
from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.models.base import PolicyModel


class RolloutResult(NamedTuple):
    reward: torch.Tensor                 # [M, E] episodic return (sum of rewards until done)
    entropy: torch.Tensor                # [M, E] mean policy entropy over visited states
    steps: torch.Tensor                  # [M, E] executed steps (<= T), int64
    obs_stats: welford.WelfordState      # [M, E]-batched sampled observation statistics
                                         # (empty unless normalize_obs)
    states: torch.Tensor                 # [M, collect_limit, *obs] first visited observations
                                         # of episode 0


def episode_rollout(
    model: PolicyModel,
    env: TorchEnv,
    params,
    bn_state,
    horizon: int,
    deterministic: torch.Tensor,
    obs_mean: torch.Tensor,
    obs_std: torch.Tensor,
    normalize_obs: bool,
    obs_stats_update_chance: float,
    action_noise: torch.Tensor,
    stats_uniform: torch.Tensor,
    reset_level: torch.Tensor,
    collect_limit: int,
) -> RolloutResult:
    """E full episodes for each of the M members of ``params`` (E is the
    draws' second axis); ``deterministic`` [M] holds for a member's every
    episode.

    The first ``collect_limit`` observations of every member's episode 0
    are kept (the zeta refresh only reads the eval member's, reference
    run_sequential.py:142-143)."""
    M, E = reset_level.shape[:2]
    N = M * E
    dev = deterministic.device
    obs_shape = tuple(env.obs_shape)
    params = model.prepare(params, bn_state)
    env_state, obs = env.reset(N, reset_level.reshape((N,) + tuple(reset_level.shape[2:])))
    obs = obs.reshape((M, E) + obs_shape)
    prev_done = torch.zeros((M, E), dtype=torch.bool, device=dev)
    prev_reward = torch.zeros((M, E), dtype=torch.float32, device=dev)
    carry = tuple(c.reshape((M, E) + c.shape[1:]) for c in model.initial_carry(N))
    reward_acc = torch.zeros((M, E), dtype=torch.float32, device=dev)
    ent_acc = torch.zeros((M, E), dtype=torch.float32, device=dev)
    step_acc = torch.zeros((M, E), dtype=torch.int64, device=dev)
    stats = welford.init(obs_shape, dev, batch=(M, E))
    state_buf = torch.zeros((M, collect_limit) + obs_shape, dtype=torch.float32, device=dev)

    for t in range(horizon):
        raw_obs = obs
        if normalize_obs:
            obs = torch.clamp((obs - obs_mean) / obs_std, -10, 10)
        action, step_entropy, new_carry = model.act_step(
            params, bn_state, obs, prev_reward, prev_done, carry, deterministic,
            action_noise[:, :, t],
        )
        new_env_state, new_obs, reward, step_done = env.step(
            env_state, action.reshape((N,) + action.shape[2:]))
        new_obs = new_obs.reshape((M, E) + obs_shape)
        reward, step_done = reward.reshape(M, E), step_done.reshape(M, E)

        active = ~prev_done
        af = active.to(torch.float32)
        if normalize_obs:
            sample_mask = af * (stats_uniform[:, :, t] < obs_stats_update_chance).to(
                torch.float32)
            stats = welford.update_batch(stats, raw_obs.unsqueeze(2), sample_mask.unsqueeze(2))
        if t < collect_limit:
            state_buf[:, t] = raw_obs[:, 0]
        reward_acc = reward_acc + af * reward
        ent_acc = ent_acc + af * step_entropy
        step_acc = step_acc + active.to(torch.int64)

        # freeze the env and the model carry once done (post-done
        # transitions are discarded)
        env_state = type(env_state)(*_keep(prev_done.reshape(N), new_env_state, env_state))
        carry = tuple(_keep(prev_done, new_carry, carry))
        # as in the JAX package, a done episode carries the observation the
        # policy saw (normalized, when normalize_obs)
        obs = torch.where(prev_done.reshape((M, E) + (1,) * len(obs_shape)), obs, new_obs)
        if model.recurrent:  # its only reader
            prev_reward = torch.where(prev_done, prev_reward, reward.to(torch.float32))
        prev_done = prev_done | step_done

    entropy = ent_acc / torch.clamp_min(step_acc, 1).to(torch.float32)
    return RolloutResult(reward=reward_acc, entropy=entropy, steps=step_acc, obs_stats=stats,
                         states=state_buf)


def _keep(done: torch.Tensor, new, old):
    """Each of ``old`` where ``done`` (their leading axes) is set, else each
    of ``new``; a nested state tuple (a wrapper env's inner state) is kept
    field by field."""
    return (type(o)(*_keep(done, n, o)) if isinstance(o, tuple) else
            torch.where(done.reshape(done.shape + (1,) * (o.ndim - done.ndim)), o, n)
            for n, o in zip(new, old))
