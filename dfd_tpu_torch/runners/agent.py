"""Host-side episode collector (reference worker/agent.py:5-71), a copy of
``dfd_tpu.runners.agent``.

Runs one episode of at most ``ts_limit`` steps: optional observation
normalization with a *fixed* broadcast mean/std and clipping to +-10,
stochastic sampling of per-step observations into a local Welford statistic,
the post-episode entropy over visited (normalized) states, and the +-1e-12
reward jiggle that breaks exact-tie fitness ranks.
"""

from __future__ import annotations

import numpy as np

from dfd_tpu_torch.core.welford import Welford


class Agent:
    def __init__(
        self,
        policy,
        env,
        random_seed: int,
        normalize_obs: bool = False,
        obs_stats_update_chance: float = 0.01,
        ts_limit: int = 10000,
    ):
        self.policy = policy
        self.env = env
        self.rng = np.random.RandomState(random_seed)
        self.last_obs = env.reset()
        self.cumulative_timesteps = 0
        self.ts_limit = ts_limit
        self.obs_stats = Welford(policy.input_shape)
        self.normalize_obs = normalize_obs
        self.obs_stats_update_chance = obs_stats_update_chance
        self.saved_states: list = []

    def collect_return(self, eval_run: bool = False, save_states: bool = False, mean=1, std=0):
        obs = self.last_obs
        if self.normalize_obs:
            self.obs_stats.reset()

        reward = 0.0
        steps = 0
        states = []
        self.policy.reset()

        for _ in range(self.ts_limit):
            states.append(obs)
            if self.normalize_obs:
                if self.rng.uniform(0, 1) < self.obs_stats_update_chance:
                    self.obs_stats.increment(obs, 1)
                obs = np.clip(np.subtract(obs, mean) / std, -10, 10)

            action = self.policy.get_action(obs, deterministic=eval_run)
            new_obs, rew, done, _ = self.env.step(action)
            reward += rew
            steps += 1
            obs = new_obs
            if done:
                obs = self.env.reset()
                break

        self.last_obs = obs
        self.cumulative_timesteps += steps

        if save_states:
            self.saved_states = states

        states = np.asarray(states)
        if self.normalize_obs:
            states = np.clip((states - mean) / std, -10, 10)

        entropy = self.policy.get_entropy(states)
        self.policy.reset()

        # tie-break jiggle so standardize never sees an exactly-constant batch
        reward += self.rng.choice((-1e-12, 1e-12))
        return reward, entropy, steps
