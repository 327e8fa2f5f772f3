"""Host-side perturbation worker (reference worker/worker.py:7-57), a copy
of ``dfd_tpu.runners.worker``.

Per collected return: with probability ``eval_prob`` run the *unperturbed*
policy deterministically (its visited states become zeta candidates and its
stats update the EMA baselines); otherwise sample noise, evaluate the policy
at ``theta + sigma * eps`` for one episode, and restore theta.  Each return
carries the encoded noise, episodic reward, novelty of the evaluated policy,
entropy, epoch, and the local observation-statistics delta.
"""

from __future__ import annotations

import numpy as np

from dfd_tpu_torch.core.welford import Welford
from dfd_tpu_torch.envs.wrappers import frame_of
from dfd_tpu_torch.fd.returns import FDReturn


class Worker:
    def __init__(
        self,
        policy,
        agent,
        noise_source,
        strategy_handler,
        sigma: float = 0.02,
        eval_prob: float = 0.1,
        random_seed: int = 123,
    ):
        self.policy = policy
        self.agent = agent
        self.noise_source = noise_source
        self.strategy_handler = strategy_handler
        self.sigma = sigma
        self.eval_prob = eval_prob
        self.epoch = -1
        self.rng = np.random.RandomState(random_seed)
        self.fixed_obs_stats = Welford(policy.input_shape)

    def collect_returns(self, n: int = 1):
        returns = []
        for _ in range(n):
            is_eval = self.rng.uniform(0, 1) < self.eval_prob
            if not is_eval:
                flat = self.policy.get_trainable_flat()
                encoded, eps = self.noise_source.sample()
                self.policy.set_trainable_flat(flat + self.sigma * eps)
                ret = self._build_return(encoded, is_eval)
                self.policy.set_trainable_flat(flat)
            else:
                ret = self._build_return("0", is_eval)
                # dict observations (recurrent/pixel envs) ship frames only:
                # zeta and the wire carry plain CHW arrays
                ret.eval_states = [frame_of(s) for s in self.agent.saved_states]
            returns.append(ret)
        return returns

    def update(self, state) -> None:
        """Apply a broadcast FDState: parameters, epoch, fixed obs stats."""
        self.policy.deserialize(state.policy_params)
        self.epoch = state.epoch
        if hasattr(self.noise_source, "set_epoch"):
            self.noise_source.set_epoch(state.epoch)
        if state.obs_stats is not None:
            self.fixed_obs_stats.deserialize(state.obs_stats)

    def _build_return(self, encoded, is_eval: bool) -> FDReturn:
        ret = FDReturn()
        rew, ent, steps = self.agent.collect_return(
            eval_run=is_eval,
            save_states=is_eval,
            mean=self.fixed_obs_stats.mean,
            std=self.fixed_obs_stats.std,
        )
        ret.is_eval = is_eval
        ret.timesteps = steps
        ret.encoded_noise = encoded
        ret.reward = rew
        ret.novelty = self.strategy_handler.compute_novelty(self.policy.get_trainable_flat())
        ret.entropy = ent
        ret.epoch = self.epoch
        ret.obs_stats_update = self.agent.obs_stats.serialize()
        return ret
