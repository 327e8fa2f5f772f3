"""Sequential trainer — single-process reference-semantics loop
(reference run_sequential.py:17-213), the counterpart of
``dfd_tpu.runners.sequential.SequentialRunner``.

This topology exists for (a) parity verification against the reference and
the JAX package on deterministic envs and (b) small runs; the production
path is :mod:`dfd_tpu_torch.runners.vectorized`.  Its host classes (learner,
optimizer, omega, noise, statistics, samplers) are numpy copies of the JAX
package's; the policy's forwards, the env's steps and the novelty scoring
run on the model's and the env's devices.  The loop per epoch:

1. collect returns one episode at a time until ``batch_size`` non-eval
   returns arrived; eval returns (probability ``eval_prob``) update the EMA
   policy reward/entropy/novelty and replace random zeta frames;
2. if any eval arrived: re-evaluate the strategy archive on the new zeta and
   step omega with the mean noisy reward;
3. one FD learner step; optional VBN refresh; archive the updated policy;
   push the new FDState to the worker; report metrics.

Wiring note: the reference's own sequential runner passes ``ent_coef`` and
``max_delayed_return`` *positionally* into ``FiniteDifferences`` slots that
are actually ``noise_std`` and ``batch_size`` (run_sequential.py:97 vs
finite_differences.py:7), silently running the learner with sigma=0 — which
NaNs the first DSGD step.  This runner wires the learner by keyword.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from dfd_tpu_torch.core.device import full_f32
from dfd_tpu_torch.core.noise import RNGNoiseSource
from dfd_tpu_torch.envs.wrappers import frame_of
from dfd_tpu_torch.fd.dsgd import DSGD
from dfd_tpu_torch.fd.learner import FDLearner
from dfd_tpu_torch.fd.omega import AdaptiveOmega
from dfd_tpu_torch.fd.returns import FDState
from dfd_tpu_torch.novelty.handler import StrategyHandler
from dfd_tpu_torch.runners.agent import Agent
from dfd_tpu_torch.runners.policy import HostPolicy, NumpySampler
from dfd_tpu_torch.runners.worker import Worker
from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer


class SequentialRunner:
    def __init__(
        self,
        model,
        env,
        distance_fn,
        opt_cls=DSGD,
        learning_rate: float = 0.01,
        noise_std: float = 0.02,
        batch_size: int = 40,
        ent_coef: float = 0.0,
        random_seed: int = 123,
        max_delayed_return: int = 10,
        vbn_buffer_size: int = 0,
        zeta_size: int = 200,
        max_strategy_history_size: int = 200,
        eval_prob: float = 0.05,
        normalize_obs: bool = False,
        omega_kwargs: Optional[dict] = None,
        sampler=None,
        initial_flat: Optional[np.ndarray] = None,
        reporter: Optional[EpochReporter] = None,
    ):
        self.rng = np.random.RandomState(random_seed)           # zeta shuffles (train loop)
        self._buffer_rng = np.random.RandomState(random_seed)   # initial-buffer actions only
        self.batch_size = batch_size
        self.zeta_size = zeta_size

        omega_kwargs = omega_kwargs or {}
        omega_kwargs.setdefault("improvement_threshold", 1.035)
        omega_kwargs.setdefault("reward_history_size", 20)
        omega_kwargs.setdefault("steps_to_min", 25)
        omega_kwargs.setdefault("steps_to_max", 75)
        self.omega = AdaptiveOmega(**omega_kwargs)

        self.model = model
        self.env = env
        sampler = sampler if sampler is not None else NumpySampler(random_seed)
        self.policy = HostPolicy(model, flat=initial_flat, seed=random_seed, sampler=sampler)

        self.optimizer = opt_cls(model.num_params, lr=learning_rate)
        noise_source = RNGNoiseSource(model.num_params, random_seed=random_seed)
        self.strategy_handler = StrategyHandler(
            model, self.policy.bn_state, distance_fn, max_history_size=max_strategy_history_size
        )
        self.agent = Agent(self.policy, env, random_seed, normalize_obs=normalize_obs)
        self.worker = Worker(
            self.policy,
            self.agent,
            noise_source,
            self.strategy_handler,
            sigma=noise_std,
            random_seed=random_seed,
            eval_prob=eval_prob,
        )
        self.learner = FDLearner(
            self.policy.get_trainable_flat(),
            self.optimizer,
            self.omega,
            noise_source,
            noise_std=noise_std,
            batch_size=batch_size,
            ent_coef=ent_coef,
            max_delayed_return=max_delayed_return,
        )

        self.policy_reward = 0.0
        self.policy_entropy = 0.0
        self.policy_novelty = 0.0
        self.reporter = reporter or EpochReporter()
        self.timer = StageTimer()

        self.zeta, self.vbn_buffer = self._sample_initial_buffers(vbn_buffer_size)

        self.current_state = FDState(
            strategy_frames=self.zeta,
            strategy_history=self.strategy_handler.strategy_tensor,
            policy_params=self.policy.serialize(),
            epoch=0,
            experiment_id=1234,
        )

    # -- training ----------------------------------------------------------------

    @full_f32()
    def train(self, n_epochs: int) -> None:
        zeta = self.zeta
        idxs = list(range(len(zeta)))

        self.strategy_handler.add_policy(self.policy.get_trainable_flat())
        self.worker.update(self.current_state)

        for _ in range(n_epochs):
            t1 = time.perf_counter()
            rets, ret_rewards, ret_novelties = [], [], []
            any_eval = False
            with self.timer.stage("rollout"):
                while len(rets) < self.batch_size:
                    for ret in self.worker.collect_returns():
                        if ret.is_eval:
                            any_eval = True
                            self.policy_reward = self.policy_reward * 0.9 + ret.reward * 0.1
                            self.policy_entropy = self.policy_entropy * 0.9 + ret.entropy * 0.1
                            self.policy_novelty = self.policy_novelty * 0.9 + ret.novelty * 0.1
                            self.rng.shuffle(idxs)
                            zeta[idxs[: len(ret.eval_states)]] = np.asarray(ret.eval_states)[: self.zeta_size]
                        else:
                            rets.append(ret)
                            ret_rewards.append(ret.reward)
                            ret_novelties.append(ret.novelty)

            if any_eval:
                with self.timer.stage("archive"):
                    self.strategy_handler.set_zeta(zeta)
                self.omega.step(np.mean(ret_rewards))

            with self.timer.stage("learner"):
                update_magnitude = self.learner.step(
                    rets, self.policy_reward, self.policy_novelty, self.policy_entropy
                )
                self.policy.set_trainable_flat(self.learner.flat)

                if self.vbn_buffer is not None:
                    self.policy.compute_vbn(self.vbn_buffer)

            if update_magnitude > 0:
                with self.timer.stage("archive"):
                    self.strategy_handler.add_policy(self.policy.get_trainable_flat())
                self.current_state.strategy_frames = zeta
                self.current_state.strategy_history = self.strategy_handler.strategy_tensor
                self.current_state.policy_params = self.policy.serialize()
                self.current_state.epoch = self.learner.epoch
                self.worker.update(self.current_state)

            # drain stage totals every epoch so a skipped (zero-update)
            # epoch's time is never misattributed to a later report
            stage_report = self.timer.report()
            if update_magnitude > 0:
                report = {
                    "Epoch": self.learner.epoch,
                    "Epoch Time": time.perf_counter() - t1,
                    "Cumulative Timesteps": self.agent.cumulative_timesteps,
                    "Policy Reward": self.policy_reward,
                    "Policy Entropy": self.policy_entropy,
                    "Policy Novelty": self.policy_novelty,
                    "Noisy Reward": float(np.mean(ret_rewards)),
                    "Noisy Novelty": float(np.mean(ret_novelties)),
                    "Update Magnitude": update_magnitude,
                    "Omega": self.omega.omega,
                }
                report.update(stage_report)
                self.reporter.report(report)

    # -- helpers -----------------------------------------------------------------

    def _sample_initial_buffers(self, vbn_buffer_size: int):
        zeta, vbn = [], []
        obs = self.env.reset()
        n = max(vbn_buffer_size, self.zeta_size)
        for i in range(n):
            # zeta carries plain frames (dict observations contribute their
            # frame only — see envs.wrappers.frame_of); the VBN buffer keeps
            # the raw observations so recurrent policies feed the buffer's
            # real rewards through the LSTM during the refresh, like the
            # reference's stacked dict-obs VBN (reference policies/impala.py:12-16)
            if i < self.zeta_size:
                zeta.append(frame_of(obs))
            if vbn_buffer_size > 0 and i < vbn_buffer_size:
                vbn.append(obs)
            a = self._random_action()
            obs, _, done, _ = self.env.step(a)
            if done:
                obs = self.env.reset()
        if vbn_buffer_size <= 0:
            vbn_arr = None
        elif isinstance(vbn[0], dict):
            vbn_arr = vbn  # HostPolicy.compute_vbn stacks frames + rewards
        else:
            vbn_arr = np.asarray(vbn)
        return np.asarray(zeta), vbn_arr

    def _random_action(self):
        if self.model.discrete:
            return int(self._buffer_rng.randint(self.env.n_actions))
        return self._buffer_rng.uniform(-1, 1, size=self.model.output_shape)
