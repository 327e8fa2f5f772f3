"""Distributed learner process (reference run_server.py:19-243), the
counterpart of ``dfd_tpu.runners.server.ServerRunner``.

Owns the FD learner and an in-process control-plane server; elastic
clients stream returns in and receive FDState broadcasts.  Per loop: block
for a batch (LIFO, epoch-age classified), merge per-return observation-stat
deltas into the global Welford, fold eval returns into the EMA baselines and
zeta, step omega, one learner step, optional VBN, archive the policy,
re-broadcast state, report (with Delayed Ratio / Discarded Returns).

The learner's host classes are the numpy copies of the sequential topology;
the policy, the VBN refresh, the archive's strategy forwards and the
counter-noise decode run on ``device`` (the card unless the caller passes
``"cpu"``).  A counter-mode learner decodes each return with one
``normal_kernel`` launch and copies it to the host (``CounterNoise.decode``),
one return at a time, as the JAX learner decodes.  The device is local to
the process and never a wire field: the broadcast ``cfg`` is the JAX
package's, key for key, so a JAX client trains against a port learner and a
port client against a JAX learner.

This topology trades the vectorized trainer's throughput for the
reference's elasticity: clients join/leave/retarget at will.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

import numpy as np

from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise, RNGNoiseSource
from dfd_tpu_torch.core.welford import Welford
from dfd_tpu_torch.distributed.server import GRPCWorker
from dfd_tpu_torch.envs.wrappers import frame_of
from dfd_tpu_torch.fd.dsgd import DSGD
from dfd_tpu_torch.fd.learner import FDLearner
from dfd_tpu_torch.fd.omega import AdaptiveOmega
from dfd_tpu_torch.fd.returns import FDState
from dfd_tpu_torch.novelty.handler import StrategyHandler
from dfd_tpu_torch.runners.policy import HostPolicy
from dfd_tpu_torch.utils.factory import get_init_data
from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer


class ServerRunner:
    def __init__(
        self,
        env_id: str = "SimpleTrapEnv-v0",
        opt_cls=DSGD,
        normalize_obs: bool = True,
        obs_stats_update_chance: float = 0.01,
        timestep_limit: int = 50_000_000,
        learning_rate: float = 0.01,
        noise_std: float = 0.02,
        batch_size: int = 40,
        ent_coef: float = 0.0,
        random_seed: int = 123,
        max_delayed_return: int = 100,
        vbn_buffer_size: int = 0,
        zeta_size: int = 2,
        max_strategy_history_size: int = 2,
        eval_prob: float = 0.05,
        omega_kwargs: Optional[dict] = None,
        address: str = "localhost",
        port: int = 1025,
        noise_kind: str = "pcg",
        antithetic: bool = False,
        reporter: Optional[EpochReporter] = None,
        device=None,
    ):
        """``noise_kind``: "pcg" = the reference's replayable PCG64 streams
        (thin clients sample locally); "counter" = counter-keyed noise so
        fat clients (BatchedHostEvaluator shards) encode members as ids.
        ``antithetic`` (counter mode only): member ids 2k/2k+1 decode to
        mirrored +-eps_k pairs — clients must evaluate ids in even-aligned
        pairs for the variance reduction to engage.  ``device``: where the
        model, the policy's forwards and the noise decode run (``None``: the
        card)."""
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(random_seed)
        self._buffer_rng = np.random.RandomState(random_seed)
        self.batch_size = batch_size
        self.zeta_size = zeta_size
        self.timestep_limit = timestep_limit
        self.normalize_obs = normalize_obs
        self.address, self.port = address, port

        omega_kwargs = omega_kwargs or {}
        omega_kwargs.setdefault("default_value", 1)
        omega_kwargs.setdefault("improvement_threshold", 1.035)
        omega_kwargs.setdefault("reward_history_size", 20)
        omega_kwargs.setdefault("steps_to_min", 25)
        omega_kwargs.setdefault("steps_to_max", 75)
        self.omega = AdaptiveOmega(**omega_kwargs)

        self.env, self.model, distance_fn = get_init_data(env_id, random_seed, self.device)
        self.policy = HostPolicy(self.model, seed=random_seed)
        if antithetic and noise_kind != "counter":
            raise ValueError("antithetic mode requires noise_kind='counter'")
        if noise_kind == "counter":
            noise_source = CounterNoise(
                self.model.num_params, random_seed=random_seed, antithetic=antithetic,
                device=self.device,
            )
        else:
            noise_source = RNGNoiseSource(self.model.num_params, random_seed=random_seed)
        self.strategy_handler = StrategyHandler(
            self.model, self.policy.bn_state, distance_fn, max_history_size=max_strategy_history_size
        )
        self.learner = FDLearner(
            self.policy.get_trainable_flat(),
            opt_cls(self.model.num_params, lr=learning_rate),
            self.omega,
            noise_source,
            noise_std=noise_std,
            batch_size=batch_size,
            ent_coef=ent_coef,
            max_delayed_return=max_delayed_return,
        )

        self.policy_reward = None
        self.policy_entropy = None
        self.policy_novelty = None
        self.global_obs_stats = Welford(self.model.input_shape)
        self.reporter = reporter or EpochReporter()
        self.timer = StageTimer()
        self.zeta, self.vbn_buffer = self._sample_initial_buffers(vbn_buffer_size)

        self.current_state = FDState(
            experiment_id=uuid.uuid1().hex,
            strategy_frames=self.zeta,
            strategy_history=self.strategy_handler.strategy_tensor,
            policy_params=self.policy.serialize(),
            obs_stats=self.global_obs_stats.serialize(),
            epoch=self.learner.epoch,
            cfg={
                "env_id": env_id,
                "noise_std": noise_std,
                "normalize_obs": normalize_obs,
                "obs_stats_update_chance": obs_stats_update_chance,
                "random_seed": random_seed,
                "eval_prob": eval_prob,
                "max_strategy_history_size": max_strategy_history_size,
                "noise_kind": noise_kind,
                "antithetic": antithetic,
                # the shared counter-noise base seed: unlike random_seed this
                # is NEVER mutated per client — every shard must regenerate
                # identical noise for a given (epoch, member id)
                "noise_seed": random_seed,
            },
        )
        self.worker = GRPCWorker(self.current_state)

    # -- training ----------------------------------------------------------------

    @full_f32()
    def train(self, max_epochs: Optional[int] = None) -> None:
        cumulative_timesteps = 0
        zeta = self.zeta
        idxs = list(range(len(zeta)))
        self.strategy_handler.add_policy(self.policy.get_trainable_flat())
        self.worker.update(self.current_state)
        bound_port = self.worker.start(address=self.address, port=self.port)
        self.bound_port = bound_port

        t1 = time.perf_counter()
        epochs_done = 0
        try:
            while cumulative_timesteps < self.timestep_limit:
                if max_epochs is not None and epochs_done >= max_epochs:
                    break
                with self.timer.stage("collect"):
                    returns, timesteps, n_delayed, n_discarded = self.worker.collect_returns(
                        batch_size=self.batch_size,
                        current_epoch=self.learner.epoch,
                        max_delayed_return=self.learner.max_delayed_return,
                    )
                self.learner.discarded_returns += n_discarded
                cumulative_timesteps += timesteps

                ret_rewards, ret_novelties, non_eval = [], [], []
                any_eval = False
                for ret in returns:
                    if len(ret.obs_stats_update) > 0:
                        self.global_obs_stats.merge_serialized(ret.obs_stats_update)
                    if ret.is_eval:
                        any_eval = True
                        if self.policy_reward is None:
                            self.policy_reward = ret.reward
                            self.policy_entropy = ret.entropy
                            self.policy_novelty = ret.novelty
                        else:
                            self.policy_reward = self.policy_reward * 0.9 + ret.reward * 0.1
                            self.policy_entropy = self.policy_entropy * 0.9 + ret.entropy * 0.1
                            self.policy_novelty = self.policy_novelty * 0.9 + ret.novelty * 0.1
                        self.rng.shuffle(idxs)
                        zeta[idxs[: len(ret.eval_states)]] = np.asarray(ret.eval_states)[: self.zeta_size]
                    else:
                        non_eval.append(ret)
                        ret_rewards.append(ret.reward)
                        ret_novelties.append(ret.novelty)

                if any_eval:
                    with self.timer.stage("archive"):
                        self.strategy_handler.set_zeta(zeta)
                    if ret_rewards:
                        self.omega.step(np.mean(ret_rewards))

                with self.timer.stage("learner"):
                    update_magnitude = self.learner.step(
                        non_eval, self.policy_reward, self.policy_novelty, self.policy_entropy
                    )
                    self.policy.set_trainable_flat(self.learner.flat)
                    if self.vbn_buffer is not None:
                        self.policy.compute_vbn(self.vbn_buffer)

                if update_magnitude > 0 and ret_rewards:
                    with self.timer.stage("archive"):
                        self.strategy_handler.add_policy(self.policy.get_trainable_flat())
                # drain stage totals every epoch so a skipped (zero-update)
                # epoch's time is never misattributed to a later report
                stage_report = self.timer.report()
                if update_magnitude > 0 and ret_rewards:
                    epoch_time = time.perf_counter() - t1
                    t1 = time.perf_counter()
                    report = {
                        "Epoch": self.learner.epoch,
                        "Epoch Time": epoch_time,
                        "Cumulative Timesteps": cumulative_timesteps,
                        "Policy Reward": self.policy_reward,
                        "Policy Entropy": self.policy_entropy,
                        "Policy Novelty": self.policy_novelty,
                        "Noisy Reward": float(np.mean(ret_rewards)),
                        "Noisy Novelty": float(np.mean(ret_novelties)),
                        "Delayed Ratio": n_delayed / max(len(non_eval), 1),
                        "Update Magnitude": update_magnitude,
                        "Omega": self.omega.omega,
                        "Discarded Returns": self.learner.discarded_returns,
                    }
                    report.update(stage_report)
                    self.reporter.report(report)
                epochs_done += 1

                self.current_state.strategy_frames = zeta
                self.current_state.strategy_history = self.strategy_handler.strategy_tensor
                self.current_state.policy_params = self.policy.serialize()
                self.current_state.epoch = self.learner.epoch
                self.current_state.obs_stats = self.global_obs_stats.serialize()
                self.worker.update(self.current_state)
        finally:
            self.worker.stop()

    # -- helpers -----------------------------------------------------------------

    def _sample_initial_buffers(self, vbn_buffer_size: int):
        zeta, vbn = [], []
        obs = self.env.reset()
        for i in range(max(vbn_buffer_size, self.zeta_size)):
            # zeta carries plain frames (see envs.wrappers.frame_of); the
            # VBN buffer keeps the raw observations so recurrent policies
            # feed the buffer's real rewards through the LSTM during the
            # refresh (reference policies/impala.py:12-16)
            frame = frame_of(obs)
            if self.normalize_obs:
                self.global_obs_stats.increment(frame, 1)
            if i < self.zeta_size:
                zeta.append(frame)
            if vbn_buffer_size > 0 and i < vbn_buffer_size:
                vbn.append(obs)
            obs, _, done, _ = self.env.step(self._random_action())
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
