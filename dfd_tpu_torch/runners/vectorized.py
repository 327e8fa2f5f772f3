"""The population trainer: one epoch of perturb, rollout, novelty, fitness,
combine and DSGD, run on the device as the counterpart of
``dfd_tpu.runners.vectorized.VectorizedTrainer``.

One epoch (``_epoch_step``) is

1. perturb: theta_i = theta + sigma eps_i, eps regenerated from counters in
   the perturb kernel (``noise_backend="pallas"``);
2. the population rollout, with the deterministic eval episode riding along
   as member P (zero noise);
3. novelty of each member against the archive;
4. fitness: baseline-subtract and standardize, with the tie-break signs;
5. combine: g = sum_i f_i sigma eps_i / ||sigma eps_i||^2 in the combine
   kernel, which regenerates the same eps;
6. DSGD at an omega-scaled learning rate;
7. the zeta, EMA and Welford refreshes.

The strategy archive's accept/evict logic stays on the host between epochs.

Randomness: the JAX trainer keys every stochastic choice through
``jax.random``.  The port takes them as one :class:`EpochDraws` per epoch
from ``draw_source(epoch)``; by default they come from the trainer's own
``torch.Generator`` on its device, and a test can feed it JAX's own draws to
hold the port to the JAX trainer epoch by epoch.

The public entry points (``train``, ``train_fast``, ``train_to_timesteps``)
run their float32 products in full float32 whatever the caller's TF32
settings (:func:`dfd_tpu_torch.core.device.full_f32`), as the JAX package's
tolerances assume.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.core import welford
from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.fd import combine as fd_combine
from dfd_tpu_torch.fd import rollout as fd_rollout
from dfd_tpu_torch.fd.dsgd import DSGDParams, dsgd_update, lr_scale_from_omega
from dfd_tpu_torch.fd.omega import OmegaParams, OmegaState, omega_init, omega_step
from dfd_tpu_torch.models.base import PolicyModel
from dfd_tpu_torch.novelty.handler import StrategyHandler
from dfd_tpu_torch.ops.perturb import combine, noise_sumsq, perturb
from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer


class TrainState(NamedTuple):
    flat: torch.Tensor            # [d] trainable parameters
    bn_state: Any                 # non-trainable model state
    omega: OmegaState
    obs_stats: welford.WelfordState
    zeta: torch.Tensor            # [Z, *obs]
    policy_reward: torch.Tensor   # EMA scalars
    policy_entropy: torch.Tensor
    policy_novelty: torch.Tensor
    epoch: int


class EpochDraws(NamedTuple):
    """Every random number one epoch consumes (M = P + 1 with the eval slot)."""

    action_gumbel: torch.Tensor  # [M, T, A] Gumbel noise of each sampled action
    stats_uniform: torch.Tensor  # [M, T] coin of the sampled observation statistics
    tie_signs: torch.Tensor      # [P] +-1 fitness of an all-equal batch
    zeta_perm: torch.Tensor      # [Z] zeta slots the eval states replace
    reset_level: torch.Tensor    # [M] int64 level of each episode, in [0, num_levels)


def make_draws(generator: torch.Generator, P: int, T: int, A: int, Z: int,
               num_levels: int = 1) -> EpochDraws:
    """One epoch's draws from ``generator``, on its device."""
    dev = generator.device
    u = torch.rand((P + 1, T, A), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
    stats_uniform = torch.rand((P + 1, T), generator=generator, device=dev)
    bits = torch.randint(0, 2, (P,), generator=generator, device=dev)
    tie_signs = (2 * bits - 1).to(torch.float32)
    zeta_perm = torch.randperm(Z, generator=generator, device=dev)
    reset_level = torch.randint(0, num_levels, (P + 1,), generator=generator, device=dev)
    return EpochDraws(gumbel, stats_uniform, tie_signs, zeta_perm, reset_level)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})")


class VectorizedTrainer:
    def __init__(
        self,
        model: PolicyModel,
        env: TorchEnv,
        distance_fn,
        cfg: TrainConfig,
        mesh=None,
        reporter: Optional[EpochReporter] = None,
        *,
        device=None,
        draw_source: Optional[Callable[[int], EpochDraws]] = None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise _not_ported("a device mesh", "multi-device")
        if cfg.noise_backend != "pallas":
            raise _not_ported(f"noise_backend={cfg.noise_backend!r}", "the jax noise backend")
        if cfg.population_chunk and cfg.population_chunk < cfg.batch_size:
            raise _not_ported("population_chunk", "population chunking")
        if cfg.envs_per_perturbation != 1:
            raise _not_ported("envs_per_perturbation > 1", "E > 1 episodes per member")
        if cfg.vbn_buffer_size > 0:
            raise _not_ported("vbn_buffer_size > 0", "VBN")
        if cfg.zeta_size <= 0:
            raise _not_ported("zeta_size == 0", "the unfused eval episode")
        if not env.discrete:
            raise _not_ported("a continuous action space", "GaussianMLP")
        if model.device != self.device or env.device != self.device:
            raise ValueError(
                f"model ({model.device}) and env ({env.device}) must live on {self.device}"
            )
        self.model = model
        self.env = env
        self.distance_fn = distance_fn
        self.cfg = cfg
        self.reporter = reporter or EpochReporter(quiet=True)

        self.P = cfg.batch_size
        self.horizon = cfg.episode_length or env.max_episode_steps
        if cfg.antithetic and self.P % 2 != 0:
            raise ValueError("antithetic mode pairs members 2k/2k+1: batch_size must be even")

        params, bn_state = model.init(cfg.random_seed)
        flat = model.get_flat(params)
        self.handler = StrategyHandler(
            model, bn_state, distance_fn, max_history_size=cfg.max_strategy_history_size
        )
        self.H = cfg.max_strategy_history_size
        self.dsgd_hp = DSGDParams(
            lr=cfg.learning_rate,
            sqrt_d=float(np.sqrt(model.num_params)),
            min_scale=cfg.dsgd_min_scale,
            max_scale=cfg.dsgd_max_scale,
        )
        self.omega_hp = OmegaParams(
            improvement_threshold=cfg.omega.improvement_threshold,
            min_omega=cfg.omega.min_value,
            max_omega=cfg.omega.max_value,
            increase=1.0 / cfg.omega.steps_to_max,
            decrease=1.0 / cfg.omega.steps_to_min,
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.random_seed)
        self.draw_source = draw_source or self._own_draws

        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)
        self.state = TrainState(
            flat=flat,
            bn_state=bn_state,
            omega=omega_init(cfg.omega.default_value, cfg.omega.reward_history_size, self.device),
            obs_stats=welford.init(env.obs_shape, self.device),
            zeta=self._seed_buffer(cfg.zeta_size),
            policy_reward=zero(),
            policy_entropy=zero(),
            policy_novelty=zero(),
            epoch=0,
        )
        self.cumulative_timesteps = 0
        self._last_archived = None
        self.timer = StageTimer()

    # -- public ------------------------------------------------------------------

    def _archive_current(self) -> None:
        """Submit the current policy unless it is already the latest archive
        entry (guards chained train calls against duplicate snapshots)."""
        flat = self.state.flat.cpu().numpy()
        if self._last_archived is not None and np.array_equal(flat, self._last_archived):
            return
        self.handler.add_policy(flat)
        self._last_archived = flat.copy()

    @full_f32()
    def train(self, n_epochs: int) -> None:
        """Reference-cadence training: one epoch step at a time with the
        strategy archive refreshed on host between epochs."""
        self._archive_current()
        for _ in range(n_epochs):
            t0 = time.perf_counter()
            with self.timer.stage("archive"):
                archive, count = self._archive_inputs()
            with self.timer.stage("device_step"):
                self.state, metrics = self._epoch_step(self.state, archive, count)
                # one device-to-host transfer for the whole metrics dict
                m = _fetch([metrics])[0]
            self.cumulative_timesteps += int(m.pop("_timesteps"))

            did_eval = m.pop("_did_eval") > 0
            with self.timer.stage("archive"):
                if did_eval:
                    # re-evaluate the archive on the refreshed zeta
                    # (reference run_sequential.py:146-147)
                    self.handler.set_zeta(self.state.zeta.cpu().numpy())
                if m["Update Magnitude"] > 0:
                    self._archive_current()

            m.update(
                {
                    "Epoch": self.state.epoch,
                    "Epoch Time": time.perf_counter() - t0,
                    "Cumulative Timesteps": self.cumulative_timesteps,
                }
            )
            m.update(self.timer.report())
            self.reporter.report(m)

    @full_f32()
    def train_fast(self, n_epochs: int, sync_every: int = 10) -> None:
        """Throughput mode: chunks of ``sync_every`` epochs run back to back
        with no host synchronisation inside a chunk; metrics are fetched in
        one transfer after the chunk.

        Within a chunk the novelty archive tensor is frozen; archive
        submission and the zeta re-evaluation happen at chunk boundaries.
        Everything else is identical to :meth:`train`."""
        self._archive_current()
        done = 0
        while done < n_epochs:
            n = min(sync_every, n_epochs - done)
            t0 = time.perf_counter()
            with self.timer.stage("archive"):
                archive, count = self._archive_inputs()
            per_epoch = []
            with self.timer.stage("device_step"):
                for _ in range(n):
                    self.state, metrics = self._epoch_step(self.state, archive, count)
                    per_epoch.append(metrics)
                per_epoch = _fetch(per_epoch)
            chunk_time = time.perf_counter() - t0

            any_eval = False
            for j, m in enumerate(per_epoch):
                self.cumulative_timesteps += int(m.pop("_timesteps"))
                any_eval |= m.pop("_did_eval") > 0
                m.update(
                    {
                        "Epoch": self.state.epoch - n + 1 + j,
                        "Epoch Time": chunk_time / n,
                        "Cumulative Timesteps": self.cumulative_timesteps,
                    }
                )
                if j == n - 1:  # stage totals attach to the chunk's last epoch
                    with self.timer.stage("archive"):
                        if any_eval:
                            self.handler.set_zeta(self.state.zeta.cpu().numpy())
                        self._archive_current()
                    m.update(self.timer.report())
                self.reporter.report(m)
            done += n

    @full_f32()
    def train_to_timesteps(self, timestep_limit: int, sync_every: int = 10) -> None:
        """Train until ``cumulative_timesteps`` reaches the limit (the
        reference server's budget semantic, run_server.py:25)."""
        while self.cumulative_timesteps < timestep_limit:
            self.train_fast(sync_every, sync_every=sync_every)

    # -- one epoch ---------------------------------------------------------------

    def _epoch_step(self, state: TrainState, archive: torch.Tensor, archive_count: int):
        cfg = self.cfg
        model = self.model
        P = self.P
        Z = state.zeta.shape[0]
        draws = self._checked_draws(state.epoch, Z)
        do_eval = state.epoch % cfg.eval_every == 0
        obs_mean, obs_std = welford.mean_std(state.obs_stats)

        # 1. perturb: theta_i = theta + sigma * eps_i (eps from counter ids)
        pop_flats = perturb(
            state.flat, cfg.noise_std, cfg.random_seed, state.epoch, P,
            antithetic=cfg.antithetic,
        )
        noise_ssq = noise_sumsq(pop_flats, state.flat, cfg.noise_std)
        # 2. rollout, the deterministic eval episode riding along as member P
        all_params = model.set_flat(torch.cat([pop_flats, state.flat[None]], dim=0))
        det = torch.zeros(P + 1, dtype=torch.bool, device=self.device)
        det[P] = True
        res = fd_rollout.episode_rollout(
            model, self.env, all_params, state.bn_state, self.horizon, det,
            obs_mean=obs_mean, obs_std=obs_std,
            normalize_obs=cfg.normalize_obs,
            obs_stats_update_chance=cfg.obs_stats_update_chance,
            action_gumbel=draws.action_gumbel,
            stats_uniform=draws.stats_uniform,
            reset_level=draws.reset_level,
            collect_limit=Z,
        )
        # 3. novelty of every member (and the eval member) vs the archive
        novelty_all = self._batch_novelty(all_params, state, archive, archive_count)
        rewards = res.reward[:P]
        novelty = novelty_all[:P]

        # 4. eval episode (member P); contributes only on eval epochs
        policy_reward, policy_entropy, policy_novelty = (
            state.policy_reward, state.policy_entropy, state.policy_novelty,
        )
        zeta, omega = state.zeta, state.omega
        eval_steps = torch.zeros((), dtype=torch.int64, device=self.device)
        eval_stats = welford.init(self.env.obs_shape, self.device)
        noisy_mean = rewards.mean()
        if do_eval:
            ema = lambda old, new: old * 0.9 + new * 0.1
            policy_reward = ema(policy_reward, res.reward[P])
            policy_entropy = ema(policy_entropy, res.entropy[P])
            policy_novelty = ema(policy_novelty, novelty_all[P])
            eval_steps = res.steps[P]
            eval_stats = welford.WelfordState(*(x[P] for x in res.obs_stats))
            # 5. zeta refresh from the eval episode's visited states
            zeta = self._update_zeta(state.zeta, res.states[P], eval_steps, draws.zeta_perm)
            # 6. omega steps on eval epochs with the mean noisy reward
            omega = omega_step(state.omega, noisy_mean, self.omega_hp)

        # 7. fitness -> combine -> DSGD
        fitness = fd_combine.fitness_from_rewards(rewards, policy_reward, draws.tie_signs)
        coefs = fitness / (cfg.noise_std * torch.clamp_min(noise_ssq, 1e-30))
        gradient = combine(coefs, cfg.random_seed, state.epoch, model.num_params,
                           antithetic=cfg.antithetic)
        if cfg.optimizer == "dsgd":
            lr_scale = lr_scale_from_omega(
                omega.omega, cfg.omega.min_value, cfg.omega.max_value,
                cfg.dsgd_min_scale, cfg.dsgd_max_scale,
            )
            new_flat = dsgd_update(state.flat, -gradient, lr_scale, self.dsgd_hp)
        else:  # plain SGD on grad = -g (net ascent), reference opt_fn alternative
            new_flat = state.flat + cfg.learning_rate * gradient
        update_size = torch.sqrt(torch.sum((new_flat - state.flat) ** 2))

        # 8. merge sampled observation statistics from the population
        obs_stats = state.obs_stats
        if cfg.normalize_obs:
            pop_stats = welford.WelfordState(*(x[:P] for x in res.obs_stats))
            obs_stats = welford.merge(obs_stats, welford.merge_population(pop_stats))
            obs_stats = welford.merge(obs_stats, eval_stats)

        new_state = TrainState(
            flat=new_flat,
            bn_state=state.bn_state,
            omega=omega,
            obs_stats=obs_stats,
            zeta=zeta,
            policy_reward=policy_reward,
            policy_entropy=policy_entropy,
            policy_novelty=policy_novelty,
            epoch=state.epoch + 1,
        )
        metrics = {
            "Policy Reward": policy_reward,
            "Policy Entropy": policy_entropy,
            "Policy Novelty": policy_novelty,
            "Noisy Reward": noisy_mean,
            "Noisy Novelty": novelty.mean(),
            "Update Magnitude": update_size,
            "Omega": omega.omega,
            "_timesteps": res.steps[:P].sum() + eval_steps,
            "_did_eval": int(do_eval),
        }
        return new_state, metrics

    # -- pieces ------------------------------------------------------------------

    def _own_draws(self, epoch: int) -> EpochDraws:
        return make_draws(self.generator, self.P, self.horizon, self.env.n_actions,
                          self.state.zeta.shape[0], self.env.num_levels)

    def _checked_draws(self, epoch: int, Z: int) -> EpochDraws:
        draws = EpochDraws(*(x.to(self.device) for x in self.draw_source(epoch)))
        M, T, A = self.P + 1, self.horizon, self.env.n_actions
        expect = ((M, T, A), (M, T), (self.P,), (Z,), (M,))
        got = tuple(tuple(x.shape) for x in draws)
        if got != expect:
            raise ValueError(f"draw_source gave shapes {got}, expected {expect}")
        return draws

    def _batch_novelty(self, pop_params, state: TrainState, archive, archive_count: int):
        """Min behavioral distance to the archive; 0 when the archive has <2
        entries, and then, like the reference's guard
        (strategy_handler.py:25-31), no strategy forward runs at all."""
        M = next(iter(pop_params.values()))["w"].shape[0]
        if archive_count < 2:
            return torch.zeros(M, dtype=torch.float32, device=self.device)
        strat = self.model.strategy(pop_params, state.bn_state, state.zeta)
        dists = self.distance_fn(strat[:, None], archive[None], xp=torch)  # [M, H]
        idx = torch.arange(archive.shape[0], device=self.device)
        dists = torch.where(idx < archive_count, dists, torch.inf)
        return dists.amin(dim=1)

    def _update_zeta(self, zeta, states, steps, perm):
        """Replace a random permutation of zeta slots with the first visited
        eval states (reference run_sequential.py:142-143 semantics)."""
        Z = zeta.shape[0]
        n_valid = torch.clamp_max(steps, Z)
        valid = (torch.arange(Z, device=self.device) < n_valid).reshape(
            (Z,) + (1,) * (zeta.ndim - 1)
        )
        new_zeta = zeta.clone()
        new_zeta[perm] = torch.where(valid, states[:Z], zeta[perm])
        return new_zeta

    def _archive_inputs(self):
        """Fixed-shape archive tensor [H, Z, F] on the device + valid count."""
        t = self.handler.strategy_tensor
        Z = self.state.zeta.shape[0]
        full = np.zeros((self.H, Z, self.model.output_shape), np.float32)
        count = 0
        if isinstance(t, np.ndarray) and t.ndim == 3:
            count = min(len(t), self.H)
            full[:count] = t[:count]
        return torch.as_tensor(full, device=self.device), count

    def _seed_buffer(self, n: int) -> torch.Tensor:
        """Observation buffer from a random-action rollout of one env
        (reference run_sequential.py:198-213)."""
        env = self.env
        actions = torch.randint(0, env.n_actions, (n,), generator=self.generator,
                                device=self.device)
        levels = torch.randint(0, env.num_levels, (n + 1,), generator=self.generator,
                               device=self.device)  # one level draw per reset
        env_state, obs = env.reset(1, levels[:1])
        buf = []
        for k in range(n):
            buf.append(obs[0])
            new_state, new_obs, _, done = env.step(env_state, actions[k:k + 1])
            reset_state, reset_obs = env.reset(1, levels[k + 1:k + 2])
            env_state = type(new_state)(
                *(torch.where(done, r, s) for r, s in zip(reset_state, new_state))
            )
            obs = torch.where(done[:, None], reset_obs, new_obs)
        return torch.stack(buf)


def _fetch(per_epoch: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Every epoch's metrics as floats, in one device-to-host transfer."""
    keys = [k for k, v in per_epoch[0].items() if isinstance(v, torch.Tensor)]
    stacked = torch.stack(
        [torch.stack([m[k].to(torch.float64) for k in keys]) for m in per_epoch]
    ).cpu().tolist()
    out = []
    for m, row in zip(per_epoch, stacked):
        vals = dict(zip(keys, row))
        out.append({k: vals[k] if k in vals else float(v) for k, v in m.items()})
    return out
