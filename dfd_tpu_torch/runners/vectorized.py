"""The population trainer: one epoch of perturb, rollout, novelty, fitness,
combine and DSGD, run on the device as the counterpart of
``dfd_tpu.runners.vectorized.VectorizedTrainer``.

One epoch (``_epoch_step``) is

1. perturb: theta_i = theta + sigma eps_i, eps drawn from the counters
   (epoch, i): JAX's threefry normal in ``normal_kernel``, which writes eps
   and the perturbed rows in one pass (``noise_backend="jax"``, the
   default), or the counter hash of the perturb kernel
   (``noise_backend="pallas"``);
2. the population rollout, E episodes a member (``envs_per_perturbation``)
   averaged, with the deterministic eval episode riding along as member P
   (zero noise) where ``zeta_size > 0``, else run alone on eval epochs;
3. novelty of each member against the archive;
4. fitness: baseline-subtract and standardize, with the tie-break signs;
5. combine: g = sum_i f_i sigma eps_i / ||sigma eps_i||^2, a GEMV over the
   materialized eps (jax backend) or the combine kernel, which regenerates
   the same eps (pallas backend);
6. DSGD at an omega-scaled learning rate;
7. the zeta, EMA and Welford refreshes, and with ``vbn_buffer_size > 0``
   the VBN refresh: one train-mode pass of the model at the updated weights
   over a fixed buffer of observations (with their arrival rewards for a
   recurrent model) refreshes every BatchNorm's running statistics.

Population chunking (``population_chunk`` C < P, jax backend only) runs
steps 1-3 C members at a time, the eval slot riding chunk 0, so only one
chunk's noise, perturbed weights, rollout and novelty are alive at once; the
combine regenerates eps chunk by chunk.

On a mesh (``mesh=``, a :class:`~dfd_tpu_torch.parallel.PopMesh`: one
process per card over ``torch.distributed``) every rank runs this code on
the same seeds and draws.  A rank runs steps 1-3 over its own members
``[r P / W, (r + 1) P / W)`` only, in chunks as above, with its own eval
slot on the draws' row P (every rank's eval episode is the one unsharded
episode, as JAX repeats its eval key on every slot); the per-member results
are gathered to every rank (``parallel/collectives.py``), so steps 4, 6 and
7 run on identical inputs everywhere; the combine covers the rank's members
and is summed over the ranks.  A mesh of one equals no mesh bit for bit.

The strategy archive's accept/evict logic stays on the host between epochs.

Each epoch report carries the trainer's spans (``self.timer``, a
:class:`~dfd_tpu_torch.utils.profiling.StageTimer` on the trainer's device,
active through ``train`` and ``train_fast``): ``archive`` and
``device_step``; inside the step ``perturb``, ``rollout``, ``novelty``,
``eval`` and ``update``; and the spans the rollout, the model and the env
open at each step (IMPALA's ``torso``, ``fc`` and ``core``, and ``env``).

Beside training, ``set_env`` swaps the environment between epochs (the
level curriculum, ``utils/curriculum.py``) and ``eval_panel`` plays the
current policy greedily on a fixed panel of JAX's own resets, read-only.

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

import functools
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.core import welford
from dfd_tpu_torch.core.device import canonical, full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.fd import combine as fd_combine
from dfd_tpu_torch.fd import rollout as fd_rollout
from dfd_tpu_torch.fd.dsgd import DSGDParams, dsgd_update, lr_scale_from_omega
from dfd_tpu_torch.fd.omega import OmegaParams, OmegaState, omega_init, omega_step
from dfd_tpu_torch.models.base import PolicyModel
from dfd_tpu_torch.novelty.handler import StrategyHandler, novelty_batch
from dfd_tpu_torch.ops.perturb import combine, noise_sumsq, perturb
from dfd_tpu_torch.parallel import collectives
from dfd_tpu_torch.parallel.mesh import PopMesh, pop_sharding
from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer, span


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
    """Every random number one epoch consumes (M = P + 1 with the eval slot,
    E episodes a member; the eval slot's episodes repeat one draw, as the
    JAX trainer repeats its key, and only its episode 0 is read)."""

    action_noise: torch.Tensor   # [M, E, T, A] each sampled action's noise: Gumbel (categorical,
                                 # A = n_actions) or standard normal (Gaussian, A = action_dim)
    stats_uniform: torch.Tensor  # [M, E, T] coin of the sampled observation statistics
    tie_signs: torch.Tensor      # [P] +-1 fitness of an all-equal batch
    zeta_perm: torch.Tensor      # [Z] zeta slots the eval states replace
    reset_level: torch.Tensor    # [M, E, *env.reset_shape] each episode's reset draw, the env's
                                 # own: int64 (a level, cells) or float32 (a physics env's start)


def make_draws(generator: torch.Generator, P: int, T: int, Z: int, env: TorchEnv,
               E: int = 1) -> EpochDraws:
    """One epoch's draws for ``env`` from ``generator``, on its device: its
    ``action_width`` of Gumbel action noise for a discrete env, else of
    standard normals, and its resets from ``env.sample_reset``."""
    dev = generator.device
    A = env.action_width
    if env.discrete:
        u = torch.rand((P + 1, E, T, A), generator=generator, device=dev)
        noise = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
    else:
        noise = torch.randn((P + 1, E, T, A), generator=generator, device=dev)
    stats_uniform = torch.rand((P + 1, E, T), generator=generator, device=dev)
    bits = torch.randint(0, 2, (P,), generator=generator, device=dev)
    tie_signs = (2 * bits - 1).to(torch.float32)
    zeta_perm = torch.randperm(Z, generator=generator, device=dev)
    reset_level = env.sample_reset((P + 1, E), generator)
    # the eval slot repeats its episode 0
    for x in (noise, stats_uniform, reset_level):
        x[P] = x[P, :1]
    return EpochDraws(noise, stats_uniform, tie_signs, zeta_perm, reset_level)


def _timed(method):
    """``method`` with the trainer's span timer active (``StageTimer.active``)."""
    @functools.wraps(method)
    def inner(self, *args, **kwargs):
        with self.timer.active():
            return method(self, *args, **kwargs)
    return inner


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
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        if mesh is not None and not self._here(mesh.device):
            raise ValueError(f"the mesh's rank lives on {mesh.device}, not {self.device}")
        self.mesh = mesh if mesh is not None else PopMesh(self.device)
        if not (self._here(model.device) and self._here(env.device)):
            raise ValueError(
                f"model ({model.device}) and env ({env.device}) must live on {self.device}"
            )
        self.model = model
        self.env = env
        self.distance_fn = distance_fn
        self.cfg = cfg
        self.reporter = reporter or EpochReporter(quiet=True)

        self.P = cfg.batch_size
        # this rank's members: all P without a mesh
        self.members = pop_sharding(self.mesh, self.P)
        self.E = cfg.envs_per_perturbation
        self.horizon = cfg.episode_length or env.max_episode_steps
        if cfg.antithetic and self.P % 2 != 0:
            raise ValueError("antithetic mode pairs members 2k/2k+1: batch_size must be even")
        if cfg.noise_backend not in ("jax", "pallas"):
            raise ValueError(f"noise_backend must be 'jax' or 'pallas', got {cfg.noise_backend!r}")
        if self.E < 1:
            raise ValueError(f"envs_per_perturbation must be >= 1, got {self.E}")
        # JAX reads e_lowering where E > 1, unchunked, with a zeta; the port
        # refuses there what it refuses (every valid choice is one rollout
        # here, as "auto" resolves to flat under a process group there)
        chunked = bool(cfg.population_chunk) and cfg.population_chunk < self.P
        if self.E > 1 and not chunked and cfg.zeta_size > 0 and \
                cfg.e_lowering not in ("flat", "nested", "auto"):
            raise ValueError(f"e_lowering must be flat|nested|auto, got {cfg.e_lowering!r}")
        # chunk: members whose perturb, rollout and novelty are alive at once
        shard = len(self.members)
        self.chunk = shard
        if cfg.antithetic and self.mesh.size > 1 and shard % 2 != 0:
            raise ValueError(f"antithetic pairs must not straddle ranks: {self.P} members over "
                             f"{self.mesh.size} ranks leave {shard} a rank")
        if cfg.population_chunk and cfg.population_chunk < self.P:
            if shard % cfg.population_chunk != 0:
                raise ValueError(f"population_chunk must divide batch_size"
                                 f"{' / ranks' if self.mesh.size > 1 else ''}: {shard} % "
                                 f"{cfg.population_chunk} != 0")
            if cfg.noise_backend == "pallas":
                raise ValueError("population_chunk needs noise_backend='jax': the pallas "
                                 "backend never materializes the noise")
            self.chunk = cfg.population_chunk

        params, bn_state = model.init(cfg.random_seed)
        flat = model.get_flat(params)
        self.noise = CounterNoise(model.num_params, random_seed=cfg.random_seed,
                                  antithetic=cfg.antithetic, device=self.device)
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
        zeta = self._seed_buffer(cfg.zeta_size)
        # (observations [N, *obs], their arrival rewards [N]) on the device
        self._vbn_buffer = (self._seed_buffer(cfg.vbn_buffer_size, with_rewards=True)
                            if cfg.vbn_buffer_size > 0 else None)
        self.state = TrainState(
            flat=flat,
            bn_state=bn_state,
            omega=omega_init(cfg.omega.default_value, cfg.omega.reward_history_size, self.device),
            obs_stats=welford.init(env.obs_shape, self.device),
            zeta=zeta,
            policy_reward=zero(),
            policy_entropy=zero(),
            policy_novelty=zero(),
            epoch=0,
        )
        self.cumulative_timesteps = 0
        self._last_archived = None
        self.timer = StageTimer(self.device)

    def _here(self, device) -> bool:
        """Whether ``device`` is the trainer's (``"cuda"`` is the current card)."""
        return canonical(device) == canonical(self.device)

    # -- public ------------------------------------------------------------------

    def set_env(self, env: TorchEnv) -> None:
        """Swap the environment between epochs (level curricula, domain
        randomization schedules).  The new env must agree on the observation
        and action interface; the training state (parameters, BN statistics,
        omega, obs stats, zeta, EMAs, epoch, archive, generator) carries
        over, and the next epoch's resets are drawn from the new env."""
        if tuple(env.obs_shape) != tuple(self.env.obs_shape):
            raise ValueError(f"obs_shape mismatch: {env.obs_shape} vs {self.env.obs_shape}")
        if env.discrete != self.env.discrete or env.action_width != self.env.action_width:
            raise ValueError("action space mismatch between old and new env")
        if not self._here(env.device):
            raise ValueError(f"env ({env.device}) must live on {self.device}")
        self.env = env
        self.horizon = self.cfg.episode_length or env.max_episode_steps

    @full_f32()
    def eval_panel(self, n_panel: int = 32, panel_seed: int = 1234) -> np.ndarray:
        """The reward of a greedy episode on each of ``n_panel`` fixed
        resets [n_panel]: episode i resets as the JAX trainer's panel does,
        under ``split(fold_in(key(panel_seed), i), 3)[0]`` (``panel_seed`` in
        [0, 2**32)), computed on the host, so the panel plays JAX's levels.
        One rollout of the current policy with the panel as its E axis; no
        statistics are sampled.  Read-only: the generator, the EMAs, zeta
        and the epoch do not move."""
        keys = _levels.fold_in(_levels.key_data(panel_seed), np.arange(n_panel))
        reset = self.env.reset_draw(_levels.split(keys, 3)[:, 0])
        state, T, A = self.state, self.horizon, self.env.action_width
        obs_mean, obs_std = welford.mean_std(state.obs_stats)
        res = fd_rollout.episode_rollout(
            self.model, self.env, self.model.set_flat(state.flat[None]), state.bn_state, T,
            torch.ones(1, dtype=torch.bool, device=self.device), obs_mean, obs_std,
            normalize_obs=self.cfg.normalize_obs, obs_stats_update_chance=0.0,
            action_noise=torch.zeros((1, n_panel, T, A), device=self.device),
            stats_uniform=torch.ones((1, n_panel, T), device=self.device),
            reset_level=torch.as_tensor(reset, device=self.device)[None], collect_limit=0,
        )
        return res.reward[0].cpu().numpy()

    def _archive_current(self) -> None:
        """Submit the current policy unless it is already the latest archive
        entry (guards chained train calls against duplicate snapshots)."""
        flat = self.state.flat.cpu().numpy()
        if self._last_archived is not None and np.array_equal(flat, self._last_archived):
            return
        self.handler.add_policy(flat)
        self._last_archived = flat.copy()

    @full_f32()
    @_timed
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
    @_timed
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
        P, C = self.P, self.chunk
        Z = state.zeta.shape[0]
        draws = self._checked_draws(state.epoch, Z)
        do_eval = state.epoch % cfg.eval_every == 0
        fused_eval = Z > 0
        obs_mean, obs_std = welford.mean_std(state.obs_stats)

        def rollout(params, det, rows, collect_limit, episodes=self.E):
            """The members' episodes on the draws' ``rows``."""
            with span("rollout"):
                return fd_rollout.episode_rollout(
                    model, self.env, params, state.bn_state, self.horizon, det,
                    obs_mean=obs_mean, obs_std=obs_std,
                    normalize_obs=cfg.normalize_obs,
                    obs_stats_update_chance=cfg.obs_stats_update_chance,
                    action_noise=draws.action_noise[rows, :episodes],
                    stats_uniform=draws.stats_uniform[rows, :episodes],
                    reset_level=draws.reset_level[rows, :episodes],
                    collect_limit=collect_limit,
                )

        # 1-3. perturb, roll out and score this rank's members (all P
        # without a mesh) a chunk at a time (one chunk unless
        # population_chunk); the deterministic eval episode rides the first
        # chunk as its last member (zero noise) when zeta_size > 0
        lo, hi = self.members.start, self.members.stop
        if cfg.noise_backend == "jax":
            self.noise.prepare(state.epoch, hi)  # the epoch's keys, one transfer
        members, novelties = [], []
        eps = noise_ssq = fused = None
        for c0 in range(lo, hi, C):
            ride = fused_eval and c0 == lo
            with span("perturb"):
                flats, eps, noise_ssq = self._perturbed(state, c0, ride)
                params = model.set_flat(flats)
            det = torch.zeros(flats.shape[0], dtype=torch.bool, device=self.device)
            det[C:] = True
            rows = slice(c0, c0 + C + int(ride))
            if ride and c0 + C < P:  # the first chunk and the eval slot, row P of the draws
                rows = torch.cat([torch.arange(c0, c0 + C, device=self.device),
                                  torch.full((1,), P, device=self.device)])
            res = rollout(params, det, rows, Z if ride else 0)
            novelty = self._batch_novelty(params, state, archive, archive_count)
            if ride:
                fused = (fd_rollout.RolloutResult(
                    res.reward[C:], res.entropy[C:], res.steps[C:],
                    welford.WelfordState(*(x[C:] for x in res.obs_stats)), res.states[C:]),
                    novelty[C])
            members.append(_member_result(res, C))
            novelties.append(novelty[:C])
            del flats, params, res
        result = _cat_results(members)
        novelty = torch.cat(novelties)
        if self.mesh.group is not None:  # every rank gets the whole population's
            result, novelty = self._gather(result, novelty)
        rewards = result.reward

        # 4. eval episode (member P, episode 0); contributes only on eval epochs
        policy_reward, policy_entropy, policy_novelty = (
            state.policy_reward, state.policy_entropy, state.policy_novelty,
        )
        zeta, omega = state.zeta, state.omega
        eval_steps = torch.zeros((), dtype=torch.int64, device=self.device)
        eval_stats = welford.init(self.env.obs_shape, self.device)
        noisy_mean = rewards.mean()
        if do_eval:
            with span("eval"):
                if fused is None:  # the unfused eval episode, run alone
                    params = model.set_flat(state.flat[None])
                    det = torch.ones(1, dtype=torch.bool, device=self.device)
                    ev = rollout(params, det, slice(P, P + 1), Z, episodes=1)
                    ev_novelty = self._batch_novelty(params, state, archive, archive_count)[0]
                else:
                    ev, ev_novelty = fused
                ema = lambda old, new: old * 0.9 + new * 0.1
                policy_reward = ema(policy_reward, ev.reward[-1, 0])
                policy_entropy = ema(policy_entropy, ev.entropy[-1, 0])
                policy_novelty = ema(policy_novelty, ev_novelty)
                eval_steps = ev.steps[-1, 0]
                eval_stats = welford.WelfordState(*(x[-1, 0] for x in ev.obs_stats))
                # 5. zeta refresh from the eval episode's visited states
                if Z > 0:
                    zeta = self._update_zeta(state.zeta, ev.states[0], eval_steps,
                                             draws.zeta_perm)
                # 6. omega steps on eval epochs with the mean noisy reward
                omega = omega_step(state.omega, noisy_mean, self.omega_hp)

        with span("update"):
            # 7. fitness -> combine -> DSGD
            # (the rank's members' share of it, summed over the ranks)
            fitness = fd_combine.fitness_from_rewards(rewards, policy_reward, draws.tie_signs)
            mine = fitness[lo:hi]
            if C < hi - lo:
                gradient = fd_combine.combine_gradient_chunked(
                    self.noise, state.epoch, self.members, mine, cfg.noise_std, C)
            elif cfg.noise_backend == "pallas":
                coefs = mine / (cfg.noise_std * torch.clamp_min(noise_ssq, 1e-30))
                gradient = combine(coefs, cfg.random_seed, state.epoch, model.num_params,
                                   antithetic=cfg.antithetic, first=lo)
            else:
                gradient = fd_combine.combine_gradient(eps, mine, cfg.noise_std)
            del eps
            gradient = collectives.all_sum(self.mesh, gradient)
            if cfg.optimizer == "dsgd":
                lr_scale = lr_scale_from_omega(
                    omega.omega, cfg.omega.min_value, cfg.omega.max_value,
                    cfg.dsgd_min_scale, cfg.dsgd_max_scale,
                )
                new_flat = dsgd_update(state.flat, -gradient, lr_scale, self.dsgd_hp)
            else:  # plain SGD on grad = -g (net ascent), reference opt_fn alternative
                new_flat = state.flat + cfg.learning_rate * gradient
            update_size = torch.sqrt(torch.sum((new_flat - state.flat) ** 2))

            # VBN: the BatchNorm statistics refreshed at the updated weights;
            # a recurrent model reads the buffer's arrival rewards through its LSTM
            bn_state = state.bn_state
            if self._vbn_buffer is not None:
                vbn_obs, vbn_rewards = self._vbn_buffer
                bn_state = model.vbn(model.set_flat(new_flat[None]), state.bn_state, vbn_obs,
                                     rewards=vbn_rewards)

            # 8. merge sampled observation statistics from the population
            obs_stats = state.obs_stats
            if cfg.normalize_obs:
                obs_stats = welford.merge(obs_stats, welford.merge_population(result.obs_stats))
                obs_stats = welford.merge(obs_stats, eval_stats)

        new_state = TrainState(
            flat=new_flat,
            bn_state=bn_state,
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
            "_timesteps": result.steps.sum() + eval_steps,
            "_did_eval": int(do_eval),
        }
        return new_state, metrics

    def _perturbed(self, state: TrainState, c0: int, theta_row: bool):
        """(perturbed flats of members c0 .. c0 + chunk - 1 [chunk (+1), d],
        theta as the last row where ``theta_row``; eps [chunk, d] on the
        unchunked jax path, else None; ||eps_i||^2 [chunk] on the pallas
        path, else None).  Unchunked, the chunk is the rank's members."""
        cfg = self.cfg
        if cfg.noise_backend == "pallas":
            pop = perturb(state.flat, cfg.noise_std, cfg.random_seed, state.epoch, self.chunk,
                          antithetic=cfg.antithetic, first=c0)
            noise_ssq = noise_sumsq(pop, state.flat, cfg.noise_std)
            if theta_row:
                pop = torch.cat([pop, state.flat[None]], dim=0)
            return pop, None, noise_ssq
        flats, eps = self.noise.perturb_block(
            state.flat, cfg.noise_std, state.epoch, range(c0, c0 + self.chunk),
            with_eps=self.chunk == len(self.members), theta_row=theta_row)
        return flats, eps, None

    def _gather(self, result: fd_rollout.RolloutResult, novelty: torch.Tensor):
        """The whole population's per-member results and novelty [P] on
        every rank, from this rank's: one float32 ``[P, k]`` buffer summed
        over the ranks (the sampled statistics only with normalize_obs, the
        only reader)."""
        table = torch.stack([result.reward, result.entropy, result.steps.to(torch.float32),
                             novelty], dim=1)
        table, obs_stats = collectives.gather_results(
            self.mesh, table, result.obs_stats if self.cfg.normalize_obs else None, self.P)
        if obs_stats is None:
            obs_stats = welford.init(self.env.obs_shape, self.device, batch=(self.P,))
        return fd_rollout.RolloutResult(table[:, 0], table[:, 1], table[:, 2].to(torch.int64),
                                        obs_stats, None), table[:, 3]

    # -- pieces ------------------------------------------------------------------

    def _own_draws(self, epoch: int) -> EpochDraws:
        return make_draws(self.generator, self.P, self.horizon, self.state.zeta.shape[0],
                          self.env, E=self.E)

    def _checked_draws(self, epoch: int, Z: int) -> EpochDraws:
        draws = EpochDraws(*(x.to(self.device) for x in self.draw_source(epoch)))
        M, E, T, A = self.P + 1, self.E, self.horizon, self.env.action_width
        expect = ((M, E, T, A), (M, E, T), (self.P,), (Z,), (M, E) + tuple(self.env.reset_shape))
        got = tuple(tuple(x.shape) for x in draws)
        if got != expect:
            raise ValueError(f"draw_source gave shapes {got}, expected {expect}")
        return draws

    def _batch_novelty(self, pop_params, state: TrainState, archive, archive_count: int):
        """Min behavioral distance to the archive; 0 when the archive has <2
        entries, and then, like the reference's guard
        (strategy_handler.py:25-31), no strategy forward runs at all."""
        with span("novelty"):
            return novelty_batch(self.model, pop_params, state.bn_state, state.zeta, archive,
                                 archive_count, self.distance_fn)

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
        """Fixed-shape archive tensor [H, Z, F] on the device + valid count;
        F is the strategy's width: the action count, or 2 action_dim for a
        Gaussian policy's (mean, std)."""
        t = self.handler.strategy_tensor
        Z = self.state.zeta.shape[0]
        F = self.model.output_shape if self.model.discrete else 2 * self.model.output_shape
        full = np.zeros((self.H, Z, F), np.float32)
        count = 0
        if isinstance(t, np.ndarray) and t.ndim == 3:
            count = min(len(t), self.H)
            full[:count] = t[:count]
        return torch.as_tensor(full, device=self.device), count

    def _seed_buffer(self, n: int, with_rewards: bool = False):
        """Observation buffer [n, *obs] from a random-action rollout of one
        env (reference run_sequential.py:198-213), the actions uniform over
        the discrete ones or in [-1, 1) each dimension; ``with_rewards`` also
        returns each observation's arrival reward [n] (0 at resets), what a
        recurrent policy's VBN pass reads through its LSTM."""
        env = self.env
        if n == 0:
            return torch.zeros((0,) + tuple(env.obs_shape), dtype=torch.float32,
                               device=self.device)
        if env.discrete:
            actions = torch.randint(0, env.n_actions, (n,), generator=self.generator,
                                    device=self.device)
        else:
            actions = torch.rand((n, env.action_dim), generator=self.generator,
                                 device=self.device) * 2.0 - 1.0
        resets = env.sample_reset((n + 1,), self.generator)  # one draw per reset
        env_state, obs = env.reset(1, resets[:1])
        reward = torch.zeros(1, dtype=torch.float32, device=self.device)
        buf, rewards = [], []
        for k in range(n):
            buf.append(obs[0])
            rewards.append(reward)
            new_state, new_obs, new_reward, done = env.step(env_state, actions[k:k + 1])
            reset_state, reset_obs = env.reset(1, resets[k + 1:k + 2])
            env_state = type(new_state)(*fd_rollout._keep(done, new_state, reset_state))
            obs = torch.where(done.reshape((1,) + (1,) * len(env.obs_shape)), reset_obs, new_obs)
            reward = torch.where(done, 0.0, new_reward.to(torch.float32))
        buf = torch.stack(buf)
        return (buf, torch.cat(rewards)) if with_rewards else buf


def _member_result(res: fd_rollout.RolloutResult, n: int) -> fd_rollout.RolloutResult:
    """The first ``n`` members' results over their E episodes, as the JAX
    trainer reduces them: reward and entropy the mean, steps the sum, the
    sampled statistics merged (``states`` left out)."""
    by_episode = welford.WelfordState(*(x[:n].transpose(0, 1) for x in res.obs_stats))
    return fd_rollout.RolloutResult(
        res.reward[:n].mean(dim=1), res.entropy[:n].mean(dim=1), res.steps[:n].sum(dim=1),
        welford.merge_population(by_episode), None)


def _cat_results(parts) -> fd_rollout.RolloutResult:
    """Per-member results of consecutive chunks, concatenated."""
    cat = lambda xs: torch.cat(list(xs))
    return fd_rollout.RolloutResult(
        cat(p.reward for p in parts), cat(p.entropy for p in parts),
        cat(p.steps for p in parts),
        welford.WelfordState(*(cat(x) for x in zip(*(p.obs_stats for p in parts)))), None)


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
