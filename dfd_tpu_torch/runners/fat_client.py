"""Fat elastic worker: one process contributing whole population shards,
the counterpart of ``dfd_tpu.runners.fat_client``.

Where the reference scales host throughput by running many thin client
*processes* (one env, batch-1 forwards each), a fat client packs the same
work into one process: N host envs step in lockstep against device-batched
perturbed forwards (``runners/host_evaluator.py``: one ``perturb_block``, so
one ``normal_kernel`` launch on the card, a window), and each collection
window submits N returns at once.  Requires the server to run with
``noise_kind="counter"`` so the member-id encodings decode server-side.

Eval duties (deterministic episodes feeding zeta/EMA baselines) ride on a
standard Agent over one extra env, triggered with the configured
``eval_prob`` per window.

The window key chain is JAX's: ``key(seed)``, then ``key, sub = split(key)``
a window, in the port's numpy threefry (``envs/_levels.py``); the sub-key's
words are the evaluator's ``seed`` (its statistics' coins and its default
action noise).  ``action_noise_source(sub) -> action_noise`` replaces the
evaluator's default action noise (the parity tests rebuild JAX's draws from
``sub``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.core.welford import Welford
from dfd_tpu_torch.distributed.client import FDClient
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.envs.wrappers import frame_of
from dfd_tpu_torch.fd.returns import FDReturn
from dfd_tpu_torch.runners.agent import Agent
from dfd_tpu_torch.runners.host_evaluator import BatchedHostEvaluator
from dfd_tpu_torch.runners.policy import HostPolicy
from dfd_tpu_torch.utils.factory import get_init_data
from dfd_tpu_torch.utils.profiling import StageTimer


# The JAX package's serial/thread crossover (its tools/bench_host_pipeline.py
# on its own 2-core host, docs/RESULTS.md): at ~0.4 ms/step (MuJoCo/ALE-class
# C engines) the thread pool won 1.7x; at ~0.03 ms python dispatch dominated
# and the serial loop won 2.4x.  The threshold sits between the two regimes,
# biased low so real C engines (all >= 0.2 ms) clear it.  The port keeps the
# threshold; it was not measured again for the port's host envs.
THREAD_CROSSOVER_S = 0.15e-3


def choose_backend(step_cost_s: float, cpu_count: Optional[int] = None,
                   parallel_speedup: Optional[float] = None) -> str:
    """Selection policy for ``backend='auto'``: thread-pool envs whose step
    is C-engine-heavy (>= the measured crossover) on multi-core hosts;
    serial otherwise (python dispatch dominates trivial steps, and a
    1-core host has nothing to overlap).

    Step cost alone cannot distinguish a heavy C engine from heavy
    GIL-HELD python work (where the pool only adds overhead), so when the
    caller supplies ``parallel_speedup`` — the measured 2-thread speedup
    from :func:`probe_parallel_speedup`, a direct GIL-release test — the
    pool is chosen only if threading actually paid (> 1.25x)."""
    cores = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    if cores <= 1:
        return "serial"
    if step_cost_s < THREAD_CROSSOVER_S:
        return "serial"
    if parallel_speedup is not None and parallel_speedup < 1.25:
        return "serial"  # GIL-bound step: threads serialize anyway
    return "thread"


def _probe_action(model):
    return 0 if model.discrete else np.zeros(model.output_shape, np.float32)


def probe_step_cost(env_id: str, seed: int, n_steps: int = 12, device=None) -> float:
    """Median wall-clock of one host-env step (the ``auto`` backend probe).
    Builds one throwaway env, resets, and steps a fixed do-nothing action;
    re-resets on episode end so every timing is a real step.  The env is
    built on ``device``, where the fat client's host envs would live."""
    env, model, _ = get_init_data(env_id, seed, device)
    action = _probe_action(model)
    env.reset()
    costs = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        _, _, done, _ = env.step(action)
        costs.append(time.perf_counter() - t0)
        if done:
            env.reset()
    if hasattr(env, "close"):
        env.close()
    return float(np.median(costs))


def probe_parallel_speedup(env_id: str, seed: int, n_steps: int = 8, device=None) -> float:
    """Measured 2-thread speedup of stepping two envs — the direct test of
    whether this env family's ``step`` releases the GIL (MuJoCo/ALE/procgen
    C cores do; pure-python or jit-dispatch-bound steps do not)."""
    from concurrent.futures import ThreadPoolExecutor

    envs = []
    model = None
    for i in range(2):
        env, model, _ = get_init_data(env_id, seed + i, device)
        env.reset()
        envs.append(env)
    action = _probe_action(model)

    def run(env):
        for _ in range(n_steps):
            _, _, done, _ = env.step(action)
            if done:
                env.reset()

    for e in envs:  # warm (kernel builds, lazy engine init)
        run(e)
    t0 = time.perf_counter()
    for e in envs:
        run(e)
    t_serial = time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=2) as pool:
        t0 = time.perf_counter()
        list(pool.map(run, envs))
        t_par = time.perf_counter() - t0
    for e in envs:
        if hasattr(e, "close"):
            e.close()
    return t_serial / max(t_par, 1e-9)


def resolve_backend(env_id: str, seed: int, device=None) -> str:
    """The full ``auto`` decision for an env id: probe one step's cost,
    and only if it clears the crossover, probe the 2-thread speedup."""
    cost = probe_step_cost(env_id, seed, device=device)
    speedup = (
        probe_parallel_speedup(env_id, seed, device=device)
        if cost >= THREAD_CROSSOVER_S and (os.cpu_count() or 1) > 1
        else None
    )
    return choose_backend(cost, parallel_speedup=speedup)


def default_vector_env(env_id: str, n_envs: int, seed: int, backend: str = "auto",
                       device=None):
    """Vector backend for an env id.

    ``backend``: "serial" (python loop / native trap pool), "thread"
    (:class:`ThreadPoolVectorEnv` — C engines whose ``step`` releases the
    GIL step concurrently), or "auto" (default): the native C++ pool for
    the trap env, otherwise probe one env's measured step cost and apply
    the serial/thread crossover (``choose_backend``).  Envs other than the
    native pool's are host adapters over port envs on ``device``."""
    if backend not in ("auto", "serial", "thread"):
        raise ValueError(f"env backend must be auto|serial|thread, got {backend!r}")
    if env_id == "SimpleTrapEnv-v0" and backend in ("auto", "serial"):
        # lockstep pool, one call a batch step, for trivial per-step costs
        from dfd_tpu_torch.envs.native_pool import NativeTrapPool, native_pool_available

        if native_pool_available():
            return NativeTrapPool(n_envs)
    from dfd_tpu_torch.envs.vector_host import PythonVectorEnv, ThreadPoolVectorEnv

    def make(i):
        env, _, _ = get_init_data(env_id, seed + i, device)
        return env

    if backend == "auto":
        backend = resolve_backend(env_id, seed, device)
    cls = ThreadPoolVectorEnv if backend == "thread" else PythonVectorEnv
    return cls(make, n_envs)


class FatClientRunner:
    def __init__(
        self,
        n_envs: int = 64,
        address: str = "localhost",
        port: int = 1025,
        vector_env_factory: Optional[Callable] = None,
        pipeline_lanes: int = 1,
        env_backend: str = "auto",
        device=None,
        action_noise_source: Optional[Callable] = None,
    ):
        """``pipeline_lanes``: split the shard's envs into this many vector
        backends and let the evaluator software-pipeline them — the device
        forwards lane k while the host steps lane k-1 (double buffering;
        SURVEY section 7 hard part 5).  1 = the serial lockstep loop.

        ``env_backend``: serial | thread | auto (see
        :func:`default_vector_env`); ignored when a custom
        ``vector_env_factory`` is supplied.

        ``device``: where the model, the noise and the default host envs
        live (``None``: the card).  ``action_noise_source(sub)``: the
        evaluator's ``action_noise`` for the window whose sub-key words are
        ``sub`` (``None``: the evaluator's default draws)."""
        self.device = resolve_device(device)
        self.action_noise_source = action_noise_source
        if pipeline_lanes < 1 or n_envs % pipeline_lanes != 0:
            raise ValueError("pipeline_lanes must be >= 1 and divide n_envs")
        self.pipeline_lanes = pipeline_lanes
        self.n_envs = n_envs
        self.address, self.port = address, port
        self.client = FDClient()
        if vector_env_factory is None:
            # the auto probe (env build, warm steps, timed steps) is
            # per-env-id, not per-lane: resolve once, reuse for every lane
            resolved: dict = {}
            dev = self.device

            def vector_env_factory(env_id, n, seed):
                backend = env_backend
                if backend == "auto":
                    backend = resolved.get(env_id)
                    if backend is None:
                        backend = resolved[env_id] = resolve_backend(env_id, seed, dev)
                return default_vector_env(env_id, n, seed, backend=backend, device=dev)

        self._vector_env_factory = vector_env_factory
        self.evaluator: Optional[BatchedHostEvaluator] = None
        self.windows = 0
        # per-window wall-clock stages (SURVEY section 5.1's observability on
        # the worker side): refreshed into last_stages after every submit
        self.timer = StageTimer()
        self.last_stages: dict = {}

    @full_f32()
    def run(self, max_windows: Optional[int] = None, reconnect_attempts: int = 60) -> bool:
        client = self.client
        client.connect(address=self.address, port=self.port)

        status = client.get_server_state()
        failures = 0
        while status != FDClient.NEW_EXPERIMENT_FLAG:
            # bounded like the reference's reconnect loop (run_client.py:60-78):
            # a dead server must terminate the worker, not spin it forever
            if status == FDClient.RPC_FAILED_FLAG:
                failures += 1
                if failures > reconnect_attempts:
                    client.disconnect()
                    return False
                time.sleep(1)
            else:
                time.sleep(0.2)
            status = client.get_server_state()
        self._configure(client.current_state.cfg)
        self._apply_state(client.current_state)

        while max_windows is None or self.windows < max_windows:
            self.windows += 1
            returns = self._collect_window()
            with self.timer.stage("submit"):
                client.submit_returns(returns)
            self.last_stages = self.timer.report()

            status = client.get_server_state()
            if status == FDClient.NEW_STATE_FLAG:
                self._apply_state(client.current_state)
            elif status == FDClient.RPC_FAILED_FLAG:
                recovered = False
                for _ in range(reconnect_attempts):
                    time.sleep(1)
                    status = client.get_server_state()
                    if status != FDClient.RPC_FAILED_FLAG:
                        recovered = True
                        break
                if not recovered:
                    client.disconnect()
                    return False
                self._apply_state(client.current_state)
            if status == FDClient.NEW_EXPERIMENT_FLAG:
                self._configure(client.current_state.cfg)
                self._apply_state(client.current_state)

        client.disconnect()
        return True

    # -- internals ---------------------------------------------------------------

    def _configure(self, cfg: dict) -> None:
        if cfg.get("noise_kind") != "counter":
            raise RuntimeError(
                "fat clients need the server started with noise_kind='counter'"
            )
        env_id = cfg["env_id"]
        seed = int(cfg["random_seed"])
        self._seed = seed
        self.rng = np.random.RandomState(seed)
        self.eval_prob = float(cfg["eval_prob"])
        sigma = float(cfg["noise_std"])
        self.normalize_obs = bool(cfg["normalize_obs"])

        eval_env, model, distance_fn = get_init_data(env_id, seed, self.device)
        self.model = model
        self.policy = HostPolicy(model, seed=seed)
        self.max_history = int(cfg.get("max_strategy_history_size", 2))
        # the SHARED base seed (never client-minted): all shards and the
        # server must regenerate identical noise per (epoch, member id)
        self.antithetic = bool(cfg.get("antithetic", False))
        if self.antithetic and self.n_envs % 2 != 0:
            raise RuntimeError("antithetic mode needs an even number of envs per shard")
        self.noise = CounterNoise(
            model.num_params, random_seed=int(cfg["noise_seed"]), antithetic=self.antithetic,
            device=self.device,
        )
        L = self.pipeline_lanes
        if L == 1:
            vec = self._vector_env_factory(env_id, self.n_envs, seed)
        else:
            per = self.n_envs // L
            vec = [
                self._vector_env_factory(env_id, per, seed + l * per) for l in range(L)
            ]
        self.evaluator = BatchedHostEvaluator(
            model, vec, self.noise, sigma, normalize_obs=self.normalize_obs,
            obs_stats_update_chance=float(cfg["obs_stats_update_chance"]),
            distance_fn=distance_fn, device=self.device,
        )
        self.eval_agent = Agent(
            self.policy, eval_env, seed, normalize_obs=self.normalize_obs,
            obs_stats_update_chance=float(cfg["obs_stats_update_chance"]),
        )
        self.fixed_obs_stats = Welford(model.input_shape)
        self.epoch = 0
        self._key = _levels.key_data(seed)
        env_obj = self.eval_agent.env
        self.horizon = getattr(getattr(env_obj, "env", env_obj), "max_episode_steps", 10000)

    def _apply_state(self, state) -> None:
        with self.timer.stage("apply_state"):
            self._apply_state_inner(state)

    def _apply_state_inner(self, state) -> None:
        self.policy.deserialize(state.policy_params)
        self.epoch = state.epoch
        if state.obs_stats is not None:
            self.fixed_obs_stats.deserialize(state.obs_stats)
        # zeta + archive (zero-padded to a fixed leading extent, as the JAX
        # client pads it for its one novelty compilation) for per-member
        # novelty on the device
        self.zeta = None if state.strategy_frames is None else np.array(
            state.strategy_frames, np.float32
        )
        t = state.strategy_history
        self.archive_count = 0
        self.archive = None
        if t is not None and np.asarray(t).ndim == 3:
            t = np.asarray(t, np.float32)
            self.archive_count = min(len(t), self.max_history)
            self.archive = np.zeros((self.max_history,) + t.shape[1:], np.float32)
            self.archive[: self.archive_count] = t[: self.archive_count]

    def _collect_window(self):
        self._key, sub = _levels.split(self._key, 2)
        offset = ((self._seed * 2654435761) ^ (self.windows * 97)) & 0x3FFFFFFF
        if self.antithetic:
            offset &= ~1  # even-align so each shard holds complete +-eps pairs
        flat = self.policy.get_trainable_flat()
        with self.timer.stage("rollout"):
            returns = self._population_returns(flat, sub, offset)
        if self.rng.uniform(0, 1) < self.eval_prob:
            with self.timer.stage("eval"):
                returns.append(self._eval_return(flat))
        return returns

    def _population_returns(self, flat, sub, offset):
        return self.evaluator.evaluate_population(
            flat,
            self.policy.bn_state,
            epoch=self.epoch,
            horizon=self.horizon,
            seed=sub,
            obs_mean=self.fixed_obs_stats.mean if self.normalize_obs else None,
            obs_std=self.fixed_obs_stats.std if self.normalize_obs else None,
            id_offset=offset,
            zeta=self.zeta,
            archive=self.archive,
            archive_count=self.archive_count,
            action_noise=(self.action_noise_source(sub) if self.action_noise_source is not None
                          else None),
        )

    def _eval_return(self, flat):
        rew, ent, steps = self.eval_agent.collect_return(
            eval_run=True, save_states=True,
            mean=self.fixed_obs_stats.mean, std=self.fixed_obs_stats.std,
        )
        eval_novelty = self.evaluator.compute_novelty(
            flat[None, :], self.policy.bn_state,
            self.zeta, self.archive, self.archive_count,
        )[0]
        return FDReturn(
            epoch=self.epoch, encoded_noise="0", reward=rew, entropy=ent,
            novelty=float(eval_novelty),
            timesteps=steps, is_eval=True,
            eval_states=[frame_of(s) for s in self.eval_agent.saved_states],
            obs_stats_update=self.eval_agent.obs_stats.serialize(),
        )
