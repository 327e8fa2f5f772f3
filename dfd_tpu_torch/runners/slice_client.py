"""A device acting as ONE elastic client: device-evaluated population shards
feeding the distributed learner, the counterpart of
``dfd_tpu.runners.slice_client.SliceClientRunner``.

The client evaluates a whole population shard per window with the
population rollout (``fd/rollout.py``: the members' weights from one
``CounterNoise.perturb_block``, so one ``normal_kernel`` launch on the card,
a chunk), at whatever broadcast parameters it last applied.  Every return is
counter-encoded ``"{epoch},{id}"``, so if the server has advanced Delta
epochs by the time the shard lands, the learner regenerates the noise and
drift-corrects it through the policy-history distance map instead of
discarding the work.

One deterministic eval member (theta itself) rides the population as its
last row: it refreshes zeta, the EMA baselines and omega server-side.  Each
member carries its novelty against the broadcast archive (zero, and no
strategy forward, below 2 entries), and the window's sampled observation
statistics, merged over the members and the eval member, ride the first
return as one Welford delta.

Requires the server to run with ``noise_kind="counter"`` on a registered
port env id; the shared base seed ships in the wire cfg (never
client-minted).

On a mesh (``mesh=``, a :class:`~dfd_tpu_torch.parallel.PopMesh` of one
process per card) the ranks act as one client: rank 0 alone holds the gRPC
client; each window it broadcasts what it applied since the last (cfg,
state) and the window (its draws' sub-key, the member ids), every rank
evaluates its shard of the members (``pop_sharding``) with its own eval
member on the window's last draws row, and the members' results are
gathered to rank 0 (``parallel/collectives.py``), which pushes them.

Randomness: the JAX client keys a window as ``key, sub = split(key)`` from
``key(seed)``, member ``id`` under ``fold_in(sub, id)`` and the eval member
under ``fold_in(sub, 0xE7A1)``.  The port keeps that key chain in numpy
(``envs/_levels.py``) and takes the window's draws from
``draw_source(sub, member_ids) -> WindowDraws``; by default they come from
the client's ``torch.Generator`` (seeded from the client's seed), and the
parity tests rebuild JAX's draws from ``sub``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dfd_tpu_torch.core import welford
from dfd_tpu_torch.core.device import full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.core.welford import Welford
from dfd_tpu_torch.distributed.client import FDClient
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.fd import rollout as fd_rollout
from dfd_tpu_torch.fd.returns import FDReturn
from dfd_tpu_torch.novelty.handler import novelty_batch
from dfd_tpu_torch.parallel import collectives
from dfd_tpu_torch.parallel.mesh import PopMesh, pop_sharding
from dfd_tpu_torch.runners.vectorized import make_draws
from dfd_tpu_torch.utils.profiling import StageTimer

EVAL_FOLD = 0xE7A1  # the eval member's key: fold_in(window key, EVAL_FOLD)


class WindowDraws(NamedTuple):
    """Every random number one window consumes, the P members' rows first
    and the eval member's last (M = P + 1)."""

    action_noise: torch.Tensor   # [M, T, A] Gumbel (categorical) or standard normal (Gaussian)
    stats_uniform: torch.Tensor  # [M, T] coin of the sampled observation statistics
    reset_level: torch.Tensor    # [M, *env.reset_shape] each episode's reset draw


def make_window_draws(generator: torch.Generator, P: int, T: int, env) -> WindowDraws:
    """One window's draws for ``env`` from ``generator``, on its device."""
    d = make_draws(generator, P, T, 0, env)
    return WindowDraws(d.action_noise[:, 0], d.stats_uniform[:, 0], d.reset_level[:, 0])


class SliceClientRunner:
    def __init__(
        self,
        n_members: int = 64,
        address: str = "localhost",
        port: int = 1025,
        apply_state_every: int = 1,
        mesh=None,
        wait_for_new_state: bool = False,
        state_wait_timeout: float = 60.0,
        population_chunk: Optional[int] = None,
        device=None,
        draw_source: Optional[Callable[[np.ndarray, np.ndarray], WindowDraws]] = None,
    ):
        """``apply_state_every``: apply NEW_STATE broadcasts only every k-th
        window — k>1 deliberately lags the shard's epoch tag behind the
        server (the staleness regime the drift correction exists for).

        ``wait_for_new_state``: after submitting a window, poll (up to
        ``state_wait_timeout`` s) until the server broadcasts a fresh state
        before collecting the next one; off by default (pure async).

        ``mesh``: a :class:`~dfd_tpu_torch.parallel.PopMesh`; its ranks
        share the window's members (rank 0 talks to the server; every rank
        calls ``run``).  Its device is the client's.

        ``population_chunk``: evaluate the shard in chunks of this many
        members (only one chunk's perturbed weights and rollout are alive at
        once; chunk 0 carries the eval member).  Must divide ``n_members``.

        ``device``: where the model, env, noise and rollout run (``None``:
        the card).  ``draw_source(sub, member_ids)``: the window's draws for
        the window sub-key words ``sub`` and the members' global ids
        (``None``: the client's generator)."""
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh if mesh is not None else PopMesh(self.device)
        shard = len(pop_sharding(self.mesh, n_members))
        if population_chunk is not None and population_chunk > 0:
            if shard % population_chunk != 0:
                raise ValueError("population_chunk must divide n_members"
                                 + (" / ranks" if self.mesh.size > 1 else ""))
        self.population_chunk = population_chunk
        self.n_members = n_members
        self.address, self.port = address, port
        self.apply_state_every = max(int(apply_state_every), 1)
        self.wait_for_new_state = wait_for_new_state
        self.state_wait_timeout = state_wait_timeout
        self.draw_source = draw_source
        self.client = FDClient()
        self.windows = 0
        self.epoch = 0
        self._news: dict = {}  # what rank 0 applied since its last window broadcast
        # per-window wall-clock stages (the worker side's observability):
        # refreshed into last_stages after every submit
        self.timer = StageTimer()
        self.last_stages: dict = {}

    @full_f32()
    def run(self, max_windows: Optional[int] = None, reconnect_attempts: int = 60) -> bool:
        if self.mesh.size == 1:
            return self._serve(max_windows, reconnect_attempts)
        if self.mesh.rank != 0:
            return self._follow()
        try:
            return self._serve(max_windows, reconnect_attempts)
        finally:
            self._broadcast(None)  # the other ranks stop with rank 0

    def _serve(self, max_windows, reconnect_attempts) -> bool:
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
            with self.timer.stage("rollout"):
                returns = self._collect_window()
            with self.timer.stage("submit"):
                client.submit_returns(returns)
            self.last_stages = self.timer.report()

            status = client.get_server_state()
            if self.wait_for_new_state:
                deadline = time.time() + self.state_wait_timeout
                while (
                    status == FDClient.OPERATION_SUCCESSFUL_FLAG
                    and time.time() < deadline
                ):
                    time.sleep(0.02)
                    status = client.get_server_state()
            if status == FDClient.RPC_FAILED_FLAG:
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
            if status == FDClient.NEW_EXPERIMENT_FLAG:
                self._configure(client.current_state.cfg)
                self._apply_state(client.current_state)
            elif status == FDClient.NEW_STATE_FLAG and (
                self.windows % self.apply_state_every == 0
            ):
                self._apply_state(client.current_state)

        client.disconnect()
        return True

    # -- the mesh's other ranks ---------------------------------------------------

    def _broadcast(self, msg):
        """Rank 0's ``msg`` on every rank (the other ranks pass None)."""
        box = [msg]
        torch.distributed.broadcast_object_list(box, src=0, group=self.mesh.group)
        return box[0]

    def _follow(self) -> bool:
        """A rank other than 0: each window apply what rank 0 applied,
        evaluate this rank's members and join the gather, until rank 0
        stops."""
        while True:
            msg = self._broadcast(None)
            if msg is None:
                return True
            if "cfg" in msg:
                self._configure(msg["cfg"])
            if "state" in msg:
                self._apply_state(msg["state"])
            self.windows = msg["windows"]
            with self.timer.stage("rollout"):
                self._shard_window(msg["sub"], msg["ids"])

    # -- internals ---------------------------------------------------------------

    def _configure(self, cfg: dict) -> None:
        if self.mesh.size > 1 and self.mesh.rank == 0:
            self._news = {"cfg": cfg}
        if cfg.get("noise_kind") != "counter":
            raise RuntimeError("slice clients need the server started with noise_kind='counter'")
        from dfd_tpu_torch.utils.factory import get_vectorized_init_data

        env_id = cfg["env_id"]
        self._seed = int(cfg["random_seed"])
        self.sigma = float(cfg["noise_std"])
        self.normalize_obs = bool(cfg["normalize_obs"])
        self.obs_stats_update_chance = float(cfg["obs_stats_update_chance"])
        self.antithetic = bool(cfg.get("antithetic", False))
        if self.antithetic and self.n_members % 2 != 0:
            raise RuntimeError("antithetic mode needs an even shard size")

        env, model, distance_fn = get_vectorized_init_data(env_id, self.device)
        self.model = model
        self.env = env
        self.distance_fn = distance_fn
        self.horizon = env.max_episode_steps
        self.max_history = int(cfg.get("max_strategy_history_size", 2))
        self.noise = CounterNoise(
            model.num_params, random_seed=int(cfg["noise_seed"]), antithetic=self.antithetic,
            device=self.device,
        )
        self.fixed_obs_stats = Welford(model.input_shape)
        _, self.bn_state = model.init(self._seed)
        self.flat = None
        self._key = _levels.key_data(self._seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self._seed)

    def _apply_state(self, state) -> None:
        if self.mesh.size > 1 and self.mesh.rank == 0:
            self._news["state"] = state
        with self.timer.stage("apply_state"):
            self._apply_state_inner(state)

    def _apply_state_inner(self, state) -> None:
        # the wire ships the full state_dict view (params + BN buffers)
        vec = torch.as_tensor(np.array(state.policy_params, np.float32), device=self.device)
        params, bn_state = self.model.deserialize(vec)
        self.flat = self.model.get_flat(params)
        if bn_state:
            self.bn_state = bn_state
        self.epoch = state.epoch
        if state.obs_stats is not None:
            self.fixed_obs_stats.deserialize(state.obs_stats)
        # zeta + the archive zero-padded to a fixed leading extent
        self.zeta = (
            np.array(state.strategy_frames, np.float32)
            if state.strategy_frames is not None
            else np.zeros((1,) + tuple(self.env.obs_shape), np.float32)
        )
        t = state.strategy_history
        F = (
            self.model.output_shape
            if self.model.discrete
            else 2 * self.model.output_shape
        )
        self.archive = np.zeros((self.max_history, self.zeta.shape[0], F), np.float32)
        self.archive_count = 0
        if t is not None and np.asarray(t).ndim == 3:
            t = np.asarray(t, np.float32)
            self.archive_count = min(len(t), self.max_history)
            self.archive[: self.archive_count] = t[: self.archive_count]

    def chunks(self) -> int:
        """The rollouts (and perturb launches) of one window on this rank."""
        n = len(pop_sharding(self.mesh, self.n_members))
        C = self.population_chunk
        return n // C if C and C < n else 1

    def _window_draws(self, sub: np.ndarray, member_ids: np.ndarray) -> WindowDraws:
        P, T, dev = self.n_members, self.horizon, self.device
        if self.draw_source is None:
            draws = make_window_draws(self.generator, P, T, self.env)
        else:
            draws = WindowDraws(*(torch.as_tensor(x).to(dev) for x in
                                  self.draw_source(sub, member_ids)))
        expect = ((P + 1, T, self.env.action_width), (P + 1, T),
                  (P + 1,) + tuple(self.env.reset_shape))
        got = tuple(tuple(x.shape) for x in draws)
        if got != expect:
            raise ValueError(f"draw_source gave shapes {got}, expected {expect}")
        return draws

    def _collect_window(self):
        self._key, sub = _levels.split(self._key, 2)
        offset = ((self._seed * 2654435761) ^ (self.windows * 131)) & 0x3FFFFFFF
        if self.antithetic:
            offset &= ~1  # complete +-eps pairs per shard
        # the offset in Python ints, the ids in int64: exact past int32
        member_ids = offset + np.arange(self.n_members, dtype=np.int64)
        if self.mesh.size == 1:
            return self.window_returns(member_ids, self._window_draws(sub, member_ids))
        news, self._news = self._news, {}
        self._broadcast(dict(news, windows=self.windows, sub=sub, ids=member_ids))
        return self._shard_window(sub, member_ids)

    def _shard_window(self, sub: np.ndarray, member_ids: np.ndarray):
        """This rank's members of the window and the eval member on the
        window's draws, the members' results gathered over the ranks; rank 0
        gets the window's returns, the other ranks None."""
        P = len(member_ids)
        draws = self._window_draws(sub, member_ids)
        mine = pop_sharding(self.mesh, P)
        rows = torch.cat([torch.arange(mine.start, mine.stop, device=self.device),
                          torch.full((1,), P, device=self.device)])
        table, stats, ev = self._evaluate(member_ids[mine.start:mine.stop],
                                          WindowDraws(*(x[rows] for x in draws)))
        n = mine.stop - mine.start
        sampled = self.normalize_obs and self.obs_stats_update_chance > 0
        full, members = collectives.gather_results(
            self.mesh, table[:n], welford.WelfordState(*(x[:n] for x in stats)) if sampled
            else None, P)
        if self.mesh.rank != 0:
            return None
        if members is None:
            members = welford.init(stats.mean.shape[1:], self.device, batch=(P,))
        eval_stats = welford.WelfordState(*(x[n:] for x in stats))
        return self._returns(member_ids, torch.cat([full, table[n:]]),
                             welford.WelfordState(*(torch.cat(x) for x in
                                                    zip(members, eval_stats))), ev)

    def window_returns(self, member_ids: np.ndarray, draws: WindowDraws):
        """The returns of the consecutive ``member_ids`` (P of them, in
        chunks of ``population_chunk``) and of the eval member, last, on
        ``draws`` (P + 1 rows, the eval member's last), at the applied
        state."""
        return self._returns(member_ids, *self._evaluate(member_ids, draws))

    def _evaluate(self, member_ids: np.ndarray, draws: WindowDraws):
        """(table [P + 1, 4]: each member's reward, entropy, steps and
        novelty, the eval member's last; their sampled statistics, [P + 1]
        rows; the eval member's first visited states) of the consecutive
        ``member_ids`` and the eval member on ``draws``."""
        P, dev, model = len(member_ids), self.device, self.model
        C = self.population_chunk
        C = C if C and C < P and P % C == 0 else P
        Z = self.zeta.shape[0]
        obs_mean = torch.as_tensor(self.fixed_obs_stats.mean, dtype=torch.float32, device=dev)
        obs_std = torch.as_tensor(self.fixed_obs_stats.std, dtype=torch.float32, device=dev)
        zeta = torch.as_tensor(self.zeta, device=dev)
        archive = torch.as_tensor(self.archive, device=dev)
        chance = self.obs_stats_update_chance if self.normalize_obs else 0.0

        # chunk 0 carries the eval member as its last row (theta, no noise,
        # deterministic, its first Z states kept); the other chunks run lean
        parts, stats, ev, ev_part = [], [], None, None
        for c0 in range(0, P, C):
            ride = c0 == 0
            flats, _ = self.noise.perturb_block(self.flat, self.sigma, self.epoch,
                                                member_ids[c0:c0 + C], theta_row=ride)
            params = model.set_flat(flats)
            det = torch.zeros(flats.shape[0], dtype=torch.bool, device=dev)
            det[C:] = True
            rows = torch.arange(c0, c0 + C, device=dev)
            if ride:
                rows = torch.cat([rows, torch.full((1,), P, device=dev)])
            res = fd_rollout.episode_rollout(
                model, self.env, params, self.bn_state, self.horizon, det,
                obs_mean=obs_mean, obs_std=obs_std, normalize_obs=self.normalize_obs,
                obs_stats_update_chance=chance,
                action_noise=draws.action_noise[rows][:, None],
                stats_uniform=draws.stats_uniform[rows][:, None],
                reset_level=draws.reset_level[rows][:, None],
                collect_limit=Z if ride else 0,
            )
            novelty = novelty_batch(model, params, self.bn_state, zeta, archive,
                                    self.archive_count, self.distance_fn)
            part = torch.stack([res.reward[:, 0], res.entropy[:, 0],
                                res.steps[:, 0].to(torch.float32), novelty], dim=1)
            st = welford.WelfordState(*(x[:, 0] for x in res.obs_stats))
            parts.append(part[:C])
            stats.append(welford.WelfordState(*(x[:C] for x in st)))
            if ride:
                ev, ev_part = res.states[C], (part[C:], welford.WelfordState(*(x[C:] for x in st)))
            del flats, params, res
        parts.append(ev_part[0])
        stats.append(ev_part[1])
        return (torch.cat(parts), welford.WelfordState(*(torch.cat(x) for x in zip(*stats))), ev)

    def _returns(self, member_ids: np.ndarray, table: torch.Tensor, stats, ev):
        """FDReturns from ``_evaluate``'s results: one a member and the eval
        member's, last; the window's merged statistics on the first."""
        P, Z = len(member_ids), self.zeta.shape[0]
        # one merged Welford delta per window: the members and ONE eval member
        merged = welford.merge_population(stats)
        # the members' and the eval member's scalars cross to the host in one transfer
        table = table.cpu().numpy()
        eval_row = table[P]
        rewards, entropies, steps, novelty = table[:P].T
        returns = [
            FDReturn(
                epoch=self.epoch,
                encoded_noise="{},{}".format(self.epoch, int(member_ids[i])),
                reward=float(rewards[i]),
                novelty=float(novelty[i]),
                entropy=float(entropies[i]),
                timesteps=int(steps[i]),
            )
            for i in range(P)
        ]
        # the window's merged Welford delta rides on the first return (the
        # Chan merge is associative, so one merged delta per window is
        # equivalent to the reference's per-return deltas, run_server.py:143)
        n_sampled = float(merged.count)
        if n_sampled > 0:
            returns[0].obs_stats_update = (
                merged.mean.cpu().numpy().astype(np.float64).ravel().tolist()
                + merged.m2.cpu().numpy().astype(np.float64).ravel().tolist()
                + [n_sampled]
            )
        # eval duties: the fused deterministic member refreshes zeta, the EMA
        # baselines and omega server-side (reference worker/worker.py:34-35)
        ev_steps = int(eval_row[2])
        n_keep = int(min(ev_steps, Z))
        returns.append(
            FDReturn(
                epoch=self.epoch,
                encoded_noise="0",
                reward=float(eval_row[0]),
                novelty=float(eval_row[3]),
                entropy=float(eval_row[1]),
                timesteps=ev_steps,
                is_eval=True,
                eval_states=ev[:n_keep].cpu().numpy(),
            )
        )
        return returns
