"""Batched host-env population evaluator, the port of
``dfd_tpu.runners.host_evaluator``: the hybrid hot path for environments
whose engines run on the host (C++ pools, Python envs).

One process evaluates a whole population of perturbations against N host
envs in lockstep:

  host envs  --obs batch-->  device: one batched perturbed forward + sampling
     ^                                        |
     +----------------- actions --------------+

The population's weights come from one ``CounterNoise.perturb_block`` call
(``normal_kernel`` on the card) per evaluation.  Each timestep of a lane
("lane-step") is one batched forward over the lane's members
(``model.act_step``, the rollout engine's per-step surface; an
``ImpalaPolicy``'s through ``prepare`` and its fused torso), its actions and
entropies read back to the host in one transfer, and one batched host env
step.  With two or more lanes the loop pipelines: a lane's forward is
queued on the device, its read back lands in pinned memory behind a CUDA
event, and the host steps the previous lane's envs before it waits on that
event.

Randomness is injected.  Each forward's action noise (Gumbel draws for a
categorical policy, standard normals for a Gaussian one) comes from
``action_noise(t, first_id, n) -> [n, A]``: step ``t`` of the ``n``
members whose global ids start at ``first_id``.  By default it is drawn from
a ``torch.Generator`` on the evaluator's device seeded from (``seed``, t,
first_id), so a member's stream depends on its global id and not on how the
population is cut into lanes.  The sampled observation statistics' coins
come from ``numpy.random.default_rng(seed)`` in the JAX evaluator's order
(the parity tests pass ``jax.random.key_data(key)`` as ``seed``).

Results come back as ``FDReturn`` s carrying ``"{epoch},{id}"`` counter-noise
encodings, so the learner regenerates each perturbation.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from dfd_tpu_torch.core.device import Staging, full_f32, resolve_device
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.fd.returns import FDReturn
from dfd_tpu_torch.models.base import PolicyModel
from dfd_tpu_torch.novelty.handler import novelty_batch


class BatchWelford:
    """Per-member streaming mean/variance, vectorized over the population:
    the update algebra of :class:`dfd_tpu_torch.core.welford.Welford` applied
    to a masked row subset per step, so every return carries its own sampled
    Welford delta (reference worker/agent.py:38-39)."""

    def __init__(self, n: int, shape):
        self.shape = tuple(shape)
        self.mean = np.zeros((n,) + self.shape, np.float32)
        self.m2 = np.zeros((n,) + self.shape, np.float32)
        self.count = np.zeros(n, np.int64)

    def update_masked(self, obs: np.ndarray, mask: np.ndarray, rows=None) -> None:
        """``rows``: the global slice that the (obs, mask) block maps to (a
        multi-lane evaluator updates one lane's block at a time)."""
        if not mask.any():
            return
        if rows is None:
            rows = slice(0, len(mask))
        idx = np.arange(rows.start, rows.stop)[mask]
        obs = np.asarray(obs, np.float32)[mask].reshape((-1,) + self.shape)
        self.count[idx] += 1
        c = self.count[idx].reshape((-1,) + (1,) * len(self.shape)).astype(np.float32)
        delta = obs - self.mean[idx]
        delta_n = delta / c
        self.mean[idx] += delta_n
        self.m2[idx] += delta * delta_n * (c - 1)

    def serialize_member(self, i: int) -> List[float]:
        """Wire format of one member's delta (``Welford.serialize``'s layout)."""
        return self.mean[i].ravel().tolist() + self.m2[i].ravel().tolist() + [int(self.count[i])]


def _seed_words(seed) -> np.ndarray:
    """uint32 words of an int seed (low word first) or of an array of words."""
    if np.ndim(seed) == 0:
        s = int(seed)
        return np.array([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF], np.uint32)
    return np.asarray(seed).ravel().astype(np.uint32)


class BatchedHostEvaluator:
    def __init__(self, model: PolicyModel, vector_env, noise: CounterNoise, sigma: float,
                 normalize_obs: bool = False, obs_stats_update_chance: float = 0.0,
                 distance_fn: Optional[Callable] = None, device=None):
        """``vector_env``: one vector backend, or a sequence of them
        ("lanes"), pipelined against each other.  ``model`` and ``noise``
        live on ``device`` (the card unless ``"cpu"`` is passed)."""
        self.device = resolve_device(device)
        if model.device != self.device or noise.device != self.device:
            raise ValueError(f"model ({model.device}) and noise ({noise.device}) must live on "
                             f"{self.device}")
        self.model = model
        lanes = list(vector_env) if isinstance(vector_env, (list, tuple)) else [vector_env]
        self.lanes = lanes
        self.noise = noise
        self.sigma = sigma
        self.normalize_obs = normalize_obs
        self.obs_stats_update_chance = obs_stats_update_chance
        self.distance_fn = distance_fn
        self.n = sum(lane.n_envs for lane in lanes)
        self.readbacks = 0  # the host's waits for a lane-step's actions

    # -- novelty -------------------------------------------------------------------

    def compute_novelty(self, flats, bn_state, zeta, archive, count: int) -> np.ndarray:
        """Per-row novelty of ``flats`` [K, d] against a zero-padded [H, Z, F]
        archive holding ``count`` live entries; zeros below 2 entries."""
        rows = flats.shape[0]
        if self.distance_fn is None or zeta is None or archive is None or count < 2:
            return np.zeros(rows, np.float32)
        archive = np.asarray(archive, np.float32)
        if archive.ndim != 3:
            return np.zeros(rows, np.float32)
        dev = self.device
        flats = torch.as_tensor(flats, dtype=torch.float32, device=dev)
        out = novelty_batch(self.model, self.model.set_flat(flats), bn_state,
                            torch.as_tensor(np.asarray(zeta, np.float32), device=dev),
                            torch.as_tensor(archive, device=dev), int(count), self.distance_fn)
        return out.cpu().numpy()

    # -- randomness ----------------------------------------------------------------

    def default_action_noise(self, seed) -> Callable[[int, int, int], torch.Tensor]:
        """The default source: step t of the n members from global id
        ``first`` drawn from a generator seeded from (seed, t, first)."""
        words = [int(w) for w in _seed_words(seed)]
        A = self.model.output_shape
        discrete = self.model.discrete
        dev = self.device

        def draw(t: int, first: int, n: int) -> torch.Tensor:
            state = np.random.SeedSequence(words + [int(t), int(first)]).generate_state(2)
            g = torch.Generator(device=dev)
            g.manual_seed(int(state[0]) | (int(state[1]) << 32) & 0x7FFFFFFFFFFFFFFF)
            if discrete:
                u = torch.rand((n, A), generator=g, device=dev)
                return -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
            return torch.randn((n, A), generator=g, device=dev)

        return draw

    # -- evaluation ----------------------------------------------------------------

    @full_f32()
    def evaluate_population(
        self,
        flat,
        bn_state,
        epoch: int,
        horizon: int,
        seed=0,
        obs_mean: Optional[np.ndarray] = None,
        obs_std: Optional[np.ndarray] = None,
        id_offset: int = 0,
        zeta=None,
        archive=None,
        archive_count: int = 0,
        action_noise: Optional[Callable[[int, int, int], object]] = None,
    ) -> List[FDReturn]:
        """One episode per population member (member ``id_offset + i`` <->
        env i), lockstep.  ``id_offset`` keeps member ids globally unique
        across evaluators.  ``seed``: an int or uint32 words, seeding the
        statistics' coins and the default action noise.

        With ``normalize_obs`` and ``obs_stats_update_chance`` each member
        samples its own Welford delta from the raw observations it visits
        and ships it on its return; with ``zeta``/``archive`` (and a
        ``distance_fn``) each return carries its novelty against the
        archive."""
        n, lanes, dev, model = self.n, self.lanes, self.device, self.model
        L = len(lanes)
        draw = action_noise or self.default_action_noise(seed)
        flat = torch.as_tensor(flat, dtype=torch.float32, device=dev)
        pop_flats, _ = self.noise.perturb_block(flat, self.sigma, epoch,
                                                np.arange(id_offset, id_offset + n))
        # lane l covers global members [starts[l], starts[l] + lanes[l].n_envs)
        starts = np.cumsum([0] + [lane.n_envs for lane in lanes])[:-1]
        params = [model.prepare(model.set_flat(pop_flats[int(s):int(s) + lane.n_envs]), bn_state)
                  for s, lane in zip(starts, lanes)]
        obs = [lane.reset_all() for lane in lanes]
        obs_shape = obs[0].shape[1:]
        if self.normalize_obs:
            as_dev = lambda v, fill: (torch.full(obs_shape, fill, dtype=torch.float32, device=dev)
                                      if v is None else
                                      torch.as_tensor(np.asarray(v, np.float32), device=dev))
            mean_t, std_t = as_dev(obs_mean, 0.0), as_dev(obs_std, 1.0)

        rewards = np.zeros(n, np.float64)
        ent_sum = np.zeros(n, np.float64)
        steps = np.zeros(n, np.int64)
        alive = [np.ones(lane.n_envs, bool) for lane in lanes]

        sample_stats = self.normalize_obs and self.obs_stats_update_chance > 0
        if sample_stats:
            stats = BatchWelford(n, obs_shape)
            stats_rng = np.random.default_rng(_seed_words(seed))

        carry = [tuple(c[:, None] for c in model.initial_carry(lane.n_envs)) for lane in lanes]
        prev_rewards = [np.zeros(lane.n_envs, np.float32) for lane in lanes]
        staging = [Staging(dev) for _ in lanes]
        pinned = [None] * L
        no_det = [torch.zeros(lane.n_envs, dtype=torch.bool, device=dev) for lane in lanes]
        not_done = [torch.zeros((lane.n_envs, 1), dtype=torch.bool, device=dev) for lane in lanes]

        def dispatch(l, t):
            """Queue lane l's step-t forward and the read back of its actions
            and entropies; returns what ``collect`` waits on."""
            lane, m = lanes[l], lanes[l].n_envs
            if sample_stats:
                # sample the raw obs the member is about to act on
                g = slice(int(starts[l]), int(starts[l]) + m)
                coins = stats_rng.random(m) < self.obs_stats_update_chance
                stats.update_masked(np.asarray(obs[l]), alive[l] & coins, rows=g)
            x = staging[l](np.asarray(obs[l], np.float32))
            if self.normalize_obs:
                x = torch.clamp((x - mean_t) / std_t, -10, 10)
            noise = torch.as_tensor(draw(t, id_offset + int(starts[l]), m), dtype=torch.float32,
                                    device=dev)
            prev_r = staging[l](prev_rewards[l])[:, None] if model.recurrent else None
            action, entropy, carry[l] = model.act_step(
                params[l], bn_state, x[:, None], prev_r, not_done[l], carry[l], no_det[l],
                noise[:, None])
            packed = torch.cat([action.reshape(m, -1).to(torch.float32), entropy.reshape(m, 1)],
                               dim=1)
            if dev.type != "cuda":
                return packed, None
            if pinned[l] is None:
                pinned[l] = torch.empty(packed.shape, dtype=torch.float32).pin_memory()
            pinned[l].copy_(packed, non_blocking=True)
            done_event = torch.cuda.Event()
            done_event.record()
            return pinned[l], done_event

        def collect(l, pending):
            """Wait for lane l's read back: (actions, entropies) on the host."""
            host, done_event = pending
            if done_event is not None:
                done_event.synchronize()
            self.readbacks += 1
            packed = host.numpy().copy()
            actions = packed[:, :-1]
            actions = actions[:, 0].astype(np.int64) if model.discrete else actions
            return actions, packed[:, -1]

        pending = [dispatch(l, 0) for l in range(L)]
        for t in range(horizon):
            for l, lane in enumerate(lanes):
                if pending[l] is None:
                    continue
                actions, entropies = collect(l, pending[l])
                o, rew, done = lane.step(actions)
                obs[l] = o
                if model.recurrent:
                    # the policy reads the previous transition's reward next
                    # step; a finished member's carry and reward go stale
                    # harmlessly, its alive mask stops the accounting
                    prev_rewards[l] = np.asarray(rew, np.float32)
                g = slice(int(starts[l]), int(starts[l]) + lane.n_envs)
                a = alive[l]
                # basic-slice views write through to the global accumulators
                rewards[g][a] += rew[a]
                ent_sum[g][a] += entropies[a]
                steps[g][a] += 1
                alive[l] = a & ~np.asarray(done)
                pending[l] = dispatch(l, t + 1) if (t + 1 < horizon and alive[l].any()) else None
            if all(p is None for p in pending):
                break

        novelty = self.compute_novelty(pop_flats, bn_state, zeta, archive, archive_count)

        out = []
        for i in range(n):
            r = FDReturn(
                epoch=epoch,
                encoded_noise="{},{}".format(epoch, id_offset + i),
                reward=float(rewards[i]),
                novelty=float(novelty[i]),
                entropy=float(ent_sum[i] / max(int(steps[i]), 1)),
                timesteps=int(steps[i]),
            )
            if sample_stats and stats.count[i] > 0:
                r.obs_stats_update = stats.serialize_member(i)
            out.append(r)
        return out
