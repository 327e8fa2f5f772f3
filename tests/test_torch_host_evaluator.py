"""The port's batched host evaluator held against the JAX package's, on the
CPU (``dfd_tpu_torch.runners.host_evaluator`` against
``dfd_tpu.runners.host_evaluator``), with the vector envs it steps.

The JAX evaluator draws each forward's actions from its key chain: ``key,
sub = split(key)`` once before the loop and once a step, a lane's key
``fold_in(sub, id_offset + start)``, a member's ``split(lane_key, n)[i]``,
and a categorical sample ``argmax(gumbel(k, (A,)) + log p)``.  The parity
tests hand the port those Gumbel draws as its ``action_noise`` and JAX's
key words as its ``seed`` (the statistics' coins).  Tolerances: rewards,
timesteps and encodings exact; entropies, novelties and the sampled Welford
deltas within rtol 1e-5 (float32 forwards summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_tpu.core.noise import CounterNoise as JCounterNoise
from dfd_tpu.envs import ProcMazeEnv as JProcMazeEnv
from dfd_tpu.envs.native_pool import NativeTrapPool as JNativeTrapPool
from dfd_tpu.envs.vector_host import PythonVectorEnv as JPythonVectorEnv
from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
from dfd_tpu.models.impala import ImpalaPolicy as JImpalaPolicy
from dfd_tpu.ops import distances as jdist
from dfd_tpu.runners.host_env import HostEnv as JHostEnv
from dfd_tpu.runners.host_evaluator import BatchedHostEvaluator as JEvaluator
from dfd_tpu_torch.core.noise import CounterNoise
from dfd_tpu_torch.envs import ProcMazeEnv
from dfd_tpu_torch.envs.native_pool import NativeTrapPool
from dfd_tpu_torch.envs.vector_host import PythonVectorEnv, ThreadPoolVectorEnv
from dfd_tpu_torch.models import DiscreteMLP, ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import HostEnv
from dfd_tpu_torch.runners.host_evaluator import BatchedHostEvaluator, BatchWelford

CPU = "cpu"
torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker


def _mlp(seed=0):
    model = DiscreteMLP(2, 9, device=CPU)
    params, state = model.init(seed)
    return model, model.get_flat(params), state


def test_evaluate_population_returns():
    model, flat, state = _mlp(0)
    noise = CounterNoise(model.num_params, random_seed=1, device=CPU)
    ev = BatchedHostEvaluator(model, NativeTrapPool(6), noise, sigma=0.05, device=CPU)
    rets = ev.evaluate_population(flat, state, epoch=2, horizon=201, seed=0)
    assert len(rets) == 6
    for i, r in enumerate(rets):
        assert r.encoded_noise == f"2,{i}"
        assert r.timesteps == 201
        assert np.isfinite(r.reward) and np.isfinite(r.entropy)
    assert len({r.reward for r in rets}) > 1  # the members' perturbations differ
    assert ev.readbacks == 201  # one read back a lane-step


def test_host_evaluator_feeds_fd_learner():
    """Host-evaluated returns drive the host FD learner through the
    counter-noise decode (the fat-client workflow)."""
    from dfd_tpu_torch.fd import AdaptiveOmega, DSGD, FDLearner

    model, flat, state = _mlp(3)
    noise = CounterNoise(model.num_params, random_seed=3, device=CPU)
    ev = BatchedHostEvaluator(model, NativeTrapPool(8), noise, sigma=0.05, device=CPU)
    learner = FDLearner(flat.numpy(), DSGD(model.num_params, lr=0.05), AdaptiveOmega(), noise,
                        noise_std=0.05, max_delayed_return=5)
    rewards = []
    for k in range(4):
        rets = ev.evaluate_population(learner.flat, state, epoch=learner.epoch, horizon=201,
                                      seed=k)
        rewards.append(np.mean([r.reward for r in rets]))
        assert learner.step(rets, float(np.mean(rewards)), 0.0, 0.0) > 0
    assert learner.epoch == 4


class _ScriptedEnv:
    """Deterministic gym-surface env: obs encodes (t, last action); reward is
    a pure function of (env id, t, action); episodes end on a step budget."""

    def __init__(self, i, horizon=9):
        self.i, self.horizon, self.t, self.last = i, horizon, 0, 0

    def _obs(self):
        return np.array([self.t / 10.0, (self.i + self.last) / 10.0], np.float32)

    def reset(self):
        self.t, self.last = 0, 0
        return self._obs()

    def step(self, action):
        self.t += 1
        self.last = int(action)
        rew = float((self.i * 7 + self.t * 3 + self.last) % 5 - 2)
        done = self.t >= self.horizon or (self.i + self.t) % 11 == 10
        return self._obs(), rew, done, {}


def test_threadpool_vector_env_matches_python_loop():
    """The pooled env equals the Python loop, and both equal JAX's."""
    serial = PythonVectorEnv(_ScriptedEnv, 7)
    pooled = ThreadPoolVectorEnv(_ScriptedEnv, 7, n_workers=3)
    jax_serial = JPythonVectorEnv(_ScriptedEnv, 7)
    outs = [serial.reset_all(), pooled.reset_all(), jax_serial.reset_all()]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    rng = np.random.RandomState(0)
    for _ in range(12):
        acts = rng.randint(0, 9, 7)
        outs = [env.step(acts) for env in (serial, pooled, jax_serial)]
        for got in outs[1:]:
            for a, b in zip(got, outs[0]):
                np.testing.assert_array_equal(a, b)
    pooled.close()


def test_two_lane_pipeline_matches_single_lane_blocks():
    """An L-lane evaluation of members [0, n) equals L single-lane
    evaluations of its blocks on the default action noise: a member's draws
    depend on its global id, not on how the shard is cut into lanes."""
    model, flat, state = _mlp(0)

    def returns_for(pools, id_offset=0):
        noise = CounterNoise(model.num_params, random_seed=1, device=CPU)
        ev = BatchedHostEvaluator(model, pools, noise, sigma=0.05, device=CPU)
        return ev.evaluate_population(flat, state, epoch=2, horizon=201, seed=5,
                                      id_offset=id_offset)

    two_lane = returns_for([NativeTrapPool(4), NativeTrapPool(4)])
    half_a = returns_for(NativeTrapPool(4), id_offset=0)
    half_b = returns_for(NativeTrapPool(4), id_offset=4)
    assert len(two_lane) == 8
    for got, want in zip(two_lane, half_a + half_b):
        assert got.encoded_noise == want.encoded_noise
        assert got.timesteps == want.timesteps
        assert got.reward == want.reward
        assert got.entropy == want.entropy


def test_batch_welford_matches_jax():
    from dfd_tpu.runners.host_evaluator import BatchWelford as JBatchWelford

    rng = np.random.RandomState(4)
    mine, theirs = BatchWelford(5, (3,)), JBatchWelford(5, (3,))
    for _ in range(6):
        obs, mask = rng.randn(2, 3).astype(np.float32), rng.rand(2) < 0.7
        for w in (mine, theirs):
            w.update_masked(obs, mask, rows=slice(1, 3))
    for i in range(5):
        assert mine.serialize_member(i) == theirs.serialize_member(i)


# -- parity with the JAX evaluator on its key chain ---------------------------------


def jax_action_noise(key, horizon: int, A: int):
    """The port's ``action_noise`` that reproduces the JAX evaluator's
    sampled actions under ``key``: Gumbel draws [n, A] of step t's lane key
    ``fold_in(sub_t, first)``, a member's ``split(lane_key, n)[i]``."""
    subs = []
    for _ in range(horizon + 1):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draw = jax.jit(lambda sub, first, n: jax.vmap(
        lambda k: jax.random.gumbel(k, (A,), jnp.float32))(
            jax.random.split(jax.random.fold_in(sub, first), n)), static_argnums=2)
    return lambda t, first, n: np.array(draw(subs[t], first, n))


def _same_returns(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.encoded_noise, g.timesteps, g.reward) == (w.encoded_noise, w.timesteps,
                                                            w.reward)
        np.testing.assert_allclose(g.entropy, w.entropy, rtol=rtol)
        np.testing.assert_allclose(g.novelty, w.novelty, rtol=rtol, atol=1e-7)
        assert len(g.obs_stats_update) == len(w.obs_stats_update)
        np.testing.assert_allclose(g.obs_stats_update, w.obs_stats_update, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("case", ["feedforward", "normalize_obs", "novelty"])
def test_trap_evaluator_matches_jax(case):
    """DiscreteMLP on two lanes of native trap pools (3 + 4 members from id
    5), 201 steps: the plain case, normalized observations with sampled
    Welford deltas, and novelty against a zero-padded archive of 3 live
    strategies out of 4 slots."""
    jm = JDiscreteMLP(2, 9)
    params_np, state_np = jm.init(2)
    flat = jm.get_flat(params_np)
    model, _, state = _mlp(2)
    kw = {}
    pkw = {}
    if case == "normalize_obs":
        kw = dict(normalize_obs=True, obs_stats_update_chance=0.3)
        pkw = dict(obs_mean=np.array([0.3, 0.4], np.float32),
                   obs_std=np.array([0.2, 0.3], np.float32))
    if case == "novelty":
        kw = dict(distance_fn=jdist.categorical_tvd)
        rng = np.random.RandomState(7)
        zeta = rng.rand(5, 2).astype(np.float32)
        archive = np.zeros((4, 5, 9), np.float32)
        archive[:3] = rng.dirichlet(np.ones(9), size=(3, 5)).astype(np.float32)
        pkw = dict(zeta=zeta, archive=archive, archive_count=3)
    key = jax.random.key(11)
    jev = JEvaluator(jm, [JNativeTrapPool(3), JNativeTrapPool(4)],
                     JCounterNoise(jm.num_params, random_seed=4), sigma=0.05, **kw)
    want = jev.evaluate_population(flat, state_np, epoch=3, horizon=201, key=key, id_offset=5,
                                   **pkw)
    pkw_port = dict(pkw)
    kw_port = dict(kw)
    if case == "novelty":
        kw_port["distance_fn"] = distances.categorical_tvd
    ev = BatchedHostEvaluator(model, [NativeTrapPool(3), NativeTrapPool(4)],
                              CounterNoise(model.num_params, random_seed=4, device=CPU),
                              sigma=0.05, device=CPU, **kw_port)
    got = ev.evaluate_population(torch.from_numpy(flat), state, epoch=3, horizon=201,
                                 seed=np.asarray(jax.random.key_data(key)), id_offset=5,
                                 action_noise=jax_action_noise(key, 201, 9), **pkw_port)
    _same_returns(got, want)
    if case == "normalize_obs":
        assert sum(bool(r.obs_stats_update) for r in got) == 7
    if case == "novelty":
        assert min(r.novelty for r in got) > 0


def test_recurrent_evaluator_matches_jax():
    """A small ImpalaPolicy (8/16/16, hidden 32, fused_feat) with its LSTM
    carry and previous reward over a PythonVectorEnv of 4 host ProcMaze
    envs (3x32x32 frames, 10 steps), one lane."""
    env_kw = dict(grid=4, scale=8, max_steps=10, num_levels=20)
    model_kw = dict(channels=(8, 16, 16), hidden=32, conv_impl="fused_feat")
    jenv = JProcMazeEnv(**env_kw)
    jm = JImpalaPolicy(jenv.obs_shape, jenv.n_actions, **model_kw)
    params_np, state_np = jm.init(1)
    flat = jm.get_flat(params_np)
    key = jax.random.key(3)
    jev = JEvaluator(jm, JPythonVectorEnv(lambda i: JHostEnv(JProcMazeEnv(**env_kw), seed=i), 4),
                     JCounterNoise(jm.num_params, random_seed=2), sigma=0.05)
    want = jev.evaluate_population(flat, state_np, epoch=1, horizon=10, key=key)

    env = ProcMazeEnv(**env_kw, device=CPU)
    model = ImpalaPolicy(env.obs_shape, env.n_actions, device=CPU, **model_kw)
    _, state = model.init(1)
    ev = BatchedHostEvaluator(
        model, PythonVectorEnv(lambda i: HostEnv(ProcMazeEnv(**env_kw, device=CPU), seed=i), 4),
        CounterNoise(model.num_params, random_seed=2, device=CPU), sigma=0.05, device=CPU)
    got = ev.evaluate_population(torch.from_numpy(flat), state, epoch=1, horizon=10,
                                 seed=np.asarray(jax.random.key_data(key)),
                                 action_noise=jax_action_noise(key, 10, env.n_actions))
    _same_returns(got, want)
    assert sum(r.reward for r in got) != 0 or len({r.timesteps for r in got}) > 1


def test_evaluator_refuses_a_model_on_another_device():
    model, _, _ = _mlp(0)
    with pytest.raises(ValueError, match="must live on"):
        BatchedHostEvaluator(model, NativeTrapPool(2), CounterNoise(model.num_params, device=CPU),
                             sigma=0.05, device="meta")
