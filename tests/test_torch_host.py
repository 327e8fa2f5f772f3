"""The port's host classes held against the JAX package's, on the CPU.

``Welford``, ``DSGD``/``SGD``, ``AdaptiveOmega``, the numpy noise sources,
``FDReturn``/``FDState`` and ``FDLearner`` are numpy copies of the JAX
package's: on the same inputs they are bit-exact (``assert_array_equal``,
``==``).  ``CounterNoiseSampler`` draws through the port's threefry normal:
its eps within 4e-6 absolute of JAX's (libm's ulps in the normal's
transform, the port's rule for eps), its encodings equal.  The wire view
(``serialize``/``deserialize``) of the four models equals JAX's for the same
weights and BatchNorm statistics, exactly; ``HostPolicy``'s forwards
(three products summed in another order) within rtol 1e-5, and its actions
on the same sampler stream equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dfd_tpu.core import noise as jnoise
from dfd_tpu.core import welford as jwelford
from dfd_tpu.core.flat import update_from_flat as j_update_from_flat
from dfd_tpu.envs import wrappers as jwrappers
from dfd_tpu.fd import returns as jreturns
from dfd_tpu.fd.dsgd import DSGD as JDSGD
from dfd_tpu.fd.dsgd import SGD as JSGD
from dfd_tpu.fd.learner import FDLearner as JFDLearner
from dfd_tpu.fd.omega import AdaptiveOmega as JOmega
from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
from dfd_tpu.models import GaussianMLP as JGaussianMLP
from dfd_tpu.models.atari import AtariCNN as JAtariCNN
from dfd_tpu.models.impala import ImpalaPolicy as JImpalaPolicy
from dfd_tpu.ops.standardize import standardize as j_standardize
from dfd_tpu.runners.policy import HostPolicy as JHostPolicy
from dfd_tpu_torch.convert import params_from_numpy
from dfd_tpu_torch.core import noise as pnoise
from dfd_tpu_torch.core import welford as pwelford
from dfd_tpu_torch.core.flat import update_from_flat
from dfd_tpu_torch.envs import wrappers as pwrappers
from dfd_tpu_torch.fd import returns as preturns
from dfd_tpu_torch.fd.dsgd import DSGD, SGD, DSGDParams, dsgd_update
from dfd_tpu_torch.fd.learner import FDLearner
from dfd_tpu_torch.fd.omega import AdaptiveOmega, OmegaParams, omega_init, omega_step
from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, GaussianMLP, ImpalaPolicy
from dfd_tpu_torch.ops.standardize import standardize_host
from dfd_tpu_torch.runners.policy import HostPolicy

CPU = "cpu"
TOL_EPS = 4e-6  # eps against JAX's: libm's ulps in the normal's transform


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- Welford ---------------------------------------------------------------------


def _welford_pair(shape):
    return jwelford.Welford(shape), pwelford.Welford(shape)


def _same_welford(j, p):
    np.testing.assert_array_equal(p.running_mean, j.running_mean)
    np.testing.assert_array_equal(p.running_variance, j.running_variance)
    np.testing.assert_array_equal(p.mean, j.mean)
    np.testing.assert_array_equal(p.std, j.std)
    assert p.count == j.count
    assert p.serialize() == j.serialize()


@pytest.mark.parametrize("shape", [(5,), (2, 3)])
def test_welford_update_matches_jax(shape):
    rng = np.random.default_rng(0)
    j, p = _welford_pair(shape)
    _same_welford(j, p)  # count < 2: zeros and ones
    for x in rng.standard_normal((40,) + shape):
        j.update(x)
        p.update(x)
        _same_welford(j, p)
    batch = rng.standard_normal((3,) + shape)
    j.increment(batch, 3)
    p.increment(batch, 3)
    _same_welford(j, p)


def test_welford_guards_and_dict_samples_match_jax():
    j, p = _welford_pair((3,))
    for w in (j, p):
        w.update({"frame": np.ones(3), "reward": 1.0, "done": False})
        w.update(np.ones(3))  # a constant feature: std 1
    _same_welford(j, p)
    np.testing.assert_array_equal(p.std, np.ones(3))
    p.reset()
    assert p.count == 0 and p.serialize() == jwelford.Welford((3,)).serialize()


def test_welford_serialized_merge_matches_jax():
    rng = np.random.default_rng(1)
    jg, pg = _welford_pair((4,))
    for worker in range(3):
        jl, pl = _welford_pair((4,))
        for x in rng.standard_normal((7 + worker, 4)):
            jl.update(x)
            pl.update(x)
        jg.merge_serialized(jl.serialize())
        pg.merge_serialized(pl.serialize())
        _same_welford(jg, pg)
    before = pg.serialize()
    pg.merge_serialized(pwelford.Welford((4,)).serialize())  # an empty update is a no-op
    assert pg.serialize() == before
    jd, pd = _welford_pair((4,))
    jd.deserialize(jg.serialize())
    pd.deserialize(pg.serialize())
    _same_welford(jd, pd)


# -- DSGD, SGD, omega, standardize ------------------------------------------------


def test_dsgd_and_sgd_steps_match_jax():
    rng = np.random.default_rng(0)
    flat = rng.standard_normal(257).astype(np.float32)
    for _ in range(3):
        grad = rng.standard_normal(257).astype(np.float32)
        j, p = JDSGD(257, lr=0.01), DSGD(257, lr=0.01)
        j.lr_scale = p.lr_scale = 0.61
        out = p.step(flat, grad)
        np.testing.assert_array_equal(out, j.step(flat, grad))
        assert out.dtype == np.float32 and p.steps == j.steps == 1
        np.testing.assert_array_equal(SGD(257, lr=0.1).step(flat, grad),
                                      JSGD(257, lr=0.1).step(flat, grad))
        flat = out


@pytest.mark.parametrize("omega", [0.0, 0.4, 1.0])
def test_dsgd_lr_scale_matches_jax(omega):
    j, p = JDSGD(10, lr=0.01), DSGD(10, lr=0.01)
    j.adjust_lr(JOmega(default_value=omega))
    p.adjust_lr(AdaptiveOmega(default_value=omega))
    assert p.lr_scale == j.lr_scale


@pytest.mark.parametrize("grad", [np.zeros(4, np.float32), np.full(4, np.nan, np.float32)])
def test_dsgd_zero_or_nan_norm_raises(grad):
    with pytest.raises(FloatingPointError):
        DSGD(4, lr=0.1).step(np.ones(4, np.float32), grad)


def test_dsgd_update_matches_host_class():
    rng = np.random.default_rng(1)
    flat = rng.standard_normal(64).astype(np.float32)
    grad = rng.standard_normal(64).astype(np.float32)
    host = DSGD(64, lr=0.02)
    host.lr_scale = 0.5
    hp = DSGDParams(lr=0.02, sqrt_d=float(np.sqrt(64)), min_scale=0.23, max_scale=1.0)
    got = dsgd_update(torch.from_numpy(flat), torch.from_numpy(grad), 0.5, hp)
    np.testing.assert_allclose(_np(got), host.step(flat, grad), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("threshold", [1.025, 1.035])
def test_omega_matches_jax_for_30_steps(threshold):
    kw = dict(default_value=0.3, improvement_threshold=threshold, reward_history_size=5,
              min_value=0, max_value=1, steps_to_min=7, steps_to_max=30)
    j, p = JOmega(**kw), AdaptiveOmega(**kw)
    rng = np.random.default_rng(2)
    rewards = np.concatenate([rng.normal(0, 1, 10), np.linspace(0, 5, 10), rng.normal(-3, 1, 10)])
    for r in rewards:
        j.step(float(r))
        p.step(float(r))
        assert p.omega == j.omega and p.reward_history == j.reward_history
    j.step(None)
    p.step(None)
    assert p.omega == j.omega


def test_omega_functional_form_matches_host_class():
    host = AdaptiveOmega(default_value=0.5, reward_history_size=4, steps_to_min=5, steps_to_max=20)
    hp = OmegaParams(improvement_threshold=host.improvement_threshold, min_omega=0.0,
                     max_omega=1.0, increase=host.increase, decrease=host.decrease)
    state = omega_init(0.5, 4, CPU)
    for r in [1.0, 2.0, 1.5, -1.0, -2.0, 3.0, 3.0, 3.1, 0.0]:
        host.step(r)
        state = omega_step(state, torch.tensor(r, dtype=torch.float32), hp)
        assert abs(float(state.omega) - host.omega) < 1e-6


@pytest.mark.parametrize("x", [[1.0, 2.0, 4.5, -1.0], [3.0, 3.0, 3.0]])
def test_standardize_host_matches_jax(x):
    np.testing.assert_array_equal(standardize_host(np.asarray(x)), j_standardize(np.asarray(x)))


def test_update_from_flat_matches_jax():
    jm = JDiscreteMLP(2, 9)
    params, state = jm.init(3)
    vec = np.random.default_rng(0).standard_normal(jm.num_params).astype(np.float32)
    tree = {**{k: dict(v) for k, v in params.items()}, "extra": {"x": np.ones(2, np.float32)}}
    want = j_update_from_flat(tree, vec, jm.param_spec, xp=np)
    pm = DiscreteMLP(2, 9, device=CPU)
    ptree = {k: {n: torch.as_tensor(a) for n, a in d.items()} for k, d in tree.items()}
    got = update_from_flat(ptree, torch.from_numpy(vec), pm.param_spec)
    for k, d in want.items():
        for n, a in d.items():
            np.testing.assert_array_equal(_np(got[k][n]), a)
    assert got["extra"]["x"] is ptree["extra"]["x"]  # leaves outside the spec carried over
    pop = update_from_flat(ptree, torch.from_numpy(np.stack([vec, -vec])), pm.param_spec)
    np.testing.assert_array_equal(_np(pop["l1"]["w"][1]), -want["l1"]["w"])


# -- noise sources ----------------------------------------------------------------


def test_rng_noise_source_matches_jax_and_decodes():
    j, p = jnoise.RNGNoiseSource(37, random_seed=9), pnoise.RNGNoiseSource(37, random_seed=9)
    encs = []
    for _ in range(5):
        (je, jeps), (pe, peps) = j.sample(), p.sample()
        assert pe == je
        np.testing.assert_array_equal(peps, jeps)
        encs.append((pe, peps))
    learner_side = pnoise.RNGNoiseSource(37, random_seed=1)
    for enc, eps in reversed(encs):
        np.testing.assert_array_equal(learner_side.decode(enc), eps)
        np.testing.assert_array_equal(learner_side.decode(enc), j.decode(enc))


def test_simple_noise_source_matches_jax():
    j, p = jnoise.SimpleNoiseSource(11, 4), pnoise.SimpleNoiseSource(11, 4)
    for _ in range(3):
        (je, jeps), (pe, peps) = j.sample(), p.sample()
        np.testing.assert_array_equal(peps, jeps)
        assert p.decode(pe) is pe


def test_shared_noise_table_matches_jax():
    j, p = jnoise.SharedNoiseTable(500, 23, 7), pnoise.SharedNoiseTable(500, 23, 7)
    for _ in range(4):
        (je, jeps), (pe, peps) = j.sample(), p.sample()
        assert pe == je
        np.testing.assert_array_equal(peps, jeps)
        np.testing.assert_array_equal(p.decode(pe), j.decode(je))
    with pytest.raises(ValueError):
        pnoise.SharedNoiseTable(23, 23)


@pytest.mark.parametrize("antithetic", [False, True])
def test_counter_noise_sampler_matches_jax(antithetic):
    d = 301
    j = jnoise.CounterNoiseSampler(jnoise.CounterNoise(d, 5, antithetic=antithetic), id_offset=3)
    p = pnoise.CounterNoiseSampler(pnoise.CounterNoise(d, 5, antithetic=antithetic, device=CPU),
                                   id_offset=3)
    for epoch in (0, 2, 3):
        j.set_epoch(epoch)
        p.set_epoch(epoch)
        for _ in range(3):
            (je, jeps), (pe, peps) = j.sample(), p.sample()
            assert pe == je
            np.testing.assert_allclose(peps, np.asarray(jeps), rtol=0, atol=TOL_EPS)
            np.testing.assert_allclose(p.decode(pe), np.asarray(jeps), rtol=0, atol=TOL_EPS)
    assert p._next == j._next


# -- returns and the learner ------------------------------------------------------


def test_returns_dataclasses_match_jax():
    for jc, pc in ((jreturns.FDReturn, preturns.FDReturn), (jreturns.FDState, preturns.FDState)):
        jf, pf = dataclasses.fields(jc), dataclasses.fields(pc)
        assert [f.name for f in pf] == [f.name for f in jf]
        assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


def _batch(rng, source, epoch, n):
    """The same returns for each package, (JAX's, the port's): with a
    SimpleNoiseSource the encoding is the vector itself."""
    out_j, out_p = [], []
    for _ in range(n):
        _, eps = source.sample()
        kw = dict(epoch=epoch, encoded_noise=eps, reward=float(rng.normal()), novelty=0.5,
                  entropy=0.1)
        out_j.append(jreturns.FDReturn(**kw))
        out_p.append(preturns.FDReturn(**kw))
    return out_j, out_p


def _learners(d, max_delayed, opt=(JDSGD, DSGD)):
    flat0 = np.random.default_rng(5).standard_normal(d).astype(np.float32)
    kw = dict(noise_std=0.02, batch_size=10, max_delayed_return=max_delayed)
    j = JFDLearner(flat0, opt[0](d, lr=0.01), JOmega(default_value=0.2),
                   jnoise.SimpleNoiseSource(d, 3), **kw)
    p = FDLearner(flat0, opt[1](d, lr=0.01), AdaptiveOmega(default_value=0.2),
                  pnoise.SimpleNoiseSource(d, 3), **kw)
    return j, p


def _same_learner(j, p):
    np.testing.assert_array_equal(p.flat, j.flat)
    assert p.epoch == j.epoch and p.discarded_returns == j.discarded_returns
    assert sorted(p.dist_map) == sorted(j.dist_map)
    for k in j.dist_map:
        np.testing.assert_array_equal(p.dist_map[k], j.dist_map[k])
    assert [e for _, e in p.policy_history] == [e for _, e in j.policy_history]


@pytest.mark.parametrize("opt", [(JDSGD, DSGD), (JSGD, SGD)])
def test_fd_step_matches_jax(opt):
    rng = np.random.default_rng(3)
    d = 5197
    j, p = _learners(d, 10, opt)
    src = pnoise.SimpleNoiseSource(d, 42)
    for epoch in range(5):
        rj, rp = _batch(rng, src, epoch, 10)
        assert p.step(rp, 0.1, 0.0, 0.0) == j.step(rj, 0.1, 0.0, 0.0)
        _same_learner(j, p)
        for a, b in zip(rj, rp):
            np.testing.assert_array_equal(b.perturbation, a.perturbation)


def test_fd_delayed_and_discarded_returns_match_jax():
    rng = np.random.default_rng(4)
    d = 600
    j, p = _learners(d, 3)
    src = pnoise.SimpleNoiseSource(d, 43)
    for epoch in range(4):
        rj, rp = _batch(rng, src, epoch, 8)
        assert p.step(rp, 0.0, 0.0, 0.0) == j.step(rj, 0.0, 0.0, 0.0)
    rj, rp = [], []
    for epoch in (4, 3, 2, 0):  # 0 is older than max_delayed_return=3: discarded
        bj, bp = _batch(rng, src, epoch, 2)
        rj += bj
        rp += bp
    assert p.step(rp, 0.0, 0.0, 0.0) == j.step(rj, 0.0, 0.0, 0.0)
    _same_learner(j, p)
    assert p.discarded_returns == 2


def test_fd_empty_batch_returns_zero():
    d = 16
    p = FDLearner(np.ones(d, np.float32), DSGD(d, lr=0.01), AdaptiveOmega(),
                  pnoise.SimpleNoiseSource(d), max_delayed_return=2)
    assert p.step([], None, None, None) == 0.0
    stale = preturns.FDReturn(epoch=99, encoded_noise=np.zeros(d), reward=1.0)
    assert p.step([stale], 0.0, 0.0, 0.0) == 0.0
    assert p.discarded_returns == 1 and p.epoch == 0


def test_fd_with_rng_noise_source_matches_jax():
    """The PCG64 replay source end to end: a worker samples, the learner decodes."""
    d = 32
    out = []
    for noise, ret, learner, sgd, omega in (
            (jnoise, jreturns.FDReturn, JFDLearner, JSGD, JOmega),
            (pnoise, preturns.FDReturn, FDLearner, SGD, AdaptiveOmega)):
        src = noise.RNGNoiseSource(d, random_seed=9)
        lr = learner(np.zeros(d, np.float32), sgd(d, lr=0.1), omega(), src, noise_std=0.5,
                     max_delayed_return=5)
        rets = [ret(epoch=0, encoded_noise=src.sample()[0], reward=float(i)) for i in range(6)]
        out.append((lr.step(rets, 0.0, 0.0, 0.0), lr.flat))
    assert out[0][0] == out[1][0] > 0
    np.testing.assert_array_equal(out[1][1], out[0][1])


# -- the wire view and the host policy ---------------------------------------------


def _models(name):
    """(JAX model, port model, observations [4, *obs]) at a small size."""
    rng = np.random.default_rng(7)
    if name == "discrete":
        return JDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU), rng.uniform(0, 1, (4, 2))
    if name == "gaussian":
        return JGaussianMLP(5, 3), GaussianMLP(5, 3, device=CPU), rng.normal(0, 1, (4, 5))
    if name == "atari":
        return (JAtariCNN((24, 24), 5, in_channels=3), AtariCNN((24, 24), 5, in_channels=3,
                                                                  device=CPU),
                rng.uniform(0, 1, (4, 3, 24, 24)))
    kw = dict(channels=(4, 8, 8), hidden=32)
    return (JImpalaPolicy((3, 16, 16), 5, **kw), ImpalaPolicy((3, 16, 16), 5, device=CPU, **kw),
            rng.uniform(0, 255, (4, 3, 16, 16)))


def _random_state(state, seed):
    """``state`` with every BatchNorm statistic drawn at random (nonzero
    means, variances away from 1, counts), so the wire view carries them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in state.items():
        out[k] = {"mean": rng.normal(0, 1, d["mean"].shape).astype(np.float32),
                  "var": rng.uniform(0.5, 2, d["var"].shape).astype(np.float32),
                  "n": np.asarray(rng.integers(1, 9), np.float32)}
    return out


def _same_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k])
        else:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("name", ["discrete", "gaussian", "atari", "impala"])
def test_wire_view_matches_jax(name):
    jm, pm, _ = _models(name)
    params, state = jm.init(11)
    state = _random_state(state, 1)
    pp, ps = params_from_numpy(pm, params, state, device=CPU)
    want = np.asarray(jm.serialize(params, state, xp=np))
    got = pm.serialize(pp, ps)
    assert pm.state_spec.size == jm.state_spec.size == want.size
    np.testing.assert_array_equal(_np(got), want)
    jp, js = jm.deserialize(want, xp=np)
    gp, gs = pm.deserialize(torch.from_numpy(want.copy()))
    _same_tree(gp, jp)
    _same_tree(gs, js)
    np.testing.assert_array_equal(_np(pm.get_flat(gp)), np.asarray(jm.get_flat(jp)))


@pytest.mark.parametrize("name", ["discrete", "gaussian", "atari"])
def test_host_policy_matches_jax(name):
    """Same flat and statistics, same sampler seed: the same actions, and the
    entropy, strategy and wire view of JAX's ``HostPolicy``."""
    jm, pm, obs = _models(name)
    params, state = jm.init(5)
    state = _random_state(state, 2)
    flat = np.asarray(jm.get_flat(params))
    j = JHostPolicy(jm, flat=flat, bn_state=state, seed=3)
    p = HostPolicy(pm, flat=flat, bn_state=params_from_numpy(pm, params, state, CPU)[1], seed=3)
    for x in obs:
        for det in (True, False):
            a, b = p.get_action(x, deterministic=det), j.get_action(x, deterministic=det)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.get_entropy(obs), j.get_entropy(obs), rtol=1e-5)
    np.testing.assert_allclose(p.get_strategy(obs), np.asarray(j.get_strategy(obs)), rtol=1e-5,
                               atol=1e-6)
    assert p.serialize() == j.serialize()
    wire = np.asarray(j.serialize(), np.float32) * np.float32(0.5)
    j.deserialize(wire)
    p.deserialize(wire)
    np.testing.assert_array_equal(p.get_trainable_flat(), j.get_trainable_flat())
    _same_tree(p.bn_state, j.bn_state)
    np.testing.assert_allclose(p.get_strategy(obs), np.asarray(j.get_strategy(obs)), rtol=1e-5,
                               atol=1e-6)


def test_impala_step_probs_and_host_policy_match_jax():
    """The recurrent host step: one frame, the clipped previous reward and
    the LSTM carry, five steps of deterministic actions; the dict-state
    entropy and strategy read the rewards."""
    jm, pm, frames = _models("impala")
    params, state = jm.init(6)
    state = _random_state(state, 3)
    flat = np.asarray(jm.get_flat(params))
    j = JHostPolicy(jm, flat=flat, bn_state=state, seed=4)
    p = HostPolicy(pm, flat=flat, bn_state=params_from_numpy(pm, params, state, CPU)[1], seed=4)
    obs = [{"frame": f.astype(np.float32), "reward": np.float32(r), "done": False}
           for f, r in zip(frames, (0.0, 2.5, -0.3, 1.0))]
    for o in obs + obs[:1]:
        assert p.get_action(o, deterministic=True) == j.get_action(o, deterministic=True)
        np.testing.assert_allclose(_np(p._carry[0][0]), np.asarray(j._carry[0]), rtol=1e-5,
                                   atol=1e-6)
    p.reset()
    j.reset()
    assert float(p._carry[0].abs().sum()) == 0.0
    np.testing.assert_allclose(p.get_entropy(obs), j.get_entropy(obs), rtol=1e-5)
    np.testing.assert_allclose(p.get_strategy(obs), np.asarray(j.get_strategy(obs)), rtol=1e-5,
                               atol=1e-6)
    jp = jm.set_flat(flat, xp=jnp)
    probs, carry = jm.step_probs(jp, state, jnp.asarray(frames[0], jnp.float32), jnp.float32(2.0),
                                 jm.initial_carry())
    pp, ps = params_from_numpy(pm, params, state, device=CPU)
    pparams = {k: {n: v[None] for n, v in d.items()} for k, d in pp.items()}
    got, pcarry = pm.step_probs(pparams, ps, torch.from_numpy(frames[:1].astype(np.float32)),
                                torch.tensor([2.0]), pm.initial_carry(1))
    np.testing.assert_allclose(_np(got[0]), np.asarray(probs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(pcarry[1][0]), np.asarray(carry[1]), rtol=1e-5, atol=1e-6)


# -- wrappers ---------------------------------------------------------------------


class _PixelEnv:
    """A tiny deterministic pixel env with an old-gym surface (HWC frames)."""

    n_actions = 5

    def __init__(self, episode_len=4):
        self.episode_len, self.t = episode_len, 0

    def reset(self):
        self.t = 0
        return np.full((8, 8, 3), 0.0, np.float32)

    def step(self, action):
        self.t += 1
        return (np.full((8, 8, 3), self.t * 20.0, np.float32), 1.0 if action == 0 else -0.5,
                self.t >= self.episode_len, {})


def test_impala_obs_wrapper_matches_jax():
    j, p = jwrappers.ImpalaObsWrapper(_PixelEnv()), pwrappers.ImpalaObsWrapper(_PixelEnv())
    assert p.n_actions == j.n_actions == 5
    for got, want in ((p.reset(), j.reset()), (p.step(0)[0], j.step(0)[0])):
        assert got["frame"].shape == (3, 8, 8)
        np.testing.assert_array_equal(got["frame"], want["frame"])
        assert (got["reward"], got["done"]) == (want["reward"], want["done"])
    assert pwrappers.frame_of({"frame": 3}) == 3 and pwrappers.frame_of(4) == 4
    chw = np.zeros((3, 5, 5))
    np.testing.assert_array_equal(pwrappers._to_chw(chw), jwrappers._to_chw(chw))


def test_action_playback_files_are_byte_equal_to_jax(tmp_path):
    files = []
    for mod, sub in ((jwrappers, "jax"), (pwrappers, "port")):
        folder = str(tmp_path / sub)
        env = mod.ActionPlaybackRecorder(_PixelEnv(episode_len=4), opt_id="w", episode_length=3,
                                         folder=folder)
        for ep in range(3):
            env.reset()
            for t in range(4 if ep != 1 else 2):  # episode 1 is short: dropped
                env.step((ep + t) % 5)
        env.reset()
        files.append(open(os.path.join(folder, "w.txt"), "rb").read())
    assert files[1] == files[0] and files[0].count(b"\n") == 2


# -- reporting and the sweep ----------------------------------------------------------


def test_reporter_and_make_reporter_match_jax(tmp_path, capsys):
    """Without wandb (not installed here) make_reporter degrades to the
    console and the history, as JAX's does; the sink sees every report and
    dump_jsonl writes JAX's file byte for byte."""
    from dfd_tpu.utils import metrics as jmetrics
    from dfd_tpu_torch.utils import metrics as pmetrics

    rows = [{"Epoch": 1, "Noisy Reward": 0.5, "_stage/rollout": 0.1},
            {"Epoch": 2, "Noisy Reward": 1.25, "Omega": 0.04}]
    files, outs = [], []
    for mod in (jmetrics, pmetrics):
        seen = []
        rep = mod.make_reporter("a-project", wandb_group="g")
        assert rep.wandb_run is None and not rep.quiet
        rep.sink = seen.append
        for r in rows:
            rep.report(r)
        assert seen == rows and rep.history == rows
        path = tmp_path / f"{mod.__name__}.jsonl"
        rep.dump_jsonl(str(path))
        files.append(path.read_bytes())
        outs.append(capsys.readouterr().out)
    assert files[1] == files[0] and outs[1] == outs[0]
    assert "_stage" not in outs[1] and "Noisy Reward  1.2500" in outs[1]


def test_random_search_matches_jax_and_wandb_sweep_needs_wandb():
    from dfd_tpu.utils import sweep as jsweep
    from dfd_tpu_torch.utils import sweep as psweep

    def run_trial(params):
        score = params["learning_rate"] * 100 - params["noise_std"] + params["batch_size"] / 1e3
        return [{"Policy Reward": score + k} for k in range(7)]

    j = jsweep.random_search(run_trial, n_trials=6, seed=3)
    p = psweep.random_search(run_trial, n_trials=6, seed=3)
    assert [(t.params, t.score, t.history_len) for t in p.trials] == \
        [(t.params, t.score, t.history_len) for t in j.trials]
    assert p.best.params == j.best.params
    assert psweep.REFERENCE_SWEEP_CONFIG == jsweep.REFERENCE_SWEEP_CONFIG
    with pytest.raises(RuntimeError, match="wandb is not installed"):
        psweep.wandb_sweep(lambda **kw: None)
