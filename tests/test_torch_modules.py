"""The port's modules held against their JAX counterparts, one at a time.

The same numpy inputs, made from a seed, go through the JAX function and its
port on the CPU.  Tolerances: flat views, the env and the init draws are
exact; float32 arithmetic in another order is held to rtol 1e-6, and model
forwards (matrix products summed in another order) to rtol 1e-5.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_state_numpy
from dfd_tpu.core import welford as jw
from dfd_tpu.envs.trap import TrapEnv as JaxTrapEnv
from dfd_tpu.fd import combine as jcombine
from dfd_tpu.fd import dsgd as jdsgd
from dfd_tpu.fd import omega as jomega
from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
from dfd_tpu.models import layers as jlayers
from dfd_tpu.novelty.handler import StrategyHandler as JaxStrategyHandler
from dfd_tpu.ops import distances as jdist
from dfd_tpu.ops.standardize import affine_transform as jaffine
from dfd_tpu.ops.standardize import standardize as jstandardize
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from dfd_tpu_torch.core import welford as pw
from dfd_tpu_torch.envs import TrapEnv
from dfd_tpu_torch.fd import combine as pcombine
from dfd_tpu_torch.fd import dsgd as pdsgd
from dfd_tpu_torch.fd import omega as pomega
from dfd_tpu_torch.models import DiscreteMLP
from dfd_tpu_torch.novelty.handler import StrategyHandler
from dfd_tpu_torch.ops import distances as pdist
from dfd_tpu_torch.ops.standardize import affine_transform as paffine
from dfd_tpu_torch.ops.standardize import standardize as pstandardize
from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
T = torch.from_numpy


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


# -- package rules --------------------------------------------------------------


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|dfd_tpu)(\.|\s|$)", re.M)
    files = (sorted((ROOT / "dfd_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("torch_*.py")))
    assert len(files) > 20
    assert {ROOT / "tools" / "torch_epoch_profile.py", ROOT / "tools" / "torch_mma_variants.py"} \
        <= set(files)
    assert {ROOT / "dfd_tpu_torch" / m for m in (
        "ops/gemm_chain.py", "ops/relayout.py", "ops/res_chain.py", "probes/_common.py",
        "probes/gemm.py", "probes/torso.py", "probes/pool.py", "probes/wide.py",
        "core/noise.py", "ops/noise.py", "ops/smallsolve.py", "ops/swimmer.py",
        "envs/swimmer.py", "envs/pendulum.py", "envs/cartpole.py", "models/mujoco.py",
        "envs/framestack.py", "envs/vector_host.py", "envs/native_pool.py",
        "runners/host_evaluator.py", "distributed/__init__.py", "distributed/wire.py",
        "distributed/server.py", "distributed/client.py", "runners/server.py",
        "runners/client.py", "runners/fat_client.py", "runners/slice_client.py",
        "envs/gym_adapter.py", "envs/atari_wrappers.py", "parallel/__init__.py",
        "parallel/mesh.py", "parallel/collectives.py", "parity.py", "bench.py",
        "version.py", "_native/__init__.py")} <= set(files)
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_port_imports_without_jax_installed():
    """Every module imports with jax and dfd_tpu made unimportable."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "dfd_tpu_torch").rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\nsys.modules['dfd_tpu'] = None\n"
        f"for m in {mods!r}:\n    importlib.import_module(m.removesuffix('.__init__'))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- core -------------------------------------------------------------------------


def _model_pair(seed=3):
    jm, pm = JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU)
    params_np, bn_np = jm.init(seed)
    params, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    return jm, pm, params_np, bn_np, params, bn


def test_flat_round_trip_and_order():
    jm, pm, params_np, _, params, _ = _model_pair()
    assert pm.param_spec.entries == jm.param_spec.entries
    assert pm.num_params == 5197
    flat = pm.get_flat(params)
    np.testing.assert_array_equal(flat.numpy(), jm.get_flat(params_np))
    np.testing.assert_array_equal(pm.get_flat(pm.set_flat(flat)).numpy(), flat.numpy())


def test_unflatten_population_gives_views():
    _, pm, _, _, params, _ = _model_pair()
    pop = pm.get_flat(params)[None].repeat(3, 1)
    tree = pm.set_flat(pop)
    w = tree["l2"]["w"]
    assert w.shape == (3, 64, 64)
    assert w.untyped_storage().data_ptr() == pop.untyped_storage().data_ptr()
    pop[1].zero_()
    assert float(w[1].abs().sum()) == 0.0 and float(w[0].abs().sum()) > 0
    leaves = [tree[p[0]][p[1]] for p, _, _ in pm.param_spec.entries]
    np.testing.assert_array_equal(
        torch.cat([x.reshape(3, -1) for x in leaves], 1).numpy(), pop.numpy()
    )


def _welford_inputs(rng, batch=None):
    shape = (batch, 7, 3) if batch else (7, 3)
    xs = rng.randn(*shape).astype(np.float32)
    mask = (rng.rand(*shape[:-1]) < 0.6).astype(np.float32)
    return xs, mask


def test_welford_forms_match_jax():
    rng = np.random.RandomState(0)
    js, ps = jw.jnp_init((3,)), pw.init((3,), CPU)
    for _ in range(4):
        xs, mask = _welford_inputs(rng)
        js = jw.jnp_update_batch(js, xs, mask)
        ps = pw.update_batch(ps, T(xs), T(mask))
        for a, b in zip(ps, js):
            _close(a, b, rtol=1e-6, atol=1e-7)
    jm, pmn = jw.jnp_mean_std(js), pw.mean_std(ps)
    for a, b in zip(pmn, jm):
        _close(a, b, rtol=1e-6)
    # guarded views: fewer than two samples -> (0, 1)
    for a, b in zip(pw.mean_std(pw.init((3,), CPU)), jw.jnp_mean_std(jw.jnp_init((3,)))):
        _close(a, b)
    # merge, and the population merge (closed form vs the JAX sequential fold)
    xs, mask = _welford_inputs(rng, batch=5)
    j_pop = jax.vmap(lambda x, m: jw.jnp_update_batch(jw.jnp_init((3,)), x, m))(xs, mask)
    p_pop = pw.update_batch(pw.init((3,), CPU, batch=(5,)), T(xs), T(mask))
    for a, b in zip(p_pop, j_pop):
        _close(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(pw.merge_population(p_pop), jw.jnp_merge_population(j_pop)):
        _close(a, b, rtol=1e-6)
    for a, b in zip(pw.merge(ps, pw.merge_population(p_pop)),
                    jw.jnp_merge(js, jw.jnp_merge_population(j_pop))):
        _close(a, b, rtol=1e-6)


def test_welford_merge_keeps_a_side_when_both_empty():
    a = pw.WelfordState(T(np.array([1.0, 2.0], np.float32)), T(np.zeros(2, np.float32)),
                        torch.tensor(0.0))
    out = pw.merge(a, pw.init((2,), CPU))
    np.testing.assert_array_equal(out.mean.numpy(), [1.0, 2.0])
    assert float(out.count) == 0


# -- fd ---------------------------------------------------------------------------------


def test_omega_step_matches_jax_over_30_steps():
    hp = dict(improvement_threshold=1.035, min_omega=0.0, max_omega=1.0,
              increase=1 / 75, decrease=1 / 25)
    jh, ph = jomega.OmegaParams(**hp), pomega.OmegaParams(**hp)
    js, ps = jomega.omega_init(0.3, 7), pomega.omega_init(0.3, 7, CPU)
    rng = np.random.RandomState(1)
    rewards = np.concatenate([rng.randn(10) * 5 - 20, np.linspace(-3, 40, 20)]).astype(np.float32)
    seen = []
    for r in rewards:
        js = jomega.omega_step(js, jnp.float32(r), jh)
        ps = pomega.omega_step(ps, torch.tensor(r), ph)
        for a, b in zip(ps, js):
            _close(a, b, rtol=1e-6)
        seen.append(float(ps.omega))
    steps = np.diff([0.3] + seen)
    assert (steps > 0).any() and (steps < 0).any()  # both branches ran


def test_dsgd_update_matches_jax_including_zero_norm():
    rng = np.random.RandomState(2)
    flat, grad = rng.randn(2, 300).astype(np.float32)
    jhp = jdsgd.DSGDParams(lr=0.05, sqrt_d=float(np.sqrt(300)), min_scale=0.23, max_scale=1.0)
    php = pdsgd.DSGDParams(*jhp)
    for omega in (0.0, 0.4, 1.0):
        js = jdsgd.lr_scale_from_omega(jnp.float32(omega), 0.0, 1.0, 0.23, 1.0)
        ps = pdsgd.lr_scale_from_omega(torch.tensor(omega), 0.0, 1.0, 0.23, 1.0)
        _close(ps, js)
        _close(pdsgd.dsgd_update(T(flat), T(grad), ps, php),
               jdsgd.dsgd_update(flat, grad, js, jhp))
    zero = np.zeros_like(grad)
    got = pdsgd.dsgd_update(T(flat), T(zero), torch.tensor(1.0), php)
    np.testing.assert_array_equal(got.numpy(), flat)
    np.testing.assert_array_equal(np.asarray(jdsgd.dsgd_update(flat, zero, 1.0, jhp)), flat)


def test_fitness_from_rewards_matches_jax():
    key = jax.random.key(4)
    signs = np.array(jax.random.rademacher(key, (16,), jnp.float32))
    const = np.full(16, 35.0, np.float32)
    got = pcombine.fitness_from_rewards(T(const), torch.tensor(3.5), T(signs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcombine.fitness_from_rewards(
        const, jnp.float32(3.5), key)))
    np.testing.assert_array_equal(got.numpy(), signs)
    rewards = np.random.RandomState(3).randint(-30, 60, 16).astype(np.float32) * 7
    _close(pcombine.fitness_from_rewards(T(rewards), torch.tensor(12.25), T(signs)),
           jcombine.fitness_from_rewards(rewards, jnp.float32(12.25), key))


def test_dense_combine_and_standardize_match_jax():
    rng = np.random.RandomState(5)
    eps = rng.randn(12, 400).astype(np.float32)
    fit = rng.randn(12).astype(np.float32)
    _close(pcombine.combine_gradient(T(eps), T(fit), 0.05),
           jcombine.combine_gradient(eps, fit, 0.05), rtol=1e-5, atol=1e-7)
    _close(pstandardize(T(fit)), jstandardize(fit, xp=jnp))
    _close(pstandardize(torch.full((4,), 2.0)), jstandardize(np.full(4, 2.0), xp=jnp))
    assert paffine(0.5, 0.0, 1.0, 0.23, 1.0) == jaffine(0.5, 0.0, 1.0, 0.23, 1.0)
    assert paffine(0.5, 1.0, 1.0, 0.23, 1.0) == 0.23


# -- ops: distances ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["categorical_tvd", "categorical_bhattacharyya", "l2"])
def test_distances_match_jax(name):
    rng = np.random.RandomState(6)
    p = rng.dirichlet(np.ones(9), size=(3, 1, 8)).astype(np.float32)   # [M, 1, Z, A]
    q = rng.dirichlet(np.ones(9), size=(1, 5, 8)).astype(np.float32)   # [1, H, Z, A]
    pf, jf = pdist.DISTANCES[name], jdist.DISTANCES[name]
    want = np.asarray(jf(jnp.asarray(p), jnp.asarray(q), xp=jnp))
    assert want.shape == (3, 5)
    _close(pf(T(p), T(q), xp=torch), want)
    _close(pf(p[0, 0], q[0]), jf(p[0, 0], q[0]))  # host numpy form


# -- models -----------------------------------------------------------------------------


def test_discrete_mlp_init_is_bit_exact():
    jm, pm = JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU)
    for seed in (0, 123):
        jp, js = jm.init(seed)
        pp, ps = pm.init(seed)
        np.testing.assert_array_equal(pm.get_flat(pp).numpy(), jm.get_flat(jp))
        for bn in js:
            for k in js[bn]:
                np.testing.assert_array_equal(ps[bn][k].numpy(), js[bn][k])


def _population(jm, params_np, M=4, scale=0.5):
    flat = jm.get_flat(params_np)
    rng = np.random.RandomState(7)
    return (flat[None] + scale * rng.randn(M, flat.size)).astype(np.float32)


def test_discrete_mlp_forwards_match_jax():
    jm, pm, params_np, bn_np, _, bn = _model_pair()
    bn_np = {k: dict(v, mean=v["mean"] + 0.1, var=v["var"] * 1.5) for k, v in bn_np.items()}
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    flats = _population(jm, params_np)
    xs = np.random.RandomState(8).rand(10, 2).astype(np.float32)
    jparams = jax.vmap(lambda v: jm.set_flat(v, xp=jnp))(flats)
    pparams = pm.set_flat(T(flats))
    for fn in ("apply", "strategy", "entropy"):
        want = jax.vmap(lambda p: getattr(jm, fn)(p, bn_np, xs))(jparams)
        _close(getattr(pm, fn)(pparams, bn, T(xs)), want, rtol=1e-5)


def test_act_step_reproduces_jax_categorical():
    jm, pm, params_np, bn_np, _, bn = _model_pair()
    flats = _population(jm, params_np, M=6, scale=2.0)
    obs = np.random.RandomState(9).rand(6, 2).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(1), i))(jnp.arange(6))
    det = np.array([False, True] * 3)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (9,), jnp.float32))(keys)

    def one(v, o, k, d):
        a, ent, _ = jm.act_step(jm.set_flat(v, xp=jnp), bn_np, o, 0.0, False, (), k, d)
        return a, ent

    want_a, want_ent = jax.vmap(one)(flats, obs, keys, det)
    # the port steps E episodes a member: E = 1 here
    got_a, got_ent, carry = pm.act_step(pm.set_flat(T(flats)), bn, T(obs)[:, None],
                                        torch.zeros(6, 1), torch.zeros((6, 1), dtype=torch.bool),
                                        (), T(det), T(np.array(gumbel))[:, None])
    assert carry == ()
    np.testing.assert_array_equal(got_a.numpy()[:, 0], np.asarray(want_a))
    _close(got_ent[:, 0], want_ent, rtol=1e-5)


def test_layers_match_jax():
    x = np.random.RandomState(10).randn(3, 5, 9).astype(np.float32) * 4
    from dfd_tpu_torch.models import layers as pl
    _close(pl.softmax(T(x)), jlayers.softmax(x), rtol=1e-6)
    probs = np.array(jlayers.softmax(x))
    probs[0, 0, :3] = 0.0
    _close(pl.categorical_entropy(T(probs)), jlayers.categorical_entropy(probs), rtol=1e-6)


# -- envs -------------------------------------------------------------------------------


def test_trap_env_matches_jax_for_201_steps():
    """JAX's step runs eagerly: under jit XLA rewrites the observation's
    ``x / 1918`` as ``x * (1 / 1918)``, one ulp off for some cells; the port
    divides, as the JAX source says."""
    M = 8
    jenv, penv = JaxTrapEnv(), TrapEnv(device=CPU)
    actions = np.random.RandomState(11).randint(-1, 10, size=(201, M))
    jstate, jobs = jax.vmap(lambda _: jenv.reset(None))(jnp.arange(M))
    pstate, pobs = penv.reset(M)
    jstep = jax.vmap(jenv.step)
    np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs))
    moved = False
    for t in range(201):
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(actions[t], jnp.int32))
        pstate, pobs, prew, pdone = penv.step(pstate, T(actions[t]))
        for a, b in zip(pstate, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(prew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(pdone.numpy(), np.asarray(jdone))
        moved |= bool((prew != 0).any())
    assert moved and bool(pdone.all())


def test_text_map_parses_as_jax_and_the_env_matches(tmp_path):
    """A text map written from the shipped grid, each row ending in the
    reference's "0\\n" token, parses equal to JAX's parse and to the grid;
    ``TrapEnv(map_path=...)`` then steps as JAX's on it."""
    from _torch_port import trap_map_text
    from dfd_tpu.envs.trap import parse_map_text as jparse
    from dfd_tpu_torch.envs.trap import load_walkable_grid, parse_map_text

    grid = load_walkable_grid()
    text = trap_map_text(grid)
    assert text.count("0\n") >= grid.shape[0] - 1
    np.testing.assert_array_equal(parse_map_text(text), jparse(text))
    np.testing.assert_array_equal(parse_map_text(text), grid)
    path = tmp_path / "map.txt"
    path.write_text(text)
    np.testing.assert_array_equal(load_walkable_grid(str(path)), grid)
    M = 4
    jenv, penv = JaxTrapEnv(map_path=str(path)), TrapEnv(map_path=str(path), device=CPU)
    actions = np.random.RandomState(5).randint(0, 9, size=(20, M))
    jstate, _ = jax.vmap(lambda _: jenv.reset(None))(jnp.arange(M))
    pstate, _ = penv.reset(M)
    jstep = jax.vmap(jenv.step)
    for t in range(20):
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(actions[t], jnp.int32))
        pstate, pobs, prew, pdone = penv.step(pstate, T(actions[t]))
        for a, b in zip(pstate, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(prew.numpy(), np.asarray(jrew))


def test_utils_exports_match_jax():
    """``dfd_tpu_torch.utils`` exports the JAX package's nine names, and each
    imports (the six of checkpoint, factory and sweep at first access)."""
    import dfd_tpu.utils as jutils
    import dfd_tpu_torch.utils as putils
    from dfd_tpu_torch.utils import (  # noqa: F401
        get_init_data, get_vectorized_init_data, load_checkpoint, make_jax_env, random_search,
        save_checkpoint)
    from dfd_tpu_torch.utils import checkpoint, factory, sweep

    assert putils.__all__ == jutils.__all__
    for name in putils.__all__:
        assert callable(getattr(putils, name)), name
    assert putils.save_checkpoint is checkpoint.save_checkpoint
    assert putils.get_init_data is factory.get_init_data
    assert putils.random_search is sweep.random_search
    with pytest.raises(AttributeError):
        putils.not_a_name


# -- novelty -------------------------------------------------------------------------


def test_strategy_handler_matches_jax():
    jm, pm, params_np, bn_np, _, bn = _model_pair()
    flats = _population(jm, params_np, M=5, scale=0.5)
    zeta = np.random.RandomState(12).rand(6, 2).astype(np.float32)
    jh = JaxStrategyHandler(jm, bn_np, jdist.categorical_tvd, max_history_size=3)
    ph = StrategyHandler(pm, bn, pdist.categorical_tvd, max_history_size=3)
    for h in (jh, ph):
        for f in flats[:3]:
            h.add_policy(f)
        h.set_zeta(zeta)
    _close(ph.strategy_tensor, jh.strategy_tensor, rtol=1e-5)
    # the archive is full: the next submissions run the replacement rule
    assert [ph.add_policy(f) for f in flats[3:]] == [jh.add_policy(f) for f in flats[3:]]
    _close(ph.strategy_tensor, jh.strategy_tensor, rtol=1e-5)
    for f in flats:
        _close(ph.compute_novelty(f), jh.compute_novelty(f), rtol=1e-5)


def test_compute_novelty_batch_matches_jax_and_the_host_loop():
    """The batched novelty of 7 flats against an archive of 4 equals JAX's
    ``compute_novelty_batch`` and the port's own one-at-a-time
    ``compute_novelty`` within rtol 1e-5; below 2 entries it is zeros."""
    jm, pm, params_np, bn_np, _, bn = _model_pair()
    flats = _population(jm, params_np, M=11, scale=0.4)
    zeta = np.random.RandomState(13).rand(5, 2).astype(np.float32)
    jh = JaxStrategyHandler(jm, bn_np, jdist.categorical_tvd, max_history_size=6)
    ph = StrategyHandler(pm, bn, pdist.categorical_tvd, max_history_size=6)
    ph.add_policy(flats[0])
    ph.set_zeta(zeta)
    assert _np(ph.compute_novelty_batch(T(flats[4:]), zeta)).tolist() == [0.0] * 7
    for h in (jh, ph):
        for f in flats[1 if h is ph else 0:4]:
            h.add_policy(f)
        h.set_zeta(zeta)
    got = _np(ph.compute_novelty_batch(T(flats[4:]), zeta))
    _close(got, np.asarray(jh.compute_novelty_batch(jnp.asarray(flats[4:]), jnp.asarray(zeta))),
           rtol=1e-5)
    _close(got, [ph.compute_novelty(f) for f in flats[4:]], rtol=1e-5)
    assert got.shape == (7,) and (got > 0).all()


def test_act_matches_jax():
    """``PolicyModel.act`` on one observation: the greedy action, and the
    sampled one on JAX's Gumbel draw of its key, for the trap MLP, a
    Gaussian MLP (normals) and a small IMPALA (a fresh episode's carry)."""
    from dfd_tpu.models import GaussianMLP as JaxGaussianMLP
    from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
    from dfd_tpu_torch.models import GaussianMLP, ImpalaPolicy

    rng = np.random.RandomState(14)
    cases = [
        (JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU), (2,), 9, True),
        (JaxGaussianMLP(3, 2), GaussianMLP(3, 2, device=CPU), (3,), 2, False),
        (JaxImpala((3, 16, 16), 5, channels=(8, 8, 8), hidden=16),
         ImpalaPolicy((3, 16, 16), 5, channels=(8, 8, 8), hidden=16, device=CPU), (3, 16, 16),
         5, True),
    ]
    for jm, pm, shape, A, discrete in cases:
        params_np, bn_np = jm.init(2)
        params, bn = params_from_numpy(pm, params_np, bn_np, CPU)
        batched = pm.set_flat(pm.get_flat(params)[None])
        for k in range(4):
            obs = (rng.rand(*shape) * (255 if len(shape) == 3 else 1)).astype(np.float32)
            key = jax.random.key(k)
            draw = (jax.random.gumbel if discrete else jax.random.normal)(key, (A,), jnp.float32)
            for det in (True, False):
                want = np.asarray(jm.act(params_np, bn_np, jnp.asarray(obs), key, det))
                got = _np(pm.act(batched, bn, T(obs), T(np.array(draw)), det))[0]
                if discrete:
                    assert int(got) == int(want), (type(pm).__name__, k, det)
                else:
                    _close(got, want, rtol=1e-5, atol=1e-6)


def test_orthogonal_matches_jax():
    from dfd_tpu.models.init import orthogonal as jorthogonal
    from dfd_tpu_torch.models.init import orthogonal

    for shape, gain in (((6, 4), 1.0), ((3, 7), 0.01), ((5, 5), 2.0)):
        got = orthogonal(shape, gain, np.random.RandomState(3))
        want = jorthogonal(shape, gain, np.random.RandomState(3))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32 and got.shape == shape
        small = got if shape[0] >= shape[1] else got.T
        np.testing.assert_allclose(small.T @ small, gain ** 2 * np.eye(min(shape)), atol=1e-5)


# -- convert, utils ------------------------------------------------------------------


def test_train_state_from_numpy_carries_every_field():
    from dfd_tpu.config import TrainConfig
    from dfd_tpu.runners import VectorizedTrainer as JaxTrainer

    cfg = TrainConfig(batch_size=4, zeta_size=5, noise_backend="pallas")
    jst = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jdist.categorical_tvd, cfg).state
    st = train_state_from_numpy(jax_state_numpy(jst), CPU)
    _close(st.flat, jst.flat)
    _close(st.zeta, jst.zeta)
    for a, b in zip(st.omega, jst.omega):
        _close(a, b)
    for a, b in zip(st.obs_stats, jst.obs_stats):
        _close(a, b)
    assert st.epoch == 0 and st.flat.dtype == torch.float32
    assert st.bn_state["bn2"]["var"].shape == (64,)


def test_params_from_numpy_rejects_a_wrong_tree():
    jm, pm = JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU)
    params_np, bn_np = jm.init(0)
    del params_np["l3"]
    with pytest.raises(ValueError, match="l3"):
        params_from_numpy(pm, params_np, bn_np, CPU)


def test_reporter_and_stage_timer():
    rep = EpochReporter(quiet=True)
    timer = StageTimer()
    with timer.stage("archive"):
        pass
    row = {"Epoch": 1, **timer.report()}
    rep.report(row)
    assert rep.history == [row] and "_stage/archive" in row
    assert timer.report() == {}
