"""The port's continuous-control path held against the JAX package's, on the CPU.

``PendulumEnv`` and ``CartPoleEnv`` (resets bit for bit, 200 steps),
``GaussianMLP`` (init, forward, entropy, strategy), the Gaussian distances
with both ``xp``, and the trainer's continuous action path: 3 epochs on
JAX's own draws on the pendulum and the swimmer, both noise backends, the
swimmer's ``eval_panel``, a Gaussian checkpoint's resume, ``set_env`` and
``bench.py``'s ``gaussian_swimmer`` config.

Tolerances.  Resets and step counts are exact.  CartPole's 200 steps hold
each step's observation to 4 ulps of its size from JAX's state (its
dynamics are a few float32 ops, XLA contracts some into fused
multiply-adds), its rewards and ``done`` exact; the trainer on CartPole
(``DiscreteMLP``) takes JAX's actions, so its rewards are exact and only
its zeta carries the observations' ulps.  The pendulum's float32 state drifts from JAX's by ulps a step (XLA's fused
multiply-adds): 200 steps within 1e-4 of the state's size.  Model forwards
(three matrix products summed in another order, XLA's tanh and log against
PyTorch's) within rtol 1e-5; the distances within rtol 1e-6.  The trainer's
rewards are float sums over T steps, held to ``REWARD_RTOL`` of the largest
|reward|: the swimmer's steps differ from JAX's by its float32 conditioning
(``tests/test_torch_swimmer.py``), the pendulum's by ulps; ``flat`` after 3
epochs within rtol ``FLAT_RTOL`` (the rewards' deviation passes through the
standardized fitness into the update).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_port import jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.cartpole import CartPoleEnv as JaxCartPoleEnv
from dfd_tpu.envs.pendulum import PendulumEnv as JaxPendulumEnv
from dfd_tpu.envs.swimmer import SwimmerEnv as JaxSwimmerEnv
from dfd_tpu.models import GaussianMLP as JaxGaussianMLP
from dfd_tpu.ops import distances as jdist
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from dfd_tpu_torch.envs import CartPoleEnv, PendulumEnv, SwimmerEnv
from dfd_tpu_torch.models import GaussianMLP
from dfd_tpu_torch.ops import distances as pdist
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils import checkpoint

CPU = "cpu"
REWARD_RTOL = 1e-4
FLAT_RTOL = 1e-4
# beside rtol 1e-4: the mean rewards (member rewards O(0.1-1) within REWARD_RTOL, their mean
# near 0 on the swimmer) and the novelties (distances of ~5e-5 between near strategies)
METRIC_ATOL = {"Policy Reward": 1e-5, "Noisy Reward": 1e-5, "Policy Novelty": 1e-7,
               "Noisy Novelty": 1e-7}


def _np(t):
    return t.detach().cpu().numpy()


def _keys(seed, n):
    keys = jax.random.split(jax.random.key(seed), n)
    return keys, np.asarray(jax.random.key_data(keys))


# -- the classic envs ----------------------------------------------------------------


@pytest.mark.parametrize("make", [(JaxPendulumEnv, PendulumEnv), (JaxCartPoleEnv, CartPoleEnv)],
                         ids=["pendulum", "cartpole"])
def test_reset_is_bit_exact(make):
    """``reset_draw`` reproduces JAX's uniforms: the start states of 64 keys
    equal JAX's bit for bit; the first observations too, up to the
    pendulum's cos and sin (XLA's against PyTorch's: an ulp)."""
    jenv, env = make[0](), make[1](device=CPU)
    keys, words = _keys(1, 64)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    draw = env.reset_draw(words)
    assert draw.shape == (64,) + env.reset_shape and draw.dtype == np.float32
    state, obs = env.reset(64, torch.from_numpy(draw))
    for name in state._fields:
        np.testing.assert_array_equal(_np(getattr(state, name)),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    np.testing.assert_allclose(_np(obs), np.asarray(jobs), rtol=0, atol=2 ** -23)


def _teacher_forced(jenv, env, seed, actions):
    """200 steps of 64 episodes, each step the port's from JAX's own state:
    the largest deviation of the observations and the rewards a step, with
    ``done`` and the step count exact; then the same 200 steps free-running,
    the deviation after 10, 50, 100 and 200 steps."""
    keys, words = _keys(seed, 64)
    jstate, _ = jax.jit(jax.vmap(jenv.reset))(keys)
    state, _ = env.reset(64, torch.from_numpy(env.reset_draw(words)))
    jstep = jax.jit(jax.vmap(jenv.step))
    step_dev, free, free_dev = 0.0, state, {}
    for t in range(200):
        forced = type(state)(*(torch.from_numpy(np.array(x)) for x in jstate))
        forced = forced._replace(t=forced.t.to(torch.int64))
        jstate, jobs, jr, jd = jstep(jstate, jnp.asarray(actions[t]))
        _, obs, r, d = env.step(forced, torch.from_numpy(actions[t]))
        free, fobs, fr, _ = env.step(free, torch.from_numpy(actions[t]))
        step_dev = max(step_dev, float(np.abs(_np(obs) - np.asarray(jobs)).max()),
                       float(np.abs(_np(r) - np.asarray(jr)).max()))
        np.testing.assert_array_equal(_np(d), np.asarray(jd), err_msg=f"step {t}")
        if t + 1 in (10, 50, 100, 200):
            free_dev[t + 1] = max(float(np.abs(_np(fobs) - np.asarray(jobs)).max()),
                                  float(np.abs(_np(fr) - np.asarray(jr)).max()))
    np.testing.assert_array_equal(_np(free.t), np.asarray(jstate.t))
    return step_dev, free_dev


def test_pendulum_matches_jax_for_200_steps():
    """64 episodes under random torques past the clip.  From JAX's state,
    each step's observation and reward within 4 ulps of 16 (XLA contracts
    its products into fused multiply-adds, and its sin and cos are its own),
    ``done`` exact.  Free-running, the pendulum's chaos grows that seed:
    measured 9.5e-7 after 10 steps, 9.3e-5 after 50, 3.4e-4 after 100 and
    3.4e-2 after 200; held to 1e-5, 1e-3 and 1e-2 through step 100."""
    actions = np.random.RandomState(0).uniform(-1.5, 1.5, (200, 64, 1)).astype(np.float32)
    step_dev, free_dev = _teacher_forced(JaxPendulumEnv(), PendulumEnv(device=CPU), 2, actions)
    assert step_dev <= 4 * 16 * 2 ** -23, step_dev
    assert free_dev[10] <= 1e-5 and free_dev[50] <= 1e-3 and free_dev[100] <= 1e-2, free_dev


def test_cartpole_matches_jax_for_200_steps():
    """64 episodes under random pushes, stepped past done as a rollout
    freezes them.  From JAX's state, each step's observation within 4 ulps
    of its size, rewards and ``done`` exact.  Free-running the deviation
    grows as the poles fall: measured 2.4e-7 after 10 steps, 3.7e-6 after
    50, 4.1e-5 after 100, 7.4e-4 after 200; held to 1e-5 through step 50
    and 1e-2 at 200."""
    actions = np.random.RandomState(1).randint(0, 2, (200, 64))
    step_dev, free_dev = _teacher_forced(JaxCartPoleEnv(), CartPoleEnv(device=CPU), 3, actions)
    assert step_dev <= 4 * 2 ** -23 * 64, step_dev
    assert free_dev[50] <= 1e-5 and free_dev[200] <= 1e-2, free_dev


# -- GaussianMLP --------------------------------------------------------------------


def test_gaussian_mlp_matches_jax():
    """The initial flat equals JAX's (numpy normc); carried across by
    ``params_from_numpy``, the population forward, entropy and strategy
    agree within rtol 1e-5 for 3 perturbed members."""
    jm, pm = JaxGaussianMLP(16, 6), GaussianMLP(16, 6, device=CPU)
    assert pm.param_spec.entries == jm.param_spec.entries and pm.num_params == 6028
    params_np, state_np = jm.init(7)
    params, state = params_from_numpy(pm, params_np, state_np, CPU)
    flat = jm.get_flat(params_np)
    np.testing.assert_array_equal(_np(pm.get_flat(params)), flat)
    np.testing.assert_array_equal(_np(pm.get_flat(pm.init(7)[0])), flat)
    rng = np.random.RandomState(0)
    flats = (flat[None] + 0.3 * rng.randn(3, flat.size)).astype(np.float32)
    xs = rng.randn(5, 16).astype(np.float32)
    pop = pm.set_flat(torch.from_numpy(flats))
    mean, std = pm.apply(pop, state, torch.from_numpy(xs))
    ent, strat = pm.entropy(pop, state, torch.from_numpy(xs)), pm.strategy(pop, state,
                                                                            torch.from_numpy(xs))
    for i in range(3):
        jp = jm.set_flat(flats[i])
        jmean, jstd = jax.jit(lambda x: jm.apply(jp, {}, x))(xs)
        np.testing.assert_allclose(_np(mean[i]), np.asarray(jmean), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(std[i]), np.asarray(jstd), rtol=1e-5)
        np.testing.assert_allclose(float(ent[i]), float(jm.entropy(jp, {}, xs)), rtol=1e-5)
        np.testing.assert_allclose(_np(strat[i]), np.asarray(jm.strategy(jp, {}, xs)), rtol=1e-5,
                                   atol=1e-6)
    assert strat.shape == (3, 5, 12) and (std >= 0.1).all() and (std <= 1.0).all()


def test_gaussian_act_step_matches_jax():
    """The action ``mean + std * noise`` on JAX's ``normal(key, (A,))`` draw,
    or the mean where deterministic, and the entropy summed over the
    action's dimensions, for 4 members x 2 episodes."""
    jm, pm = JaxGaussianMLP(3, 2), GaussianMLP(3, 2, device=CPU)
    params_np, _ = jm.init(2)
    flat = jm.get_flat(params_np)
    rng = np.random.RandomState(3)
    flats = (flat[None] + 0.5 * rng.randn(4, flat.size)).astype(np.float32)
    obs = rng.randn(4, 2, 3).astype(np.float32)
    det = np.array([False, True, False, False])
    keys = jax.random.split(jax.random.key(9), 8).reshape(4, 2)
    noise = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (2,))))(keys))
    zeros = torch.zeros((4, 2))
    action, ent, _ = pm.act_step(pm.set_flat(torch.from_numpy(flats)), {}, torch.from_numpy(obs),
                                 zeros, zeros.bool(), (), torch.from_numpy(det),
                                 torch.from_numpy(noise))
    for i in range(4):
        for e in range(2):
            ja, je, _ = jm.act_step(jm.set_flat(flats[i]), {}, obs[i, e], 0.0, False, (),
                                    keys[i, e], det[i])
            np.testing.assert_allclose(_np(action[i, e]), np.asarray(ja), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(ent[i, e]), float(je), rtol=1e-5)
    m, _ = pm.apply(pm.set_flat(torch.from_numpy(flats)), {}, torch.from_numpy(obs))
    assert torch.equal(action[1], m[1])


# -- the distances -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["gaussian_bhattacharyya", "gaussian_wasserstein"])
def test_gaussian_distances_match_jax(name):
    """Each ``DISTANCES`` entry over a population x archive broadcast, as
    numpy (float64, the host archive) and as torch (float32), against the
    JAX package's with ``xp=np`` and ``xp=jnp``; strategy_novelty and
    strategy_distance on top."""
    rng = np.random.RandomState(5)
    A = 3
    strat = lambda *lead: np.concatenate(
        [rng.uniform(-1, 1, lead + (6, A)), rng.uniform(0.1, 1.0, lead + (6, A))], -1)
    a, b = strat(4, 1), strat(1, 5)
    jf, pf = jdist.DISTANCES[name], pdist.DISTANCES[name]
    np.testing.assert_allclose(pf(a, b, xp=np), jf(a, b, xp=np), rtol=1e-12)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    got = pf(torch.from_numpy(a32), torch.from_numpy(b32), xp=torch)
    assert got.shape == (4, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jax.jit(lambda x, y: jf(x, y, xp=jnp))(
        a32, b32)), rtol=1e-6)
    one, arch = a[0, 0], b[0]
    assert pdist.strategy_novelty(one, arch, pf) == jdist.strategy_novelty(one, arch, jf)
    m, d = pdist.strategy_novelty(torch.from_numpy(one), torch.from_numpy(arch), pf, xp=torch,
                                  return_all=True)
    np.testing.assert_allclose(float(m), jdist.strategy_novelty(one, arch, jf), rtol=1e-12)
    assert d.shape == (5,)
    assert pdist.strategy_distance(one, arch[2], pf) == jdist.strategy_distance(one, arch[2], jf)
    w = pdist.gaussian_wasserstein(*(torch.from_numpy(x) for x in (a[..., :A], a[..., A:],
                                                                   b[..., :A], b[..., A:])),
                                   xp=torch)
    np.testing.assert_allclose(_np(w), jdist.gaussian_wasserstein(
        a[..., :A], a[..., A:], b[..., :A], b[..., A:]), rtol=1e-12)


# -- the trainer --------------------------------------------------------------------


def _pair(jenv, penv, n_inputs, A, kw):
    jtr = JaxTrainer(JaxGaussianMLP(n_inputs, A), jenv, jdist.gaussian_wasserstein_from_strategies,
                     JaxTrainConfig(**kw))
    draws = {}
    ptr = VectorizedTrainer(GaussianMLP(n_inputs, A, device=CPU), penv,
                            pdist.gaussian_wasserstein_from_strategies, TrainConfig(**kw),
                            device=CPU, draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    return jtr, ptr, draws


SMALL = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
             max_strategy_history_size=4, random_seed=5, normalize_obs=True,
             obs_stats_update_chance=0.2)


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("env_name", ["pendulum", "swimmer"])
def test_gaussian_trainer_matches_jax(env_name, backend, monkeypatch):
    """3 epochs of ``train(1)`` on JAX's draws (Gaussian action noise, float
    resets, normalized observations, the 2A-wide archive filling so novelty
    turns on): per-member rewards within ``REWARD_RTOL``, ``flat`` within
    ``FLAT_RTOL``, the metrics within rtol 1e-4 (``METRIC_ATOL`` beside it:
    the mean rewards, near 0 on the swimmer, and the novelties, small
    distances between near strategies; the Gaussian entropy, summed over
    XLA's log, within 1e-5), the observation statistics within 1e-5 and
    ``REWARD_RTOL`` of their largest."""
    if env_name == "pendulum":
        jenv, penv, n_in, A = JaxPendulumEnv(), PendulumEnv(device=CPU), 3, 1
        kw = dict(SMALL, episode_length=25)
    else:
        jenv, penv = JaxSwimmerEnv(max_steps=20), SwimmerEnv(max_steps=20, device=CPU)
        n_in, A, kw = 16, 6, SMALL
    jtr, ptr, draws = _pair(jenv, penv, n_in, A, dict(kw, noise_backend=backend))
    assert ptr.horizon <= 25
    metrics = ("Policy Reward", "Noisy Reward", "Noisy Novelty", "Policy Novelty",
               "Update Magnitude", "Omega")
    run_and_compare(jtr, ptr, draws, 3, monkeypatch, loose=metrics, loose_rtol=1e-4,
                    loose_atol=METRIC_ATOL, reward_rtol=REWARD_RTOL, flat_rtol=FLAT_RTOL)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0
    assert ptr._archive_inputs()[0].shape == (4, 4, 2 * A)
    for a, b in zip(ptr.state.obs_stats, jtr.state.obs_stats):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=REWARD_RTOL * max(1.0, float(np.abs(b).max())))
    assert float(ptr.state.obs_stats.count) > 10


def test_cartpole_trainer_matches_jax(monkeypatch):
    """CartPole-v1 with ``DiscreteMLP(4, 2)`` on the vectorized trainer, P =
    8, T = 60, 3 epochs on JAX's draws: rewards equal (integer step counts:
    ``REWARD_RTOL`` of the largest is below one step), ``flat`` within rtol
    1e-5, and zeta, the visited observations, within the continuous envs'
    ``REWARD_RTOL`` of its largest (measured 8.4e-10 absolute)."""
    from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
    from dfd_tpu_torch.models import DiscreteMLP

    kw = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
              max_strategy_history_size=4, random_seed=5, episode_length=60)
    jtr = JaxTrainer(JaxDiscreteMLP(4, 2), JaxCartPoleEnv(), jdist.categorical_tvd,
                     JaxTrainConfig(**kw))
    draws = {}
    ptr = VectorizedTrainer(DiscreteMLP(4, 2, device=CPU), CartPoleEnv(device=CPU),
                            pdist.categorical_tvd, TrainConfig(**kw), device=CPU,
                            draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    assert ptr.horizon == 60
    run_and_compare(jtr, ptr, draws, 3, monkeypatch, reward_rtol=REWARD_RTOL)
    assert len({r["Noisy Reward"] for r in ptr.reporter.history}) > 1


def test_eval_panel_on_swimmer_matches_jax(monkeypatch):
    """After 2 epochs on JAX's draws, the swimmer's panel of 12 greedy
    episodes (JAX's resets under fold_in(key(panel_seed), i)) within
    ``REWARD_RTOL`` of JAX's panel; read-only and repeatable."""
    jtr, ptr, draws = _pair(JaxSwimmerEnv(max_steps=15), SwimmerEnv(max_steps=15, device=CPU),
                            16, 6, SMALL)
    run_and_compare(jtr, ptr, draws, 2, monkeypatch, loose=("Noisy Novelty",
                    "Policy Novelty", "Update Magnitude", "Policy Reward", "Noisy Reward",
                    "Omega"), loose_rtol=1e-4, loose_atol=METRIC_ATOL, reward_rtol=REWARD_RTOL,
                    flat_rtol=FLAT_RTOL)
    monkeypatch.undo()
    want = jtr.eval_panel(12, panel_seed=5)
    flat, gen = ptr.state.flat.clone(), ptr.generator.get_state()
    got = ptr.eval_panel(12, panel_seed=5)
    assert got.shape == (12,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=REWARD_RTOL * np.abs(want).max())
    assert len(set(got.tolist())) > 1
    assert torch.equal(flat, ptr.state.flat) and torch.equal(gen, ptr.generator.get_state())
    np.testing.assert_array_equal(ptr.eval_panel(12, panel_seed=5), got)


def _swimmer_trainer(**kw):
    cfg = TrainConfig(**dict(SMALL, episode_length=10, **kw))
    return VectorizedTrainer(GaussianMLP(16, 6, device=CPU), SwimmerEnv(device=CPU),
                             pdist.gaussian_wasserstein_from_strategies, cfg, device=CPU)


def test_gaussian_checkpoint_resumes_bit_for_bit(tmp_path):
    """Train 2 epochs, save, train 2 more; a fresh trainer loads the file
    (its 2A-wide archive rebuilt on load) and trains the same 2: flat, the
    observation statistics, zeta, the archive's strategies and the
    generator equal bit for bit (novelty aside, as in
    tests/test_torch_checkpoint.py)."""
    path = str(tmp_path / "swimmer.npz")
    unbroken = _swimmer_trainer()
    unbroken.train(2)
    checkpoint.save_checkpoint(path, unbroken)
    unbroken.train(2)
    resumed = _swimmer_trainer()
    checkpoint.load_checkpoint(path, resumed)
    assert resumed.handler.strategy_tensor.shape[1:] == (4, 12)
    resumed.train(2)
    a, b = unbroken.state, resumed.state
    assert torch.equal(a.flat, b.flat) and torch.equal(a.zeta, b.zeta) and a.epoch == b.epoch
    assert all(torch.equal(x, y) for x, y in zip(a.obs_stats, b.obs_stats))
    np.testing.assert_array_equal(unbroken.handler.strategy_tensor, resumed.handler.strategy_tensor)
    assert torch.equal(unbroken.generator.get_state(), resumed.generator.get_state())
    assert unbroken.cumulative_timesteps == resumed.cumulative_timesteps


def test_set_env_refuses_another_action_dim():
    """A continuous env swaps for one of the same ``action_dim`` and
    observation shape; another ``action_dim`` or a discrete env is refused."""
    tr = _swimmer_trainer()
    tr.set_env(SwimmerEnv(max_steps=50, device=CPU))
    assert tr.horizon == 10  # episode_length holds
    with pytest.raises(ValueError, match="obs_shape mismatch"):
        tr.set_env(SwimmerEnv(n_links=5, device=CPU))

    wide = SwimmerEnv(device=CPU)
    wide.action_dim = 7
    with pytest.raises(ValueError, match="action space mismatch"):
        tr.set_env(wide)
    cart = CartPoleEnv(device=CPU)
    cart.obs_shape = (16,)
    with pytest.raises(ValueError, match="action space mismatch"):
        tr.set_env(cart)


def test_own_draws_and_seed_buffer_are_continuous():
    """Without injected draws: Gaussian action noise [P+1, E, T, A], float
    resets in [-0.1, 0.1), a zeta of observations from uniform actions in
    [-1, 1); train_fast runs and every metric is finite."""
    tr = _swimmer_trainer(envs_per_perturbation=2)
    d = tr._own_draws(0)
    assert d.action_noise.shape == (9, 2, 10, 6) and d.reset_level.dtype == torch.float32
    assert d.reset_level.shape == (9, 2, 16) and d.reset_level.abs().max() <= 0.1
    assert d.action_noise.std() > 0.5 and torch.equal(d.action_noise[8, 1], d.action_noise[8, 0])
    assert tr.state.zeta.shape == (4, 16) and tr.state.zeta.abs().sum() > 0
    tr.train_fast(2, sync_every=2)
    assert all(np.isfinite(v) for r in tr.reporter.history for v in r.values()
               if isinstance(v, float))


def test_bench_gaussian_swimmer_config_trains_on_the_cpu():
    """``bench.py``'s ``gaussian_swimmer`` cell as it stands (GaussianMLP(16,
    6), SwimmerEnv(max_steps=100), the Wasserstein distance, P = 512,
    T = 100, zeta 16, archive 8, normalize_obs) constructs and trains an
    epoch on the CPU."""
    cfg = TrainConfig(batch_size=512, zeta_size=16, max_strategy_history_size=8,
                      episode_length=100, random_seed=0, normalize_obs=True)
    tr = VectorizedTrainer(GaussianMLP(16, 6, device=CPU), SwimmerEnv(max_steps=100, device=CPU),
                           pdist.gaussian_wasserstein_from_strategies, cfg, device=CPU)
    assert (tr.model.num_params, tr.horizon, tr.P) == (6028, 100, 512)
    tr.train(1)
    row = tr.reporter.history[-1]
    assert tr.cumulative_timesteps == 513 * 100 and row["Update Magnitude"] > 0
    assert np.isfinite(row["Noisy Reward"]) and float(tr.state.obs_stats.count) > 0
    # on a mesh of one (no process group) the continuous path runs as without one
    from dfd_tpu_torch.parallel import make_pop_mesh

    small = cfg.replace(batch_size=16, episode_length=10)
    runs = [VectorizedTrainer(GaussianMLP(16, 6, device=CPU), SwimmerEnv(max_steps=10, device=CPU),
                              pdist.gaussian_wasserstein_from_strategies, small, mesh=mesh,
                              device=CPU) for mesh in (None, make_pop_mesh(CPU))]
    for r in runs:
        r.train(2)
    assert torch.equal(runs[0].state.flat, runs[1].state.flat)
    assert all(torch.equal(a, b) for a, b in zip(runs[0].state.obs_stats, runs[1].state.obs_stats))
