"""The port's rollout and trainer held against the JAX package's, on the CPU.

Both packages consume the same random numbers (see ``tests/_torch_port.py``),
so the trap env's integer-valued rewards must agree exactly and every float
to float32 rounding.  One caveat: a sampled action flips between the two only
if ``log p + g`` of two actions tie within one ulp, about 1e-7 per sample at
these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import episode_draws, jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.trap import TrapEnv as JaxTrapEnv
from dfd_tpu.fd import rollout as jax_rollout
from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from dfd_tpu_torch.envs import TrapEnv
from dfd_tpu_torch.fd import rollout as port_rollout
from dfd_tpu_torch.models import DiscreteMLP
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer, make_draws

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


def _rollout_pair(normalize_obs):
    """The port's and JAX's ``episode_rollout`` for M = 5 members (one
    deterministic) on perturbed weights, with frequent stats samples."""
    M, T, Z = 5, 201, 8
    jm, pm = JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU)
    params_np, bn_np = jm.init(3)
    flat = jm.get_flat(params_np)
    rng = np.random.RandomState(0)
    flats = (flat[None] + 0.3 * rng.randn(M, flat.size)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(11), i))(jnp.arange(M))
    det = np.arange(M) == 2
    mean = np.array([0.4, 0.5], np.float32)
    std = np.array([0.1, 0.2], np.float32)
    env = JaxTrapEnv()

    def one(v, k, d):
        return jax_rollout.episode_rollout(
            jm, env, jm.set_flat(v, xp=jnp), bn_np, k, T, deterministic=d,
            obs_mean=mean, obs_std=std, normalize_obs=normalize_obs,
            obs_stats_update_chance=0.3, collect_states=False, collect_limit=Z,
        )

    want = jax.jit(jax.vmap(one))(flats, keys, det)
    g, u, level = episode_draws(keys, T, 9, TrapEnv(device=CPU))

    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    got = port_rollout.episode_rollout(
        pm, TrapEnv(device=CPU), pm.set_flat(torch.from_numpy(flats)), bn, T,
        torch.from_numpy(det), torch.from_numpy(mean), torch.from_numpy(std),
        normalize_obs=normalize_obs, obs_stats_update_chance=0.3,
        action_noise=torch.from_numpy(g)[:, None], stats_uniform=torch.from_numpy(u)[:, None],
        reset_level=torch.from_numpy(level)[:, None], collect_limit=Z,
    )
    got = got._replace(reward=got.reward[:, 0], entropy=got.entropy[:, 0], steps=got.steps[:, 0],
                       obs_stats=type(got.obs_stats)(*(x[:, 0] for x in got.obs_stats)))
    return got, want


def test_episode_rollout_matches_jax():
    """With obs normalization: the sampled statistics agree too."""
    got, want = _rollout_pair(normalize_obs=True)
    np.testing.assert_array_equal(_np(got.reward), np.asarray(want.reward))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    assert len(set(_np(got.reward).tolist())) > 1  # the members really differ
    np.testing.assert_allclose(_np(got.entropy), np.asarray(want.entropy), rtol=1e-5)
    for a, b in zip(got.obs_stats, want.obs_stats):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(got.states), np.asarray(want.states), rtol=1e-5)


def test_episode_rollout_without_normalization_skips_stats():
    """Without obs normalization the episodes still agree with JAX's, and the
    statistics nobody reads are left empty."""
    got, want = _rollout_pair(normalize_obs=False)
    np.testing.assert_array_equal(_np(got.reward), np.asarray(want.reward))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    np.testing.assert_allclose(_np(got.entropy), np.asarray(want.entropy), rtol=1e-5)
    np.testing.assert_allclose(_np(got.states), np.asarray(want.states), rtol=1e-5)
    assert float(np.asarray(want.obs_stats.count).sum()) > 0
    for x in got.obs_stats:
        assert not x.any()


def _pair(cfg_kw):
    jcfg = JaxTrainConfig(**cfg_kw)
    jtr = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jax_distances.categorical_tvd, jcfg)
    draws = {}
    ptr = VectorizedTrainer(
        DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU), distances.categorical_tvd,
        TrainConfig(**cfg_kw), device=CPU, draw_source=lambda epoch: draws[epoch],
    )
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    return jtr, ptr, draws


BASE = dict(batch_size=16, learning_rate=0.05, noise_std=0.05, zeta_size=8,
            max_strategy_history_size=4, random_seed=5, noise_backend="pallas")


def test_trainer_matches_jax_epoch_by_epoch(monkeypatch):
    """Three epochs of ``train(1)``: the archive fills and novelty turns on."""
    jtr, ptr, draws = _pair(BASE)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0


def test_trainer_matches_jax_normalized_antithetic(monkeypatch):
    jtr, ptr, draws = _pair(dict(BASE, normalize_obs=True, antithetic=True,
                                 obs_stats_update_chance=0.05))
    run_and_compare(jtr, ptr, draws, 2, monkeypatch)
    st = ptr.state.obs_stats
    assert float(st.count) > 2
    for a, b in zip(st, jtr.state.obs_stats):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5)


JAX_BASE = {k: v for k, v in BASE.items() if k != "noise_backend"}  # the default, "jax"


def test_trainer_matches_jax_on_the_jax_noise_backend(monkeypatch):
    """``TrainConfig``'s own default backend: eps is JAX's threefry normal,
    the combine the dense GEMV over it."""
    jtr, ptr, draws = _pair(dict(JAX_BASE, antithetic=True))
    assert ptr.cfg.noise_backend == "jax"
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0


@pytest.mark.parametrize("E", [2, 3])
def test_trainer_matches_jax_with_episodes_per_member(E, monkeypatch):
    """E episodes a member (member i's episode j under split(key_i, E)[j]),
    averaged; the eval slot repeats its key and reads episode 0."""
    jtr, ptr, draws = _pair(dict(JAX_BASE, envs_per_perturbation=E, normalize_obs=True,
                                 obs_stats_update_chance=0.05))
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    for a, b in zip(ptr.state.obs_stats, jtr.state.obs_stats):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("chunk", [8, 4])
def test_trainer_matches_jax_chunked(chunk, monkeypatch):
    """population_chunk = P/2 and P/4 against JAX's chunked trainer: the eval
    slot rides chunk 0, the combine regenerates eps chunk by chunk."""
    jtr, ptr, draws = _pair(dict(JAX_BASE, population_chunk=chunk, envs_per_perturbation=2))
    assert ptr.chunk == chunk
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)


@pytest.mark.parametrize("eval_every", [1, 2])
def test_trainer_matches_jax_with_the_unfused_eval_episode(eval_every, monkeypatch):
    """zeta_size = 0: the eval episode is a separate deterministic rollout,
    run only on eval epochs."""
    jtr, ptr, draws = _pair(dict(JAX_BASE, zeta_size=0, eval_every=eval_every))
    assert ptr.state.zeta.shape == (0, 2)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    # the EMA moves only on eval epochs (run_and_compare counts the eval rollouts)
    reward = [r["Policy Reward"] for r in ptr.reporter.history]
    assert (reward[1] == reward[0]) == (eval_every == 2) and reward[2] != reward[1]


def test_chunked_port_matches_unchunked_port():
    """The same draws through P = 16 at once and in chunks of 4: equal
    rewards every epoch, and flat within 1e-5."""
    gen = torch.Generator().manual_seed(7)
    epoch_draws = [make_draws(gen, 16, 201, 8, TrapEnv(device=CPU), 2)
                   for _ in range(3)]
    trainers = [VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                                  distances.categorical_tvd,
                                  TrainConfig(**dict(JAX_BASE, envs_per_perturbation=2,
                                                     population_chunk=c)),
                                  device=CPU, draw_source=lambda e: epoch_draws[e])
                for c in (None, 4)]
    for tr in trainers:
        tr.train(3)
    whole, chunked = trainers
    for a, b in zip(whole.reporter.history, chunked.reporter.history):
        assert a["Noisy Reward"] == b["Noisy Reward"] and a["Policy Reward"] == b["Policy Reward"]
    np.testing.assert_allclose(_np(chunked.state.flat), _np(whole.state.flat), rtol=1e-5,
                               atol=1e-6)


def test_trainer_on_a_mesh_of_one_matches_jax(monkeypatch):
    """``mesh=`` a mesh of one (no process group): the trainer holds all P
    members and runs as without a mesh, epoch by epoch against JAX's."""
    from dfd_tpu_torch.parallel import make_pop_mesh

    jtr, _, draws = _pair(BASE)
    ptr = VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                            distances.categorical_tvd, TrainConfig(**BASE),
                            mesh=make_pop_mesh(CPU), device=CPU,
                            draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    assert ptr.members == range(16) and ptr.mesh.size == 1
    run_and_compare(jtr, ptr, draws, 2, monkeypatch)


@pytest.mark.parametrize(
    "kw, what",
    [
        (dict(population_chunk=5), "population_chunk must divide batch_size"),
        (dict(population_chunk=8, noise_backend="pallas"), "needs noise_backend='jax'"),
        (dict(noise_backend="numpy"), "noise_backend must be"),
        (dict(envs_per_perturbation=0), "envs_per_perturbation must be >= 1"),
    ],
)
def test_config_errors_raise(kw, what):
    cfg = TrainConfig(**dict(JAX_BASE, **kw))
    with pytest.raises(ValueError, match=what):
        VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                          distances.categorical_tvd, cfg, device=CPU)


def test_trainer_own_draws_learn_and_chunk():
    """Without injected draws the trainer draws from its own generator; the
    chunked throughput mode counts every timestep."""
    cfg = TrainConfig(**BASE)
    tr = VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                           distances.categorical_tvd, cfg, device=CPU)
    tr.train_to_timesteps(5 * 17 * 201, sync_every=3)
    h = tr.reporter.history
    assert [r["Epoch"] for r in h] == list(range(1, 7))
    assert tr.cumulative_timesteps == 6 * 17 * 201
    assert all(np.isfinite(r["Update Magnitude"]) and r["Update Magnitude"] > 0 for r in h)
    assert len(tr.handler.archive) == 3  # initial + one per chunk


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiscreteMLP(2, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrapEnv()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                          distances.categorical_tvd, TrainConfig(**BASE))


@pytest.mark.parametrize("entry", ["train", "train_fast", "train_to_timesteps"])
def test_entry_points_take_full_f32_products_and_restore_the_caller(entry):
    """Under a caller's ``set_float32_matmul_precision("high")`` (TF32 on
    for products and cuDNN), each public entry point runs its epochs with
    both TF32 flags off and hands the caller's settings back."""
    cfg = TrainConfig(**BASE)
    tr = VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                           distances.categorical_tvd, cfg, device=CPU)
    seen = []
    inner = tr._epoch_step

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return inner(*args)

    tr._epoch_step = spy
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        {"train": lambda: tr.train(2), "train_fast": lambda: tr.train_fast(2, sync_every=1),
         "train_to_timesteps": lambda: tr.train_to_timesteps(17 * 201, sync_every=1)}[entry]()
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert len(seen) >= 1 and all(s == (False, False, "highest") for s in seen)
    assert after == (True, True, "high")


@pytest.mark.parametrize(
    "kw, refused",
    [
        (dict(e_lowering="bogus"), True),
        (dict(e_lowering="bogus", envs_per_perturbation=1), False),
        (dict(e_lowering="bogus", population_chunk=2), False),
        (dict(e_lowering="bogus", zeta_size=0), False),
        (dict(e_lowering="flat"), False),
        (dict(e_lowering="nested"), False),
        (dict(e_lowering="auto"), False),
    ],
    ids=["bogus", "bogus-E1", "bogus-chunked", "bogus-no-zeta", "flat", "nested", "auto"],
)
def test_e_lowering_is_checked_as_jax_checks_it(kw, refused):
    """Both packages refuse an unknown ``e_lowering`` with the same message
    exactly where JAX reads the field (E > 1, unchunked, with a zeta), and
    accept flat, nested and auto (JAX's auto times both lowerings: a 5-step
    episode keeps that short)."""
    kw = dict(dict(batch_size=4, zeta_size=4, max_strategy_history_size=4, episode_length=5,
                   envs_per_perturbation=2), **kw)
    makers = (
        lambda: JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jax_distances.categorical_tvd,
                           JaxTrainConfig(**kw)),
        lambda: VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                                  distances.categorical_tvd, TrainConfig(**kw), device=CPU),
    )
    for make in makers:
        if refused:
            with pytest.raises(ValueError, match=r"e_lowering must be flat\|nested\|auto, "
                                                 r"got 'bogus'"):
                make()
        else:
            make()
