"""The port's VBN refresh held against the JAX package's, on the CPU:
``layers.batchnorm_train``, each model's ``vbn`` alone, and the trainer with
``vbn_buffer_size > 0``, whose ``bn_state`` changes every epoch.

Tolerances.  The refreshed statistics are means over up to N * H * W
positions, summed in another order than XLA's: rtol 1e-5, with an atol of
1e-5 of each vector's largest magnitude for elements near 0
(``assert_bn_close``); ``n`` counts exactly.  The trainers then follow
``run_and_compare``'s contract (rewards exact, ``flat`` and the metrics
within 1e-5), with ``bn_state`` checked every epoch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_bn_close, jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu.envs.trap import TrapEnv as JaxTrapEnv
from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
from dfd_tpu.models import layers as jlayers
from dfd_tpu.models.atari import AtariCNN as JaxAtariCNN
from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy, vbn_buffer_from_numpy
from dfd_tpu_torch.envs import ProcMazeEnv, TrapEnv
from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, ImpalaPolicy
from dfd_tpu_torch.models import layers as players
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.ops import fused_resblock
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
T = torch.from_numpy


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_state(bn_np, seed):
    """Running statistics away from (0, 1) and a count of 3."""
    rng = np.random.RandomState(seed)
    return {k: dict(mean=(rng.randn(*v["mean"].shape) * 0.1).astype(np.float32),
                    var=(rng.rand(*v["var"].shape) + 0.5).astype(np.float32),
                    n=np.float32(3))
            for k, v in bn_np.items()}


@pytest.mark.parametrize("n", [1, 2, 300])
def test_batchnorm_train_matches_jax(n):
    """Batch statistics (biased variance as the mean of squared deviations),
    the momentum fold with the unbiased factor n / max(n - 1, 1), n + 1."""
    rng = np.random.RandomState(n)
    x = (rng.randn(n, 6) * 3 + 1).astype(np.float32)
    p = {"w": rng.rand(6).astype(np.float32) + 0.5, "b": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.1,
         "n": np.float32(4)}
    want_y, want_s = jlayers.batchnorm_train(p, s, x)
    got_y, got_s = players.batchnorm_train({k: T(v)[None] for k, v in p.items()},
                                           {k: torch.as_tensor(v) for k, v in s.items()},
                                           T(x)[None])
    assert players.BN_MOMENTUM == jlayers.BN_MOMENTUM
    np.testing.assert_allclose(_np(got_y[0]), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    assert_bn_close({"bn": got_s}, {"bn": want_s})


def test_batchnorm_train_takes_one_member():
    x = torch.zeros(2, 3, 4)
    p = {"w": torch.ones(2, 4), "b": torch.zeros(2, 4)}
    s = {"mean": torch.zeros(4), "var": torch.ones(4), "n": torch.zeros(())}
    with pytest.raises(ValueError, match=r"\[1, N, d\]"):
        players.batchnorm_train(p, s, x)


def test_discrete_mlp_vbn_matches_jax():
    """Every block's BN in train mode, no ReLU after the last linear; the
    buffer read as rows of the input width."""
    jm, pm = JaxDiscreteMLP(2, 9), DiscreteMLP(2, 9, device=CPU)
    params_np, bn_np = jm.init(4)
    bn_np = _random_state(bn_np, 4)
    flat = (jm.get_flat(params_np) + 0.1 * np.random.RandomState(5).randn(jm.num_params)
            ).astype(np.float32)
    buffer = np.random.RandomState(6).rand(50, 2).astype(np.float32)
    want = jm.vbn(jm.set_flat(flat), bn_np, buffer)
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    got = pm.vbn(pm.set_flat(T(flat)[None]), bn, T(buffer))
    assert_bn_close(got, want)


FRAME = (3, 32, 32)
SMALL = dict(channels=(8, 16, 16), hidden=32)


def _impala_pair(impl, bf16, use_lstm=True):
    jm = JaxImpala(FRAME, 5, conv_impl=impl, compute_dtype=jnp.bfloat16 if bf16 else None,
                   use_lstm=use_lstm, **SMALL)
    pm = ImpalaPolicy(FRAME, 5, conv_impl=impl, compute_dtype=torch.bfloat16 if bf16 else None,
                      use_lstm=use_lstm, device=CPU, **SMALL)
    params_np, bn_np = jm.init(3)
    bn_np = _random_state(bn_np, 3)
    flat = (jm.get_flat(params_np) + 0.05 * np.random.RandomState(1).randn(jm.num_params)
            ).astype(np.float32)
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    return jm, pm, bn_np, bn, flat


@pytest.mark.parametrize("impl", ["patches", "fused_feat"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_impala_vbn_matches_jax(impl, bf16, monkeypatch):
    """One train-mode forward over 12 frames refreshes every BN, the LSTM
    reading the buffer as one sequence with its arrival rewards.  The convs
    are the float32 patches conv under every conv_impl and neither they nor
    fc round to compute_dtype, so the bf16 model's refresh is the float32
    one, held at the float32 tolerance; no fused kernel runs."""
    jm, pm, bn_np, bn, flat = _impala_pair(impl, bf16)
    rng = np.random.RandomState(7)
    buffer = (rng.rand(12, *FRAME) * 255).astype(np.float32)
    rewards = (rng.randn(12) * 2).astype(np.float32)  # clipped to [-1, 1] in the core
    want = jm.vbn(jm.set_flat(flat), bn_np, buffer, rewards=rewards)

    def refuse(*a, **k):
        raise AssertionError("a fused kernel ran in the VBN refresh")

    monkeypatch.setattr(fused_resblock, "fused_res_stage", refuse)
    monkeypatch.setattr(fused_resblock, "fused_feat_pool", refuse)
    got = pm.vbn(pm.set_flat(T(flat)[None]), bn, T(buffer), rewards=T(rewards))
    assert_bn_close(got, want)
    if not bf16 and impl == "patches":  # the bf16 refresh is the f32 one, bit for bit
        jm16, pm16, _, _, _ = _impala_pair(impl, True)
        again = pm16.vbn(pm16.set_flat(T(flat)[None]), bn, T(buffer), rewards=T(rewards))
        for name in got:
            assert torch.equal(again[name]["mean"], got[name]["mean"])


def test_impala_vbn_without_lstm_and_rewards_matches_jax():
    """use_lstm=False: policy_bn sees the clipped reward beside the features;
    rewards omitted read as zeros."""
    jm, pm, bn_np, bn, flat = _impala_pair("patches", False, use_lstm=False)
    buffer = (np.random.RandomState(8).rand(9, *FRAME) * 255).astype(np.float32)
    want = jm.vbn(jm.set_flat(flat), bn_np, buffer)
    got = pm.vbn(pm.set_flat(T(flat)[None]), bn, T(buffer))
    assert_bn_close(got, want)
    assert got["policy_bn"]["mean"].shape == (33,)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_atari_vbn_matches_jax(bf16):
    """AtariCNN's refresh keeps compute_dtype: in bf16 the conv and fc
    operands are rounded as in its forward.  bf16: an f32 intermediate one
    ulp apart can round to the neighbouring bf16 value, so the statistics
    after the bf16 products (bn1-bn3) are held to 2e-3 of their scale."""
    jm = JaxAtariCNN((24, 24), 5, in_channels=3, compute_dtype=jnp.bfloat16 if bf16 else None)
    pm = AtariCNN((24, 24), 5, in_channels=3, compute_dtype=torch.bfloat16 if bf16 else None,
                  device=CPU)
    params_np, bn_np = jm.init(2)
    bn_np = _random_state(bn_np, 2)
    flat = (jm.get_flat(params_np) + 0.05 * np.random.RandomState(2).randn(jm.num_params)
            ).astype(np.float32)
    buffer = np.random.RandomState(9).rand(10, 3, 24, 24).astype(np.float32)
    want = jm.vbn(jm.set_flat(flat), bn_np, buffer)
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    got = pm.vbn(pm.set_flat(T(flat)[None]), bn, T(buffer))
    if not bf16:
        assert_bn_close(got, want)
        return
    for name in want:
        for k in ("mean", "var"):
            w = np.asarray(want[name][k])
            assert np.abs(_np(got[name][k]) - w).max() <= 2e-3 * np.abs(w).max(), (name, k)
        np.testing.assert_array_equal(_np(got[name]["n"]), np.asarray(want[name]["n"]))


# -- the trainer ------------------------------------------------------------------------


BASE = dict(batch_size=16, learning_rate=0.05, noise_std=0.05, zeta_size=8,
            max_strategy_history_size=4, random_seed=5, vbn_buffer_size=40)


def _trainer_pair(jmodel, jenv, pmodel, penv, kw):
    jtr = JaxTrainer(jmodel, jenv, jax_distances.categorical_tvd, JaxTrainConfig(**kw))
    draws = {}
    ptr = VectorizedTrainer(pmodel, penv, distances.categorical_tvd, TrainConfig(**kw),
                            device=CPU, draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    ptr._vbn_buffer = vbn_buffer_from_numpy(jtr._vbn_buffer, CPU)
    return jtr, ptr, draws


@pytest.mark.parametrize("kw", [
    dict(BASE),
    dict(BASE, noise_backend="pallas", normalize_obs=True, obs_stats_update_chance=0.05),
    dict(BASE, population_chunk=4, envs_per_perturbation=2),
], ids=["jax", "pallas-normalized", "chunked-e2"])
def test_trap_trainer_with_vbn_matches_jax(kw, monkeypatch):
    """Three epochs of the trap MLP with a 40-frame VBN buffer: the refreshed
    statistics feed the next epoch's rollouts, novelty and zeta."""
    jtr, ptr, draws = _trainer_pair(JaxDiscreteMLP(2, 9), JaxTrapEnv(),
                                    DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU), kw)
    assert ptr._vbn_buffer[0].shape == (40, 2) and ptr._vbn_buffer[1].shape == (40,)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert float(ptr.state.bn_state["bn1"]["n"]) == 3


ENV = dict(grid=4, scale=8, max_steps=10, num_levels=20)


def test_impala_trainer_with_vbn_matches_jax(monkeypatch):
    """The small fused_feat IMPALA in chunks of P/2 with a 12-frame buffer
    and its arrival rewards: from epoch 2 on the rollouts fold the refreshed
    statistics into the fused kernels (a stale fold would show here)."""
    kw = dict(BASE, batch_size=8, zeta_size=4, vbn_buffer_size=12, population_chunk=4)
    jenv = JaxProcMazeEnv(**ENV)
    penv = ProcMazeEnv(**ENV, device=CPU)
    jtr, ptr, draws = _trainer_pair(
        JaxImpala(jenv.obs_shape, 5, conv_impl="fused_feat", **SMALL), jenv,
        ImpalaPolicy(penv.obs_shape, 5, conv_impl="fused_feat", device=CPU, **SMALL), penv, kw)
    assert np.abs(_np(ptr._vbn_buffer[1])).max() > 0  # real arrival rewards
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert float(ptr.state.bn_state["policy_bn"]["n"]) == 3


def test_seed_buffer_keeps_arrival_rewards():
    """The port's own buffer: each observation with the reward of the step
    that led to it, 0 at resets (replayed on the env from the same draws)."""
    env = ProcMazeEnv(**ENV, device=CPU)
    tr = VectorizedTrainer(ImpalaPolicy(env.obs_shape, 5, device=CPU, **SMALL), env,
                           distances.categorical_tvd,
                           TrainConfig(**dict(BASE, batch_size=4, zeta_size=2,
                                              vbn_buffer_size=25)), device=CPU)
    obs, rewards = tr._vbn_buffer
    tr.generator.manual_seed(5)
    tr._seed_buffer(2)  # the zeta draw consumed first, as at construction
    again, again_rewards = tr._seed_buffer(25, with_rewards=True)
    assert torch.equal(again, obs) and torch.equal(again_rewards, rewards)
    # replay: the draws give the actions and resets
    tr.generator.manual_seed(5)
    tr._seed_buffer(2)
    actions = torch.randint(0, 5, (25,), generator=tr.generator)
    resets = env.sample_reset((26,), tr.generator)
    st, o = env.reset(1, resets[:1])
    want_r = [0.0]
    for k in range(24):
        assert torch.equal(o[0], obs[k])
        st, o, r, done = env.step(st, actions[k:k + 1])
        if bool(done):
            st, o = env.reset(1, resets[k + 1:k + 2])
            want_r.append(0.0)
        else:
            want_r.append(float(r))
    np.testing.assert_array_equal(_np(rewards), np.array(want_r, np.float32))
    assert (_np(rewards) != 0).any()


@pytest.mark.parametrize("case, faults", [
    ("equal", 0), ("within_rtol", 0), ("near_zero_within_scale", 0), ("beyond_rtol", 1),
    ("near_zero_beyond_scale", 1), ("n_differs", 1), ("shape_differs", 1)])
def test_bn_closeness_rule(case, faults):
    """``utils/closeness.py``'s rule, which every bn_state check reads: rtol
    of each element plus rtol of the vector's largest magnitude, n exact."""
    from dfd_tpu_torch.utils.closeness import bn_state_mismatch

    want = {"bn": {"mean": np.array([100.0, 0.0], np.float32),
                   "var": np.array([2.0, 3.0], np.float32), "n": np.float32(4)}}
    got = {"bn": {k: torch.tensor(v) for k, v in want["bn"].items()}}
    change = {"within_rtol": ("mean", torch.tensor([100.0 * (1 + 5e-6), 0.0])),
              "near_zero_within_scale": ("mean", torch.tensor([100.0, 9e-4])),
              "beyond_rtol": ("var", torch.tensor([2.0 * (1 + 3e-5), 3.0])),
              "near_zero_beyond_scale": ("mean", torch.tensor([100.0, 1.2e-3])),
              "n_differs": ("n", torch.tensor(5.0)),
              "shape_differs": ("var", torch.tensor([2.0, 3.0, 1.0]))}.get(case)
    if change:
        got["bn"][change[0]] = change[1]
    found, worst = bn_state_mismatch(got, want)
    assert len(found) == faults, found
    assert worst < 1e-5 or faults


def test_tree_to_moves_every_tensor_of_a_train_state():
    """``core/device.py::tree_to`` keeps a TrainState's structure (its
    NamedTuples, dicts, plain tuples and ints) and moves each tensor."""
    from dfd_tpu_torch.core.device import tree_to

    tr = VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                           distances.categorical_tvd,
                           TrainConfig(batch_size=4, zeta_size=4, vbn_buffer_size=6),
                           device=CPU)
    moved = tree_to(tr.state, torch.device(CPU))
    assert type(moved) is type(tr.state) and moved.epoch == tr.state.epoch
    assert type(moved.omega) is type(tr.state.omega)
    assert torch.equal(moved.flat, tr.state.flat)
    assert set(moved.bn_state) == set(tr.state.bn_state)
    assert tree_to((torch.ones(2), 3), CPU)[1] == 3
