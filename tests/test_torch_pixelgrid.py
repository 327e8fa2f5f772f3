"""``PixelGridEnv`` and ``AtariCNN`` held against the JAX package's, on the
CPU, at a parity size: 3x24x24 frames (``grid=4, scale=6``; the CNN's
second conv needs 20 pixels a side), the bench cell's 0-1 intensity.

The env is integer arithmetic and frames of 0s and 1s: bit for bit.  The
CNN's float32 forward: rtol 1e-5 / atol 1e-6 on probabilities.  bf16: both
sides round the same float32 operands to bf16 and accumulate in float32, but
an f32 intermediate one ulp apart can round to the neighbouring bf16 value,
so bf16 probabilities are held to atol 2e-3, and the bf16 trainer runs on
JAX's draws whose sampled actions keep a margin over the packages'
log-probability deviation (checked), as the bf16 IMPALA trainer test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import episode_draws, jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.pixelgrid import PixelGridEnv as JaxPixelGridEnv
from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu.fd import rollout as jax_rollout
from dfd_tpu.models.atari import AtariCNN as JaxAtariCNN
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import params_from_numpy, train_state_from_numpy, vbn_buffer_from_numpy
from dfd_tpu_torch.envs import PixelGridEnv, ProcMazeEnv
from dfd_tpu_torch.fd import rollout as port_rollout
from dfd_tpu_torch.models import AtariCNN
from dfd_tpu_torch.models import base as port_base
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
T = torch.from_numpy
ENV = dict(grid=4, scale=6, max_steps=10, intensity=1.0)
HW = (24, 24)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys(seed, n):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(n))


@pytest.mark.parametrize("channels, intensity", [(3, 1.0), (5, 255.0)])
def test_pixelgrid_matches_jax_for_40_steps(channels, intensity):
    """Resets from JAX's keys (the port computes the draw on the host), then
    40 steps of random actions: states, frames, rewards and dones equal."""
    kw = dict(grid=5, scale=3, channels=channels, max_steps=30, intensity=intensity)
    jenv, penv = JaxPixelGridEnv(**kw), PixelGridEnv(**kw, device=CPU)
    assert penv.obs_shape == jenv.obs_shape and penv.n_actions == jenv.n_actions == 5
    M = 16
    keys = _keys(3, M)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    draw = penv.reset_draw(np.array(jax.random.key_data(keys)))
    assert draw.shape == (M, 4) and draw.dtype == np.int64
    pstate, pobs = penv.reset(M, T(draw))
    np.testing.assert_array_equal(_np(pobs), np.asarray(jobs))
    actions = np.random.RandomState(0).randint(0, 5, (40, M))
    jstep = jax.jit(jax.vmap(jenv.step))
    reached = False
    for t in range(40):
        jstate, jobs, jrew, jdone = jstep(jstate, actions[t])
        pstate, pobs, prew, pdone = penv.step(pstate, T(actions[t]))
        for a, b in zip(pstate, jstate):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=f"step {t}")
        np.testing.assert_array_equal(_np(pobs), np.asarray(jobs), err_msg=f"step {t}")
        np.testing.assert_array_equal(_np(prew), np.asarray(jrew), err_msg=f"step {t}")
        np.testing.assert_array_equal(_np(pdone), np.asarray(jdone), err_msg=f"step {t}")
        reached |= bool((_np(prew) > 9).any())
    assert reached  # some agent reached its goal


def test_reset_draws_equal_jax():
    """Each env's host reset draw equals what its JAX env draws from the
    same key: ProcMaze's level, PixelGrid's agent and goal cells; and the
    generator's draws have the declared trailing shape."""
    keys = _keys(8, 50)
    words = np.array(jax.random.key_data(keys))
    jmaze, pmaze = JaxProcMazeEnv(grid=4, num_levels=37), ProcMazeEnv(grid=4, num_levels=37,
                                                                        device=CPU)
    want = np.array(jax.vmap(lambda k: jax.random.randint(k, (), 0, 37))(keys))
    np.testing.assert_array_equal(pmaze.reset_draw(words), want)
    jgrid, pgrid = JaxPixelGridEnv(grid=7), PixelGridEnv(grid=7, device=CPU)
    st, _ = jax.vmap(jgrid.reset)(keys)
    np.testing.assert_array_equal(pgrid.reset_draw(words),
                                  np.concatenate([np.asarray(st.agent), np.asarray(st.goal)], 1))
    gen = torch.Generator().manual_seed(0)
    d = pgrid.sample_reset((3, 2), gen)
    assert d.shape == (3, 2, 4) and int(d.min()) >= 0 and int(d.max()) < 7
    assert pmaze.sample_reset((3, 2), gen).shape == (3, 2)
    with pytest.raises(ValueError, match=r"\(5, 4\)"):
        pgrid.reset(5, torch.zeros(5, dtype=torch.int64))


def _cnn_pair(bf16=False, seed=3):
    jm = JaxAtariCNN(HW, 5, in_channels=3, compute_dtype=jnp.bfloat16 if bf16 else None)
    pm = AtariCNN(HW, 5, in_channels=3, compute_dtype=torch.bfloat16 if bf16 else None,
                  device=CPU)
    params_np, bn_np = jm.init(seed)
    rng = np.random.RandomState(seed)
    bn_np = {k: dict(v, mean=(rng.randn(*v["mean"].shape) * 0.1).astype(np.float32),
                     var=(rng.rand(*v["var"].shape) + 0.5).astype(np.float32))
             for k, v in bn_np.items()}
    _, bn = params_from_numpy(pm, params_np, bn_np, CPU)
    flat = jm.get_flat(params_np)
    flats = (flat[None] + 0.05 * np.random.RandomState(1).randn(3, flat.size)).astype(np.float32)
    jparams = jax.vmap(lambda v: jm.set_flat(v, xp=jnp))(flats)
    return jm, pm, bn_np, bn, flats, jparams, pm.set_flat(T(flats))


def test_atari_init_spec_and_bench_width():
    """normc init draw for draw, the JAX flat order; at the cnn_pixelgrid
    cell's 3x64x64 frames d = 308,373; frames below 20 pixels refuse."""
    jm, pm = JaxAtariCNN(HW, 5, in_channels=3), AtariCNN(HW, 5, in_channels=3, device=CPU)
    assert pm.param_spec.entries == jm.param_spec.entries
    for seed in (0, 4):
        jp, js = jm.init(seed)
        pp, ps = pm.init(seed)
        np.testing.assert_array_equal(pm.get_flat(pp).numpy(), jm.get_flat(jp))
        for name in js:
            for k in js[name]:
                np.testing.assert_array_equal(ps[name][k].numpy(), js[name][k])
    big = AtariCNN((64, 64), 5, in_channels=3, device=CPU)
    assert big.num_params == JaxAtariCNN((64, 64), 5, in_channels=3).num_params == 308_373
    with pytest.raises(ValueError, match="20x20"):
        AtariCNN((16, 16), 5, in_channels=3, device=CPU)
    with pytest.raises(ValueError, match="compute_dtype"):
        AtariCNN(HW, 5, compute_dtype=torch.float16, device=CPU)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_atari_forwards_match_jax(bf16):
    """apply, strategy and entropy of a perturbed population of M = 3 on
    shared frames, per-member frames and channels-last frames."""
    jm, pm, bn_np, bn, flats, jparams, pparams = _cnn_pair(bf16)
    tol = dict(atol=2e-3) if bf16 else dict(rtol=1e-5, atol=1e-6)
    rng = np.random.RandomState(6)
    frames = rng.rand(4, 3, *HW).astype(np.float32)
    for fn in ("apply", "strategy", "entropy"):
        want = jax.vmap(lambda p: getattr(jm, fn)(p, bn_np, frames))(jparams)
        np.testing.assert_allclose(_np(getattr(pm, fn)(pparams, bn, T(frames))), np.asarray(want),
                                   err_msg=fn, **tol)
    own = rng.rand(3, 2, 3, *HW).astype(np.float32)
    want = jax.vmap(lambda p, f: jm.apply(p, bn_np, f))(jparams, own)
    np.testing.assert_allclose(_np(pm.apply(pparams, bn, T(own))), np.asarray(want), **tol)
    last = np.ascontiguousarray(frames.transpose(0, 2, 3, 1))
    want = jax.vmap(lambda p: jm.apply(p, bn_np, last))(jparams)
    np.testing.assert_allclose(_np(pm.apply(pparams, bn, T(last))), np.asarray(want), **tol)


def test_atari_episode_rollout_on_pixelgrid_matches_jax():
    """M = 5 perturbed members, one deterministic, each on its own reset:
    the acting path (the base act_step over the CNN) and the env agree."""
    M, Z = 5, 4
    jenv, penv = JaxPixelGridEnv(**ENV), PixelGridEnv(**ENV, device=CPU)
    jm, pm, bn_np, bn, flats, _, _ = _cnn_pair(seed=2)
    flats = flats[0] + 0.3 * np.random.RandomState(0).randn(M, flats.shape[1]).astype(np.float32)
    keys = _keys(2, M)
    det = np.arange(M) == 2
    T_ = jenv.max_episode_steps
    zero, one = np.zeros(jenv.obs_shape, np.float32), np.ones(jenv.obs_shape, np.float32)

    def one_episode(v, k, d):
        return jax_rollout.episode_rollout(
            jm, jenv, jm.set_flat(v, xp=jnp), bn_np, k, T_, deterministic=d,
            obs_mean=zero, obs_std=one, normalize_obs=False, obs_stats_update_chance=0.0,
            collect_states=False, collect_limit=Z,
        )

    want = jax.jit(jax.vmap(one_episode))(flats, keys, det)
    g, u, reset = episode_draws(keys, T_, 5, penv)
    got = port_rollout.episode_rollout(
        pm, penv, pm.set_flat(T(flats)), bn, T_, T(det), T(zero), T(one), normalize_obs=False,
        obs_stats_update_chance=0.0, action_noise=T(g)[:, None], stats_uniform=T(u)[:, None],
        reset_level=T(reset)[:, None], collect_limit=Z,
    )
    np.testing.assert_array_equal(_np(got.reward[:, 0]), np.asarray(want.reward))
    np.testing.assert_array_equal(_np(got.steps[:, 0]), np.asarray(want.steps))
    assert len(set(_np(got.reward[:, 0]).tolist())) > 1
    np.testing.assert_allclose(_np(got.entropy[:, 0]), np.asarray(want.entropy), rtol=1e-5)
    np.testing.assert_array_equal(_np(got.states), np.asarray(want.states))


def _trainer_pair(kw, bf16=False):
    jenv, penv = JaxPixelGridEnv(**ENV), PixelGridEnv(**ENV, device=CPU)
    jtr = JaxTrainer(JaxAtariCNN(HW, 5, in_channels=3,
                                 compute_dtype=jnp.bfloat16 if bf16 else None),
                     jenv, jax_distances.categorical_tvd, JaxTrainConfig(**kw))
    draws = {}
    ptr = VectorizedTrainer(
        AtariCNN(HW, 5, in_channels=3, compute_dtype=torch.bfloat16 if bf16 else None,
                 device=CPU),
        penv, distances.categorical_tvd, TrainConfig(**kw), device=CPU,
        draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    if jtr._vbn_buffer is not None:
        ptr._vbn_buffer = vbn_buffer_from_numpy(jtr._vbn_buffer, CPU)
    return jtr, ptr, draws


BASE = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
            max_strategy_history_size=4, episode_length=10, random_seed=5)


def test_atari_trainer_with_vbn_matches_jax(monkeypatch):
    """The cnn_pixelgrid cell's model and env at the parity size, in
    float32 with a 10-frame VBN buffer: three epochs of ``train(1)``."""
    jtr, ptr, draws = _trainer_pair(dict(BASE, vbn_buffer_size=10))
    assert ptr.draw_source is not ptr._own_draws
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
    assert ptr.reporter.history[-1]["Noisy Novelty"] > 0
    assert float(ptr.state.bn_state["bn3"]["n"]) == 3


def test_bf16_atari_trainer_matches_jax(monkeypatch):
    """The cell's own bf16 model: three epochs on JAX's draws.  Its head is
    float32 with a 0.01 normc gain, so the bf16 rounding moves a
    log-probability by about as little as float32 sums do; the sampled
    actions, and with them the rewards, agree exactly because every action's
    score keeps a margin of more than 10x the largest log-probability
    deviation between the packages at the start (both checked).  Entropies
    and novelties, read from the probabilities, to rtol 1e-3."""
    jtr, ptr, draws = _trainer_pair(dict(BASE, random_seed=7), bf16=True)
    zeta = np.asarray(jtr.state.zeta)
    want = np.log(np.asarray(jtr.model.apply(jtr.model.set_flat(np.asarray(jtr.state.flat)),
                                             jtr.state.bn_state, zeta)))
    got = torch.log(ptr.model.apply(ptr.model.set_flat(ptr.state.flat[None]),
                                    ptr.state.bn_state, ptr.state.zeta))[0]
    deviation = np.abs(_np(got) - want).max()
    margins = []
    inner = port_base.sample_action

    def spy(probs, deterministic, gumbel):
        logp = torch.log(torch.clamp_min(probs, 1e-38))
        score = torch.where(deterministic[:, None, None], logp, logp + gumbel)
        top = score.topk(2, dim=-1).values
        margins.append(float((top[..., 0] - top[..., 1]).min()))
        return inner(probs, deterministic, gumbel)

    monkeypatch.setattr(port_base, "sample_action", spy)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch,
                    loose=("Policy Entropy", "Policy Novelty", "Noisy Novelty"), loose_rtol=1e-3)
    assert 10 * deviation < min(margins), (deviation, min(margins))
