"""``FrameStackEnv`` and ``PadChannelsEnv`` held against the JAX package's,
on the CPU: frames, rewards and done flags exact (pixel envs of integer
cells); a rollout freezes a done episode's stack with its inner state; and
the trainer on each wrapper, with ``AtariCNN``, matches JAX epoch by epoch
under ``run_and_compare``'s tolerances (rewards exact, flat within rtol
1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs import FrameStackEnv as JFrameStackEnv
from dfd_tpu.envs import PadChannelsEnv as JPadChannelsEnv
from dfd_tpu.envs import PixelGridEnv as JPixelGridEnv
from dfd_tpu.models.atari import AtariCNN as JaxAtariCNN
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import FrameStackEnv, FrameStackState, PadChannelsEnv, PixelGridEnv
from dfd_tpu_torch.fd import rollout as port_rollout
from dfd_tpu_torch.models import AtariCNN
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker
GRID = dict(grid=4, scale=4, channels=2, intensity=1.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reset_both(jenv, penv, keys):
    """Both envs reset under JAX's keys: the port's from their draws."""
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    pstate, pobs = penv.reset(len(keys), torch.from_numpy(
        penv.reset_draw(np.asarray(jax.random.key_data(keys)))))
    return jstate, np.asarray(jobs), pstate, _np(pobs)


def _keys(seed, n):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(n))


def test_framestack_reset_repeats_first_frame():
    env = FrameStackEnv(PixelGridEnv(**GRID, device=CPU), k=3)
    jenv = JFrameStackEnv(JPixelGridEnv(**GRID), k=3)
    assert env.obs_shape == jenv.obs_shape == (6, 16, 16)
    _, jobs, state, obs = _reset_both(jenv, env, _keys(0, 2))
    np.testing.assert_array_equal(obs, jobs)
    # all k slots hold the first frame at reset (deepmind FrameStack)
    np.testing.assert_array_equal(obs[:, 0:2], obs[:, 2:4])
    np.testing.assert_array_equal(obs[:, 2:4], obs[:, 4:6])
    assert isinstance(state, FrameStackState)


def test_framestack_step_shifts_window():
    inner = PixelGridEnv(**GRID, device=CPU)
    env = FrameStackEnv(inner, k=2)
    jenv = JFrameStackEnv(JPixelGridEnv(**GRID), k=2)
    jstate, _, state, obs0 = _reset_both(jenv, env, _keys(1, 1))
    a = torch.tensor([4])
    state, obs1, r1, _ = env.step(state, a)
    state, obs2, r2, _ = env.step(state, a)
    jstep = jax.vmap(jenv.step)
    for want in (obs1, obs2):
        jstate, jobs, _, _ = jstep(jstate, jnp.asarray([4]))
        np.testing.assert_array_equal(_np(want), np.asarray(jobs))
    # the newest frame occupies the last C channels; after the second step
    # the older slot of obs2 equals the newer slot of obs1
    np.testing.assert_array_equal(_np(obs2)[:, 0:2], _np(obs1)[:, 2:4])
    # rewards flow through from the inner env unchanged
    s, _ = inner.reset(1, torch.from_numpy(inner.reset_draw(
        np.asarray(jax.random.key_data(_keys(1, 1))))))
    _, _, r, _ = inner.step(s, a)
    assert torch.equal(r1, r)


def test_framestack_batched_steps_match_jax():
    """Four episodes, five steps of random actions: every stack equals the
    JAX env's under vmap."""
    env = FrameStackEnv(PixelGridEnv(**GRID, device=CPU), k=2)
    jenv = JFrameStackEnv(JPixelGridEnv(**GRID), k=2)
    jstate, _, state, _ = _reset_both(jenv, env, _keys(0, 4))
    jstep = jax.jit(jax.vmap(jenv.step))
    actions = np.random.RandomState(3).randint(0, 5, size=(5, 4))
    for t in range(5):
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(actions[t]))
        state, obs, rew, done = env.step(state, torch.from_numpy(actions[t]))
        np.testing.assert_array_equal(_np(obs), np.asarray(jobs))
        np.testing.assert_array_equal(_np(rew), np.asarray(jrew))
        np.testing.assert_array_equal(_np(done), np.asarray(jdone))


def test_pad_channels_adds_zero_planes():
    env = PadChannelsEnv(PixelGridEnv(**dict(GRID, channels=3), device=CPU), to_channels=4)
    jenv = JPadChannelsEnv(JPixelGridEnv(**dict(GRID, channels=3)), to_channels=4)
    assert env.obs_shape == jenv.obs_shape == (4, 16, 16)
    jstate, jobs, state, obs = _reset_both(jenv, env, _keys(0, 2))
    state, obs2, _, _ = env.step(state, torch.tensor([1, 3]))
    _, jobs2, _, _ = jax.vmap(jenv.step)(jstate, jnp.asarray([1, 3]))
    for o, j in ((obs, jobs), (_np(obs2), np.asarray(jobs2))):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(o[:, 3], np.zeros_like(o[:, 3]))
        assert o[:, :3].max() > 0
    # the reset draw passes through to the inner env
    assert env.reset_shape == (4,) and env.reset_high == 4


def test_wrappers_refuse_what_jax_refuses():
    with pytest.raises(ValueError):
        PadChannelsEnv(PixelGridEnv(grid=4, scale=4, channels=3, device=CPU), to_channels=2)
    with pytest.raises(ValueError, match="CHW"):
        from dfd_tpu_torch.envs import TrapEnv

        FrameStackEnv(TrapEnv(device=CPU), k=2)


def test_a_done_episode_keeps_its_stack():
    """The rollout's freeze (``fd/rollout.py::_keep``) keeps a done
    episode's whole state, stack and inner state, and steps the others;
    a rollout whose episodes end before its horizon counts each episode's
    steps once."""
    env = FrameStackEnv(PixelGridEnv(**dict(GRID, max_steps=3), device=CPU), k=2)
    state, _ = env.reset(3, torch.tensor([[0, 0, 3, 3], [1, 1, 2, 2], [0, 3, 3, 0]]))
    new, _, _, _ = env.step(state, torch.tensor([2, 4, 1]))
    done = torch.tensor([True, False, True])
    kept = FrameStackState(*port_rollout._keep(done, new, state))
    for got, old, stepped in ((kept.stack, state.stack, new.stack),
                              (kept.inner.agent, state.inner.agent, new.inner.agent),
                              (kept.inner.t, state.inner.t, new.inner.t)):
        assert torch.equal(got[done], old[done]) and torch.equal(got[~done], stepped[~done])
    assert not torch.equal(new.stack[0], state.stack[0])  # the done row did move when stepped

    env = FrameStackEnv(PixelGridEnv(**dict(GRID, scale=6, max_steps=3), device=CPU), k=2)
    model = AtariCNN((24, 24), 5, in_channels=4, device=CPU)
    params, bn = model.init(0)
    res = port_rollout.episode_rollout(
        model, env, model.set_flat(model.get_flat(params)[None]), bn, 6,
        torch.zeros(1, dtype=torch.bool), torch.zeros(()), torch.ones(()), False, 0.0,
        torch.zeros((1, 3, 6, 5)), torch.ones((1, 3, 6)),
        torch.tensor([[[0, 0, 3, 3], [1, 1, 2, 2], [0, 3, 3, 0]]]), 0)
    assert res.steps.tolist() == [[3, 3, 3]]


ATARI_GRID = dict(grid=4, scale=6, max_steps=10, intensity=1.0)
BASE = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
            max_strategy_history_size=4, episode_length=10, random_seed=5)


@pytest.mark.parametrize("wrapper", ["framestack", "pad"])
def test_trainer_on_wrapped_pixels_matches_jax(wrapper, monkeypatch):
    """The vectorized trainer with ``AtariCNN`` on FrameStackEnv(PixelGrid,
    k=2) (6 channels) or PadChannelsEnv(PixelGrid, 4), 3 epochs on JAX's
    draws."""
    if wrapper == "framestack":
        jenv = JFrameStackEnv(JPixelGridEnv(**ATARI_GRID), k=2)
        penv = FrameStackEnv(PixelGridEnv(**ATARI_GRID, device=CPU), k=2)
    else:
        jenv = JPadChannelsEnv(JPixelGridEnv(**ATARI_GRID), to_channels=4)
        penv = PadChannelsEnv(PixelGridEnv(**ATARI_GRID, device=CPU), to_channels=4)
    c = penv.obs_shape[0]
    jtr = JaxTrainer(JaxAtariCNN((24, 24), 5, in_channels=c), jenv,
                     jax_distances.categorical_tvd, JaxTrainConfig(**BASE))
    draws = {}
    ptr = VectorizedTrainer(AtariCNN((24, 24), 5, in_channels=c, device=CPU), penv,
                            distances.categorical_tvd, TrainConfig(**BASE), device=CPU,
                            draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    run_and_compare(jtr, ptr, draws, 3, monkeypatch)
