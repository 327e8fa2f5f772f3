"""``VectorizedTrainer.eval_panel``, ``set_env`` and the level curriculum
(``dfd_tpu_torch.utils.curriculum``) held against the JAX package's, on the
CPU.  The panel's resets are JAX's own (computed from the panel keys on the
host), so its integer rewards agree exactly; the swap and the curriculum
follow ``tests/test_curriculum.py``, with 20x20 frames, the least the port's
``AtariCNN`` takes."""

import numpy as np
import pytest
import torch

from _torch_port import jax_state_numpy, run_and_compare
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.pixelgrid import PixelGridEnv as JaxPixelGridEnv
from dfd_tpu.envs.procmaze import ProcMazeEnv as JaxProcMazeEnv
from dfd_tpu.models.atari import AtariCNN as JaxAtariCNN
from dfd_tpu.models.impala import ImpalaPolicy as JaxImpala
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu.utils.curriculum import train_level_curriculum as jax_curriculum
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import PixelGridEnv, ProcMazeEnv, TrapEnv
from dfd_tpu_torch.models import AtariCNN, ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils.curriculum import train_level_curriculum

CPU = "cpu"
KW = dict(batch_size=6, learning_rate=0.05, noise_std=0.05, zeta_size=4,
          max_strategy_history_size=4, random_seed=3)


def _pair(jmodel, jenv, pmodel, penv, kw=KW):
    jtr = JaxTrainer(jmodel, jenv, jax_distances.categorical_tvd, JaxTrainConfig(**kw))
    draws = {}
    ptr = VectorizedTrainer(pmodel, penv, distances.categorical_tvd, TrainConfig(**kw),
                            device=CPU, draw_source=lambda epoch: draws[epoch])
    ptr.state = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    return jtr, ptr, draws


def _snapshot(tr):
    return (tr.generator.get_state(), tr.state.zeta.clone(), tr.state.flat.clone(),
            float(tr.state.policy_reward), float(tr.state.policy_entropy),
            float(tr.state.policy_novelty), tr.state.epoch, tr.cumulative_timesteps)


def _assert_unchanged(before, tr):
    """The generator, zeta, flat, the EMAs, the epoch and the step count are
    as they were."""
    after = _snapshot(tr)
    assert all(torch.equal(a, b) for a, b in zip(before[:3], after[:3]))
    assert before[3:] == after[3:]


def test_eval_panel_on_procmaze_matches_jax(monkeypatch):
    """The small fused_feat IMPALA after two epochs of training on JAX's
    draws (normalized observations): the panel's 12 greedy episodes, each on
    JAX's level for key fold_in(key(panel_seed), i), equal JAX's rewards;
    the panel moves no training state, and a second call repeats it."""
    env_kw = dict(grid=4, scale=8, max_steps=10, num_levels=50)
    model_kw = dict(channels=(8, 16, 16), hidden=32, conv_impl="fused_feat")
    jenv, penv = JaxProcMazeEnv(**env_kw), ProcMazeEnv(**env_kw, device=CPU)
    kw = dict(KW, normalize_obs=True, obs_stats_update_chance=0.2, random_seed=4)
    jtr, ptr, draws = _pair(JaxImpala(jenv.obs_shape, 5, **model_kw), jenv,
                            ImpalaPolicy(penv.obs_shape, 5, device=CPU, **model_kw), penv, kw)
    run_and_compare(jtr, ptr, draws, 2, monkeypatch)
    monkeypatch.undo()
    want = jtr.eval_panel(12, panel_seed=77)
    before = _snapshot(ptr)
    got = ptr.eval_panel(12, panel_seed=77)
    assert got.shape == (12,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1  # the levels really differ
    _assert_unchanged(before, ptr)
    np.testing.assert_array_equal(ptr.eval_panel(12, panel_seed=77), got)
    assert not np.array_equal(ptr.eval_panel(12, panel_seed=78), got)


def test_eval_panel_on_pixelgrid_matches_jax(monkeypatch):
    """AtariCNN on PixelGridEnv, bench's 0-1 frames: each episode's agent
    and goal cells are JAX's reset draw; rewards equal JAX's."""
    env_kw = dict(grid=4, scale=5, max_steps=10, intensity=1.0)
    jenv, penv = JaxPixelGridEnv(**env_kw), PixelGridEnv(**env_kw, device=CPU)
    jtr, ptr, draws = _pair(JaxAtariCNN((20, 20), 5, in_channels=3), jenv,
                            AtariCNN((20, 20), 5, in_channels=3, device=CPU), penv)
    run_and_compare(jtr, ptr, draws, 2, monkeypatch)
    monkeypatch.undo()
    before = _snapshot(ptr)
    got = ptr.eval_panel(32)
    np.testing.assert_array_equal(got, jtr.eval_panel(32))
    assert len(set(got.tolist())) > 1
    _assert_unchanged(before, ptr)
    with pytest.raises(ValueError, match="seed"):
        ptr.eval_panel(4, panel_seed=-1)


def _cnn_maze(num_levels=2, batch_size=4):
    env = ProcMazeEnv(grid=4, scale=5, max_steps=5, num_levels=num_levels, device=CPU)
    cfg = TrainConfig(batch_size=batch_size, zeta_size=4, max_strategy_history_size=4,
                      episode_length=5, random_seed=0)
    return VectorizedTrainer(AtariCNN(env.obs_shape[1:], env.n_actions, in_channels=3,
                                      device=CPU),
                             env, distances.categorical_tvd, cfg, device=CPU)


def test_set_env_matches_jax_across_a_swap(monkeypatch):
    """One epoch on 1 level, then both trainers swap to 9 levels: the next
    epochs' resets are drawn from the new env (JAX's draws rebuilt through
    the new port env), and every epoch still agrees."""
    env_kw = dict(grid=4, scale=5, max_steps=6, num_levels=1)
    jenv, penv = JaxProcMazeEnv(**env_kw), ProcMazeEnv(**env_kw, device=CPU)
    jtr, ptr, draws = _pair(JaxAtariCNN((20, 20), 5, in_channels=3), jenv,
                            AtariCNN((20, 20), 5, in_channels=3, device=CPU), penv)
    run_and_compare(jtr, ptr, draws, 1, monkeypatch)
    jtr.set_env(jtr.env.with_levels(num_levels=9))
    ptr.set_env(ptr.env.with_levels(num_levels=9))
    assert ptr.env.num_levels == 9
    run_and_compare(jtr, ptr, draws, 2, monkeypatch)
    assert int(draws[2].reset_level.max()) > 0


def test_set_env_carries_training_state_across_the_swap():
    tr = _cnn_maze(num_levels=1)
    tr.train(2)
    flat_before = tr.state.flat.clone()
    archive_len = len(tr.handler.archive)
    bn_before = tr.state.bn_state["bn1"]["mean"].clone()

    tr.set_env(tr.env.with_levels(num_levels=8))
    assert tr.env.num_levels == 8
    draws = tr.draw_source(tr.state.epoch)
    assert int(draws.reset_level.max()) < 8
    tr.train(2)

    assert tr.state.epoch == 4 and len(tr.reporter.history) == 4
    assert not torch.equal(flat_before, tr.state.flat)
    assert torch.equal(bn_before, tr.state.bn_state["bn1"]["mean"])  # no VBN: unchanged
    assert len(tr.handler.archive) >= archive_len
    for m in tr.reporter.history:
        assert np.isfinite(m["Noisy Reward"])


def test_set_env_rejects_interface_mismatch():
    tr = _cnn_maze()
    with pytest.raises(ValueError, match="obs_shape"):
        tr.set_env(ProcMazeEnv(grid=8, scale=8, max_steps=5, device=CPU))
    with pytest.raises(ValueError, match="obs_shape"):
        tr.set_env(TrapEnv(device=CPU))

    class SixActionMaze(ProcMazeEnv):
        n_actions = 6

    with pytest.raises(ValueError, match="action"):
        tr.set_env(SixActionMaze(grid=4, scale=5, max_steps=5, device=CPU))


def test_train_level_curriculum_runs_phases():
    tr = _cnn_maze(num_levels=1)
    train_level_curriculum(tr, [(1, 1), (2, 4), (1, 16)], fast=True, sync_every=2)
    assert tr.state.epoch == 4
    assert tr.env.num_levels == 16


def test_curriculum_first_phase_swaps_if_needed():
    tr = _cnn_maze(num_levels=50)
    train_level_curriculum(tr, [(1, 2)], fast=False)
    assert tr.env.num_levels == 2
    assert tr.state.epoch == 1


def test_curriculum_matches_jax(monkeypatch):
    """The copied driver swaps at the same phases as JAX's, with a
    start level: the envs after each phase agree."""
    env_kw = dict(grid=4, scale=5, max_steps=5, num_levels=3)
    jtr = JaxTrainer(JaxAtariCNN((20, 20), 5, in_channels=3), JaxProcMazeEnv(**env_kw),
                     jax_distances.categorical_tvd, JaxTrainConfig(**KW))
    ptr = _cnn_maze(num_levels=3)
    phases = [(1, 3), (1, 5)]
    for fn, tr in ((jax_curriculum, jtr), (train_level_curriculum, ptr)):
        fn(tr, phases, start_level=7, fast=False)
    assert (ptr.env.num_levels, ptr.env.start_level) == (jtr.env.num_levels,
                                                          jtr.env.start_level) == (5, 7)
    np.testing.assert_array_equal(ptr.env.level_arrays()[2].numpy(),
                                  np.stack([np.asarray(jtr.env._gen_level(7 + i)[2])
                                            for i in range(5)]))
