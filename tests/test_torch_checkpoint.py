"""Checkpoint and resume (``dfd_tpu_torch.utils.checkpoint``) on the CPU:
a resumed run ends bit for bit on the unbroken run's state, a file the JAX
package wrote loads equal to ``train_state_from_numpy`` of its state, the
file is published atomically, and the restored ``_last_archived`` keeps a
duplicate out of the archive."""

import os

import numpy as np
import pytest
import torch

from _torch_port import jax_state_numpy
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.trap import TrapEnv as JaxTrapEnv
from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dfd_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import ProcMazeEnv, TrapEnv
from dfd_tpu_torch.models import DiscreteMLP, ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils import checkpoint

CPU = "cpu"
KW = dict(batch_size=12, learning_rate=0.05, noise_std=0.05, zeta_size=6,
          max_strategy_history_size=3, random_seed=4, vbn_buffer_size=20)


def _trap(**kw):
    return VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                             distances.categorical_tvd, TrainConfig(**dict(KW, **kw)), device=CPU)


def _impala(**kw):
    env = ProcMazeEnv(grid=4, scale=8, max_steps=8, num_levels=20, device=CPU)
    model = ImpalaPolicy(env.obs_shape, 5, channels=(8, 16, 16), hidden=16,
                         conv_impl="fused_feat", device=CPU)
    cfg = TrainConfig(**dict(KW, batch_size=4, zeta_size=3, vbn_buffer_size=6, **kw))
    return VectorizedTrainer(model, env, distances.categorical_tvd, cfg, device=CPU)


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from ((f"{k}.{n}", v) for n, v in _tensors(tree[k]))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from ((f"{i}.{n}", x) for n, x in _tensors(v))
    else:
        yield "", tree


# The novelty right after a resume is the one thing a checkpoint does not
# carry, in the JAX package's design too: the file holds the archive's flats,
# not which of them the live archive had already evaluated on zeta (the
# newest is appended after the epoch's zeta refresh and evaluated at the
# next), so the first resumed epoch may score novelty against one strategy
# more.  Novelty enters no update: only its metrics and EMA can differ.
NOVELTY = ("policy_novelty", "Policy Novelty", "Noisy Novelty")


def assert_same_run(a, b):
    """Two trainers hold the same state bit for bit: every field of
    ``state``, the archive's flats and strategies, the guard, the counters,
    the generator and the reported metrics (times and ``NOVELTY`` aside)."""
    for field in a.state._fields:
        x, y = getattr(a.state, field), getattr(b.state, field)
        if field == "epoch":
            assert x == y
            continue
        if field in NOVELTY:
            continue
        for (n, u), (m, v) in zip(_tensors(x), _tensors(y)):
            assert n == m and torch.equal(u, v), f"{field} {n}"
    pa, pb = a.handler.archive.points, b.handler.archive.points
    assert len(pa) == len(pb) > 0
    for p, q in zip(pa, pb):
        np.testing.assert_array_equal(p.flat, q.flat)
    np.testing.assert_array_equal(a.handler.strategy_tensor, b.handler.strategy_tensor)
    np.testing.assert_array_equal(a._last_archived, b._last_archived)
    assert a.cumulative_timesteps == b.cumulative_timesteps
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    keep = lambda h: [{k: v for k, v in r.items()
                       if "Time" not in k and "_stage" not in k and k not in NOVELTY} for r in h]
    assert keep(a.reporter.history[-2:]) == keep(b.reporter.history[-2:])


@pytest.mark.parametrize("make", [_trap, _impala], ids=["mlp_vbn", "impala_vbn"])
def test_resume_equals_an_unbroken_run(make, tmp_path):
    """Train 2 epochs, save, train 2 more; a fresh trainer (which draws its
    zeta and VBN buffers at construction) loads the file and trains the same
    2: flat, bn_state, omega, zeta, the reward and entropy EMAs, the
    archive and the generator end equal, bit for bit (``NOVELTY``)."""
    path = str(tmp_path / "run.npz")
    unbroken = make()
    unbroken.train(2)
    checkpoint.save_checkpoint(path, unbroken)
    unbroken.train(1)
    unbroken.train_fast(1)
    resumed = make()
    checkpoint.load_checkpoint(path, resumed)
    assert resumed.state.epoch == 2 and resumed.cumulative_timesteps > 0
    resumed.train(1)
    resumed.train_fast(1)
    assert_same_run(unbroken, resumed)
    assert float(resumed.state.bn_state[next(iter(resumed.state.bn_state))]["n"]) == 4


def test_loads_a_dfd_tpu_checkpoint(tmp_path):
    """A file the JAX package wrote: the state equals
    ``train_state_from_numpy`` of the JAX trainer's, the archive holds its
    flats and equals the JAX package's own restore, the guard and the
    timestep count carry over; its ``key`` is not read (the port's generator
    is left as it was)."""
    path = str(tmp_path / "jax.npz")
    jtr = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jax_distances.categorical_tvd,
                     JaxTrainConfig(**KW))
    jtr.train(2)
    jax_save_checkpoint(path, jtr)
    ptr = _trap()
    before = ptr.generator.get_state()
    checkpoint.load_checkpoint(path, ptr)
    want = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    for field in want._fields:
        x, y = getattr(ptr.state, field), getattr(want, field)
        if field == "epoch":
            assert x == y == 2
            continue
        for (n, u), (m, v) in zip(_tensors(x), _tensors(y)):
            assert n == m and u.dtype == v.dtype and torch.equal(u, v), f"{field} {n}"
    assert ptr.cumulative_timesteps == jtr.cumulative_timesteps
    assert [p.flat.tolist() for p in ptr.handler.archive.points] == [
        p.flat.tolist() for p in jtr.handler.archive.points]
    # the archive as the JAX package restores it: every strategy re-evaluated
    jback = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jax_distances.categorical_tvd,
                       JaxTrainConfig(**KW))
    jax_load_checkpoint(path, jback)
    np.testing.assert_allclose(ptr.handler.strategy_tensor, jback.handler.strategy_tensor,
                               rtol=1e-5, atol=1e-7)
    assert ptr.handler.archive.worst_point_idx == jback.handler.archive.worst_point_idx
    np.testing.assert_array_equal(ptr._last_archived, jtr._last_archived)
    assert torch.equal(ptr.generator.get_state(), before)
    ptr.train(1)  # and trains on from there
    assert ptr.state.epoch == 3


def test_port_file_has_the_jax_keys(tmp_path):
    """The same npz keys as the JAX package's file, the generator's state in
    place of ``key``."""
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jtr = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), jax_distances.categorical_tvd,
                     JaxTrainConfig(**KW))
    jtr.train(1)
    jax_save_checkpoint(jpath, jtr)
    ptr = _trap()
    ptr.train(1)
    checkpoint.save_checkpoint(ppath, ptr)
    with np.load(jpath) as j, np.load(ppath) as p:
        assert set(p.files) == set(j.files) - {"key"} | {"generator"}
        assert str(p["__meta__"]) == str(j["__meta__"])
        assert p["epoch"].dtype == j["epoch"].dtype


def test_save_is_atomic(tmp_path, monkeypatch):
    """The file appears whole or not at all: a write that fails leaves the
    previous checkpoint in place and publishes nothing."""
    path = str(tmp_path / "run.npz")
    tr = _trap()
    tr.train(1)
    checkpoint.save_checkpoint(path, tr)
    assert not os.path.exists(path + ".tmp")
    first = open(path, "rb").read()
    tr.train(1)

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, tr)
    assert open(path, "rb").read() == first
    monkeypatch.undo()
    fresh = _trap()
    checkpoint.load_checkpoint(path, fresh)
    assert fresh.state.epoch == 1


def test_last_archived_blocks_a_duplicate(tmp_path):
    """After a load, the next train call does not submit the restored flat
    again (a distance-0 duplicate in the archive)."""
    path = str(tmp_path / "run.npz")
    tr = _trap(max_strategy_history_size=8)  # the archive stays unfull
    tr.train(2)
    checkpoint.save_checkpoint(path, tr)
    fresh = _trap(max_strategy_history_size=8)
    checkpoint.load_checkpoint(path, fresh)
    n = len(fresh.handler.archive)
    assert n == len(tr.handler.archive)
    fresh._archive_current()
    assert len(fresh.handler.archive) == n
    fresh._last_archived = None  # without the guard the same flat goes in again
    fresh._archive_current()
    assert len(fresh.handler.archive) == n + 1


# -- the sequential topology's host checkpoint ---------------------------------------------


def _seq_runner(package, env_id="SimpleTrapEnv-v0", seed=7, env=None):
    """A SequentialRunner of ``package`` ("jax" or "port") on ``env_id``'s
    host env (or ``env``), batch 4, evals at 0.2."""
    if package == "jax":
        from dfd_tpu.runners import SequentialRunner as Runner
        from dfd_tpu.utils import factory as fac
        from dfd_tpu.utils.metrics import EpochReporter as Reporter
        host, model, dist = fac.get_init_data(env_id, seed)
    else:
        from dfd_tpu_torch.runners import SequentialRunner as Runner
        from dfd_tpu_torch.utils import factory as fac
        from dfd_tpu_torch.utils.metrics import EpochReporter as Reporter
        host, model, dist = fac.get_init_data(env_id, seed, CPU)
    return Runner(model, env if env is not None else host, dist, learning_rate=0.05,
                  noise_std=0.05, batch_size=4, random_seed=seed, zeta_size=10,
                  max_strategy_history_size=10, eval_prob=0.2, reporter=Reporter(quiet=True))


def _swimmer_runner():
    from dfd_tpu_torch.envs import SwimmerEnv
    from dfd_tpu_torch.runners import HostEnv

    return _seq_runner("port", "Swimmer-v0", 5,
                       env=HostEnv(SwimmerEnv(max_steps=25, device=CPU), seed=5))


@pytest.mark.parametrize("make", [lambda: _seq_runner("port"), _swimmer_runner],
                         ids=["trap", "swimmer"])
def test_host_checkpoint_resume_is_exact(make, tmp_path):
    """Train 2 epochs, save, train 2 more; a fresh runner loads the file and
    trains the same 2: flat, the rewards, the timesteps, omega and the host
    env's reset key end equal (the swimmer's resets draw from that key)."""
    path = str(tmp_path / "host.npz")
    a = make()
    a.train(2)
    checkpoint.save_host_checkpoint(path, a)
    a.train(2)
    b = make()
    checkpoint.load_host_checkpoint(path, b)
    assert b.learner.epoch == 2
    b.train(2)
    np.testing.assert_array_equal(a.learner.flat, b.learner.flat)
    assert [r["Noisy Reward"] for r in a.reporter.history[-2:]] == \
        [r["Noisy Reward"] for r in b.reporter.history[-2:]]
    assert a.agent.cumulative_timesteps == b.agent.cumulative_timesteps
    assert a.omega.omega == b.omega.omega
    np.testing.assert_array_equal(a.agent.env._key, b.agent.env._key)
    for u, v in zip(checkpoint._state_leaves(a.agent.env._state),
                    checkpoint._state_leaves(b.agent.env._state)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_host_checkpoint_crosses_packages(writer, tmp_path):
    """A file one package wrote after 2 epochs, read by the other: the
    learner, the archive, zeta, the RNG streams and the episode in flight
    carry over, so both go on with the same epoch: actions and rewards
    equal, flat within rtol 1e-5 (the sequential parity tests' bound)."""
    from dfd_tpu.utils.checkpoint import load_host_checkpoint as jload
    from dfd_tpu.utils.checkpoint import save_host_checkpoint as jsave

    reader = "port" if writer == "jax" else "jax"
    save = {"jax": jsave, "port": checkpoint.save_host_checkpoint}[writer]
    load = {"jax": jload, "port": checkpoint.load_host_checkpoint}[reader]
    path = str(tmp_path / "host.npz")
    a = _seq_runner(writer)
    a.train(2)
    save(path, a)
    b = _seq_runner(reader)
    load(path, b)
    assert b.learner.epoch == 2
    np.testing.assert_array_equal(b.learner.flat, a.learner.flat)
    assert len(b.strategy_handler.archive.points) == len(a.strategy_handler.archive.points)
    a.train(1)
    b.train(1)
    np.testing.assert_allclose(b.learner.flat, a.learner.flat, rtol=1e-5, atol=0)
    assert a.reporter.history[-1]["Noisy Reward"] == b.reporter.history[-1]["Noisy Reward"]
    assert a.agent.cumulative_timesteps == b.agent.cumulative_timesteps
    assert a.omega.omega == b.omega.omega


def _server_pair(kind):
    """A port and a JAX ServerRunner on the same seed, the port's seed buffer
    JAX's (its observations can be 1 ulp apart), with recorded batches:
    two epochs to train before the checkpoint and one after it."""
    from test_torch_distributed import _jax_server, _port_server, _recorded_batches

    mine, theirs = _port_server(noise_kind=kind), _jax_server(noise_kind=kind)
    mine.zeta[:] = theirs.zeta
    mine.global_obs_stats.deserialize(theirs.global_obs_stats.serialize())
    return mine, theirs, _recorded_batches(kind, mine.model.num_params)


def _replay(runner, batches, n, jax_side=False):
    import copy

    from dfd_tpu.fd.returns import FDReturn as JFDReturn
    from dfd_tpu_torch.fd.returns import FDReturn
    from test_torch_distributed import StubWorker

    cls = JFDReturn if jax_side else FDReturn
    runner.worker = StubWorker([([cls(**copy.deepcopy(r)) for r in rows], *rest)
                                for rows, *rest in batches], None)
    runner.worker.update = lambda state: None
    runner.train(max_epochs=n)


def _same_server_state(a, b, obs_rtol=0.0):
    np.testing.assert_array_equal(a.learner.flat, b.learner.flat)
    assert a.learner.epoch == b.learner.epoch
    assert a.learner.discarded_returns == b.learner.discarded_returns
    assert [e for _, e in a.learner.policy_history] == [e for _, e in b.learner.policy_history]
    for (fa, _), (fb, _) in zip(a.learner.policy_history, b.learner.policy_history):
        np.testing.assert_array_equal(fa, fb)
    assert a.omega.omega == b.omega.omega and a.omega.reward_history == b.omega.reward_history
    assert (a.policy_reward, a.policy_entropy, a.policy_novelty) == \
        (b.policy_reward, b.policy_entropy, b.policy_novelty)
    np.testing.assert_array_equal(a.zeta, b.zeta)
    np.testing.assert_allclose(np.float64(a.global_obs_stats.serialize()),
                               np.float64(b.global_obs_stats.serialize()), rtol=obs_rtol, atol=0)
    assert len(a.strategy_handler.archive.points) == len(b.strategy_handler.archive.points)
    assert a.rng.get_state()[2] == b.rng.get_state()[2]
    assert a.current_state.epoch == a.learner.epoch


@pytest.mark.parametrize("kind", ["pcg", "counter"])
def test_host_checkpoint_server_runner_resume_is_exact(kind, tmp_path):
    """A ServerRunner saved after two epochs of recorded batches, loaded by a
    fresh one: the state equals, and the next epoch of the same batch gives
    the unbroken run's flat bit for bit.  Its observation statistics agree
    to rtol 1e-6: the loaded Welford's count is a float64 (the file's), as
    in the JAX package, so its next merge runs in float64."""
    path = str(tmp_path / "server.npz")
    a, _, batches = _server_pair(kind)
    b, _, _ = _server_pair(kind)
    _replay(a, batches[:2], 2)
    checkpoint.save_host_checkpoint(path, a)
    checkpoint.load_host_checkpoint(path, b)
    _same_server_state(b, a)
    with np.load(path) as z:
        assert "obs.serialized" in z.files and "agent.last_obs" not in z.files
    _replay(a, batches[2:], 1)
    _replay(b, batches[2:], 1)
    _same_server_state(b, a, obs_rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_host_checkpoint_server_runner_crosses_packages(writer, tmp_path):
    """A ServerRunner's file from either package loads in the other: the
    learner, omega, EMAs, zeta, obs statistics, archive and RNG streams."""
    from dfd_tpu.utils.checkpoint import load_host_checkpoint as jax_load
    from dfd_tpu.utils.checkpoint import save_host_checkpoint as jax_save

    path = str(tmp_path / "server.npz")
    mine, theirs, batches = _server_pair("pcg")
    _replay(mine, batches[:2], 2)
    _replay(theirs, batches[:2], 2, jax_side=True)
    fresh_mine, fresh_theirs, _ = _server_pair("pcg")
    if writer == "jax":
        jax_save(path, theirs)
        checkpoint.load_host_checkpoint(path, fresh_mine)
        _same_server_state(fresh_mine, theirs)
    else:
        checkpoint.save_host_checkpoint(path, mine)
        jax_load(path, fresh_theirs)
        _same_server_state(fresh_theirs, mine)
