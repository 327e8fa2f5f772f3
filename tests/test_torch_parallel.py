"""The port's population mesh (``dfd_tpu_torch/parallel``) on the CPU.

A mesh of one equals no mesh bit for bit.  Two ranks are two processes of
a gloo group over localhost (``tests/_torch_mesh_worker.py``, each with its
own timeout and a free port): their ``shard_map_combine``, their trainer and
their slice-client window are held against the port's single process and,
where the JAX package runs the same case, against JAX's, at the tolerances
``tests/test_multihost.py`` names for its own pair: ranks equal each other
bit for bit, ``flat`` within rtol 1e-5 and atol 1e-6, rewards within rtol
1e-5, timesteps equal.  A rank's rollouts run in batches of P / 2 rather
than P, whose products may round otherwise, hence tolerances.
"""

import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_mesh_worker import SLICE_CFG, combine_inputs, slice_state
from _torch_port import METRICS, jax_epoch_draws, jax_state_numpy
from dfd_tpu_torch.config import TrainConfig
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import TrapEnv
from dfd_tpu_torch.models import DiscreteMLP
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.ops import perturb as pk
from dfd_tpu_torch.parallel import (PopMesh, initialize_multihost, make_pop_mesh, pop_sharding,
                                    replicated)
from dfd_tpu_torch.runners import VectorizedTrainer
from dfd_tpu_torch.utils.metrics import EpochReporter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
CPU = "cpu"
# tests/_multihost_trainer_worker.py:45-54's config
MULTIHOST = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=8,
                 max_strategy_history_size=4, random_seed=7, normalize_obs=True,
                 obs_stats_update_chance=0.1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(argv_of, timeout=240, env=None):
    """Start rank 0 and rank 1 (``argv_of(rank)``), wait for both; their logs."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv_of(r), cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _workers(mode, tmp_path, args=None, suffix=""):
    port = _free_port()
    outs = [str(tmp_path / f"{mode}{r}{suffix}") for r in range(2)]
    _two_ranks(lambda r: [sys.executable, WORKER, mode, str(r), str(port), outs[r],
                          json.dumps(args or {})])
    return outs


def _trainer(cfg_kw, mesh=None, draws=None, state=None):
    tr = VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                           distances.categorical_tvd, TrainConfig(**cfg_kw), mesh=mesh,
                           reporter=EpochReporter(quiet=True), device=CPU,
                           draw_source=None if draws is None else draws.__getitem__)
    if state is not None:
        tr.state = train_state_from_numpy(state, CPU)
    return tr


# -- the mesh's pieces --------------------------------------------------------------


def test_mesh_of_one_without_a_process_group():
    mesh = make_pop_mesh(CPU)
    assert (mesh.rank, mesh.size, mesh.shape, str(mesh.device)) == (0, 1, {"pop": 1}, "cpu")
    assert pop_sharding(mesh, 8) == range(8) == replicated(mesh, 8)
    initialize_multihost("127.0.0.1:1", 1, 0, device=CPU)  # one process: a no-op
    assert not torch.distributed.is_initialized()
    two = PopMesh(CPU, None, rank=1, size=2)
    assert pop_sharding(two, 8) == range(4, 8) and replicated(two, 8) == range(8)
    with pytest.raises(ValueError, match="must divide over the mesh"):
        pop_sharding(two, 7)


@pytest.mark.parametrize("cfg_kw, message", [
    (dict(batch_size=9), "must divide over the mesh"),
    (dict(batch_size=8, population_chunk=3), "population_chunk must divide"),
    (dict(batch_size=10, antithetic=True), "antithetic pairs must not straddle ranks"),
])
def test_trainer_on_a_mesh_refuses_shards_it_cannot_cut(cfg_kw, message):
    """The checks run before any collective: a rank of a 2-rank mesh object
    without a group raises where the population, a chunk or an antithetic
    pair does not divide over the ranks."""
    with pytest.raises(ValueError, match=message):
        _trainer(dict(MULTIHOST, **cfg_kw), mesh=PopMesh(CPU, None, rank=0, size=2))
    with pytest.raises(ValueError, match="the mesh's rank lives on"):
        VectorizedTrainer(DiscreteMLP(2, 9, device=CPU), TrapEnv(device=CPU),
                          distances.categorical_tvd, TrainConfig(**MULTIHOST),
                          mesh=PopMesh("meta"), device=CPU)


@pytest.mark.parametrize("antithetic", [False, True])
def test_noise_from_a_first_member_is_the_stream_from_there(antithetic):
    """perturb's and combine's plain versions from member ``first`` equal
    the rows of the whole population's from 0: what a rank's shard runs."""
    d, P, first = 777, 12, 6
    flat = torch.from_numpy(np.random.RandomState(0).randn(d).astype(np.float32))
    whole = pk.perturb(flat, 0.1, 9, 4, first + P, antithetic=antithetic)
    part = pk.perturb(flat, 0.1, 9, 4, P, antithetic=antithetic, first=first)
    assert torch.equal(part, whole[first:])
    coefs = torch.from_numpy(np.random.RandomState(1).randn(first + P).astype(np.float32))
    g = pk.combine(coefs[first:], 9, 4, d, antithetic=antithetic, first=first)
    want = coefs[first:] @ pk.noise_plain(9, 4, first + P, d, antithetic)[first:]
    assert torch.equal(g, want)
    if antithetic:
        with pytest.raises(ValueError, match="even under antithetic"):
            pk.perturb(flat, 0.1, 9, 4, P, antithetic=True, first=3)


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(population_chunk=4),
    dict(noise_backend="pallas"),
    dict(noise_backend="pallas", antithetic=True, normalize_obs=False),
], ids=["jax", "jax-chunked", "pallas", "pallas-antithetic"])
def test_mesh_of_one_equals_no_mesh_bit_for_bit(cfg_kw):
    runs = []
    for mesh in (None, make_pop_mesh(CPU)):
        tr = _trainer(dict(MULTIHOST, **cfg_kw), mesh=mesh)
        tr.train(3)
        runs.append(tr)
    plain, meshed = runs
    assert meshed.members == range(8) and meshed.chunk == plain.chunk
    assert torch.equal(meshed.state.flat, plain.state.flat)
    assert all(torch.equal(a, b) for a, b in zip(meshed.state.obs_stats, plain.state.obs_stats))
    for a, b in zip(meshed.reporter.history, plain.reporter.history):
        assert {k: a[k] for k in METRICS} == {k: b[k] for k in METRICS}
    assert meshed.cumulative_timesteps == plain.cumulative_timesteps


def test_gloo_group_of_one_equals_no_mesh_bit_for_bit():
    """In a one-rank gloo group the collectives run (the gather's sum and
    the combine's all-reduce over one rank) and change no bit."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_pop_mesh(CPU)
        assert mesh.group is not None and mesh.size == 1
        runs = []
        for m in (None, mesh):
            tr = _trainer(dict(MULTIHOST, population_chunk=4), mesh=m)
            tr.train(2)
            runs.append(tr)
        assert torch.equal(runs[0].state.flat, runs[1].state.flat)
        assert all(torch.equal(a, b) for a, b in zip(runs[0].state.obs_stats,
                                                     runs[1].state.obs_stats))
    finally:
        dist.destroy_process_group()


# -- two ranks over gloo ---------------------------------------------------------------


def test_shard_map_combine_two_processes(tmp_path):
    """tests/test_multihost.py:114-122's case: each rank combines its 8 of
    16 members and the d-vector is summed; against the port's dense
    combine and JAX's ``combine_gradient`` on JAX's noise."""
    import jax.numpy as jnp

    from dfd_tpu.core.noise import CounterNoise as JCounterNoise
    from dfd_tpu.fd.combine import combine_gradient as jcombine
    from dfd_tpu_torch.core.noise import CounterNoise
    from dfd_tpu_torch.fd.combine import combine_gradient

    outs = _workers("combine", tmp_path)
    D, P, sigma, epoch, fitness = combine_inputs()
    dense = combine_gradient(CounterNoise(D, random_seed=0, device=CPU).generate_block(
        epoch, range(P)), torch.from_numpy(fitness), sigma).numpy()
    jeps = JCounterNoise(D, random_seed=0).generate_block(epoch, jnp.arange(P))
    jax_g = np.asarray(jcombine(jeps, jnp.asarray(fitness), sigma))
    got = [np.load(o + ".npy") for o in outs]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], dense, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], jax_g, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_run(epochs):
    """JAX's trainer on its 8-device CPU mesh for ``epochs`` of the
    ``MULTIHOST`` config: (its initial state as numpy, each epoch's draws
    rebuilt from its key chain, the trainer after the epochs); run once for
    every case."""
    from dfd_tpu.config import TrainConfig as JTrainConfig
    from dfd_tpu.envs.trap import TrapEnv as JTrapEnv
    from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
    from dfd_tpu.ops import distances as jdist
    from dfd_tpu.parallel import make_pop_mesh as jax_mesh
    from dfd_tpu.runners.vectorized import VectorizedTrainer as JTrainer
    from dfd_tpu.utils.metrics import EpochReporter as JReporter

    jtr = JTrainer(JDiscreteMLP(2, 9), JTrapEnv(), jdist.categorical_tvd,
                   JTrainConfig(**MULTIHOST), mesh=jax_mesh(), reporter=JReporter(quiet=True))
    assert jtr.mesh.devices.size == 8
    state = jax_state_numpy(jtr.state)
    draws = {}
    for e in range(epochs):
        draws[e] = tuple(x.numpy() for x in jax_epoch_draws(jtr, TrapEnv(device=CPU)))
        jtr.train(1)
    return state, draws, jtr


@pytest.mark.parametrize("case", ["jax", "chunk-inside-a-shard", "pallas"])
def test_two_process_trainer(case, tmp_path):
    """The whole trainer over 2 gloo ranks for 3 epochs of
    tests/_multihost_trainer_worker.py's config, on JAX's draws and initial
    state: both ranks equal bit for bit; held to the port's single process
    and, on the default backend, to JAX's trainer on its 8-device mesh."""
    epochs = 3
    cfg_kw = dict(MULTIHOST, **{"jax": {}, "chunk-inside-a-shard": dict(population_chunk=2),
                                "pallas": dict(noise_backend="pallas")}[case])
    state, draws, jtr = _jax_run(epochs)
    inputs = str(tmp_path / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({"state": state, "draws": draws}, f)
    timed = case == "pallas"  # its collectives timed: the same bits, their seconds kept
    outs = _workers("trainer", tmp_path, dict(inputs=inputs, cfg=cfg_kw, epochs=epochs,
                                             timed=timed), suffix=".npz")
    got = [np.load(o) for o in outs]
    assert all((g["seconds"] > 0).all() == timed for g in got)
    assert list(got[0]["members"]) == list(range(4)) and list(got[1]["members"]) == [4, 5, 6, 7]
    for k in ("flat", "noisy", "policy", "timesteps"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)

    from dfd_tpu_torch.runners import EpochDraws

    single = _trainer(cfg_kw, draws={e: EpochDraws(*(torch.from_numpy(x) for x in d))
                                     for e, d in draws.items()}, state=state)
    single.train(epochs)
    refs = [("the port's single process", single.state.flat.numpy(),
             [r["Noisy Reward"] for r in single.reporter.history],
             [r["Policy Reward"] for r in single.reporter.history], single.cumulative_timesteps)]
    if case == "jax":
        refs.append(("JAX's 8-device mesh", np.asarray(jtr.state.flat),
                     [r["Noisy Reward"] for r in jtr.reporter.history],
                     [r["Policy Reward"] for r in jtr.reporter.history],
                     jtr.cumulative_timesteps))
    for name, flat, noisy, policy, timesteps in refs:
        np.testing.assert_allclose(got[0]["flat"], flat, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[0]["noisy"], noisy, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[0]["policy"], policy, rtol=1e-5, err_msg=name)
        assert int(got[0]["timesteps"]) == timesteps, name


def test_slice_client_window_over_two_processes(tmp_path):
    """``client --mode slice --mesh``'s window: rank 0 broadcasts its cfg,
    state and window, each rank evaluates 4 of the 8 members with its own
    eval member, the results gathered to rank 0; its returns against one
    process's window on the same state (the trap's integer rewards equal)."""
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner

    outs = _workers("slice", tmp_path, dict(P=8, chunk=2))
    got = [pickle.load(open(o, "rb")) for o in outs]
    assert got[1] is True  # rank 1 followed until rank 0 released it
    one = SliceClientRunner(n_members=8, device=CPU)
    one._configure(SLICE_CFG)
    one._apply_state(slice_state())
    one.windows = 1
    want = one._collect_window()
    assert len(got[0]) == len(want) == 9
    for g, w in zip(got[0], want):
        assert (g.encoded_noise, g.is_eval, g.timesteps, g.epoch, g.reward) == \
            (w.encoded_noise, w.is_eval, w.timesteps, w.epoch, w.reward)
        np.testing.assert_allclose([g.entropy, g.novelty], [w.entropy, w.novelty], rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(got[0][0].obs_stats_update, want[0].obs_stats_update, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[0][-1].eval_states),
                                  np.asarray(want[-1].eval_states))


def test_cli_train_mesh_under_a_two_process_launch(tmp_path):
    """``train --mesh --device cpu`` as torchrun starts it (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): both ranks end on
    the same report, rank 0 alone writes the checkpoint, and the report
    matches one process's ``train`` of the same flags."""
    port = _free_port()
    flags = ["train", "--mesh", "--env", "SimpleTrapEnv-v0", "--epochs", "2", "--batch-size",
             "8", "--zeta-size", "8", "--history-size", "4", "--quiet", "--device", "cpu"]

    def argv(rank):
        return [sys.executable, "-m", "dfd_tpu_torch", *flags,
                "--checkpoint", str(tmp_path / f"c{rank}.npz")]

    procs, logs = [], []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv(r), cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    report = lambda log: [x for x in log.splitlines() if x.startswith("{'Epoch'")][-1]
    reports = [report(log) for log in logs]
    assert reports[0] == reports[1] and "'Epoch': 2" in reports[0], logs
    assert os.path.exists(tmp_path / "c0.npz") and not os.path.exists(tmp_path / "c1.npz")
    one = subprocess.run([sys.executable, "-m", "dfd_tpu_torch", *flags[:1], *flags[2:]],
                         cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    want = eval(report(one.stdout))  # the report dict's repr
    got = eval(reports[0])
    assert got["Epoch"] == want["Epoch"]
    np.testing.assert_allclose([got["Noisy Reward"], got["Policy Reward"]],
                               [want["Noisy Reward"], want["Policy Reward"]], rtol=1e-5)
