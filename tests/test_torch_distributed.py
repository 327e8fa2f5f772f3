"""The elastic topology of the port (``dfd_tpu_torch.distributed`` and the
server, thin, fat and slice client runners) held against the JAX package's
on the CPU, over localhost.

- The wire: the bytes of a state broadcast and of a batch of returns equal
  JAX's, and each package decodes the other's.
- The server's return queue and seed minting equal JAX's on the same
  inputs; the client's four status flags.
- ``ServerRunner``: its first broadcast equals JAX's (the experiment id
  aside), and three epochs of recorded batches, replayed through a stub
  worker, give JAX's ``flat`` (exactly for PCG noise, a numpy stream; to
  rtol 1e-5 for counter noise, JAX's threefry normals drawn in another
  order of float32 operations), omega, the EMAs and the reporter rows.
- One slice window and one fat window equal JAX's on the same window key,
  their draws rebuilt from JAX's keys: rewards, timesteps and encodings
  exact, entropies, novelties and the Welford deltas to rtol 1e-5.
- A port client trains against a JAX learner and a JAX client against a
  port learner; the port's thin, fat and slice clients train end to end,
  and a thin client survives a server crash.

The live runs are not deterministic (which returns land in which batch is
timing), so they are checked for what timing cannot change: every counter
return decodes, the reporter's rows are finite, every thread ends.
"""

import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_window_draws
from dfd_tpu.distributed import wire as jwire
from dfd_tpu.distributed.server import ServerInterface as JServerInterface
from dfd_tpu.fd.returns import FDReturn as JFDReturn
from dfd_tpu.fd.returns import FDState as JFDState
from dfd_tpu_torch.distributed import FDClient, FDServer, wire
from dfd_tpu_torch.distributed.server import ServerInterface
from dfd_tpu_torch.fd.returns import FDReturn, FDState
from dfd_tpu_torch.utils.metrics import EpochReporter
from test_torch_host_evaluator import jax_action_noise

CPU = "cpu"
torch.set_num_threads(1)  # the suite runs under xdist: one thread per worker


def _state(cls=FDState, epoch=0, experiment="exp1", cfg=None):
    return cls(
        strategy_frames=np.random.RandomState(0).rand(4, 2).astype(np.float32),
        strategy_history=np.random.RandomState(1).rand(3, 4, 9).astype(np.float32),
        policy_params=np.random.RandomState(2).rand(100).astype(np.float32).tolist(),
        epoch=epoch,
        experiment_id=experiment,
        obs_stats=[0.25, 0.5, 1.5, 2.5, 7],
        cfg=cfg or {"env_id": "SimpleTrapEnv-v0", "random_seed": 7},
    )


def _returns(cls=FDReturn):
    rng = np.random.RandomState(3)
    return [
        cls(epoch=3, encoded_noise="123,456", reward=1.5, novelty=0.2, entropy=0.8,
            timesteps=201),
        cls(epoch=2, encoded_noise="0", reward=-2.0, is_eval=True, timesteps=12,
            eval_states=rng.rand(5, 2).astype(np.float32), obs_stats_update=[1.0, 2.0, 3.0]),
        cls(epoch=3, encoded_noise="987654321,12345", reward=np.float32(0.1),
            novelty=np.float64(3.25), entropy=2.0, timesteps=np.int64(7),
            obs_stats_update=list(rng.rand(4)) + [3]),
    ]


# -- the wire ---------------------------------------------------------------------


def test_wire_bytes_equal_jax_and_decode_across():
    ours, theirs = _state(), _state(JFDState)
    data = wire.encode_state(ours)
    assert data == jwire.encode_state(theirs)
    rets, jrets = _returns(), _returns(JFDReturn)
    batch = wire.encode_returns(rets)
    assert batch == jwire.encode_returns(jrets)
    # each package decodes the other's bytes
    for decode, want in ((wire.decode_state, ours), (jwire.decode_state, theirs)):
        got = decode(data, cfg=want.cfg)
        np.testing.assert_array_equal(got.policy_params, np.float32(want.policy_params))
        np.testing.assert_array_equal(got.strategy_history, want.strategy_history)
        assert got.policy_params.dtype == np.float32
        assert (got.epoch, got.experiment_id, got.obs_stats) == (0, "exp1", want.obs_stats)
    for decode in (wire.decode_returns, jwire.decode_returns):
        got = decode(batch)
        assert [r.encoded_noise for r in got] == [r.encoded_noise for r in rets]
        assert [r.timesteps for r in got] == [201, 12, 7]
        assert got[1].is_eval and got[1].eval_states.dtype == np.float32
        np.testing.assert_array_equal(got[1].eval_states, rets[1].eval_states)
        np.testing.assert_array_equal(got[2].obs_stats_update, rets[2].obs_stats_update)


def test_wire_refuses_a_tensor():
    with pytest.raises(TypeError, match="unserializable"):
        wire.dumps({"x": torch.zeros(3)})
    ret = FDReturn(epoch=0, encoded_noise=torch.tensor(5), reward=1.0)
    with pytest.raises(TypeError, match="unserializable"):
        wire.encode_returns([ret])


def test_no_fallback_without_the_wire_packages():
    """Without grpc or msgpack the port's distributed modules raise on import
    (no stand-in wire)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, sys\n"
        "for missing in ('grpc', 'msgpack'):\n"
        "    for m in [m for m in sys.modules if m.startswith('dfd_tpu_torch')]:\n"
        "        del sys.modules[m]\n"
        "    real, sys.modules[missing] = sys.modules.get(missing), None\n"
        "    try:\n"
        "        importlib.import_module('dfd_tpu_torch.runners.server')\n"
        "        print(missing, 'imported')\n"
        "    except ImportError as exc:\n"
        "        print(missing, 'raised:', exc)\n"
        "    sys.modules.pop(missing)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.splitlines() == [f"{m} raised: import of {m} halted; None in sys.modules"
                                       for m in ("grpc", "msgpack")], out.stdout


# -- the server's queue and seeds ---------------------------------------------------


def _queue(cls):
    """Returns of epochs 0-6 in submission order (LIFO pops the last first),
    with two eval returns riding along."""
    epochs = [6, 0, 5, 6, 2, 6, 1, 4, 6, 3, 6, 6]
    return [cls(epoch=e, encoded_noise=f"{e},{i}", reward=float(i), timesteps=10 + i,
                is_eval=i in (4, 9)) for i, e in enumerate(epochs)]


@pytest.mark.parametrize("max_delayed", [None, 0, 2, 5])
def test_get_returns_batch_matches_jax(max_delayed):
    """LIFO order and the delayed/discarded counts equal JAX's on the same
    queue, batch after batch until it is empty."""
    mine, theirs = ServerInterface(_state()), JServerInterface(_state(JFDState))
    mine.submit_returns(_queue(FDReturn))
    theirs.submit_returns(_queue(JFDReturn))
    seen = 0
    while True:
        with theirs._lock:  # non-eval returns the next batch may keep
            left = sum(not r.is_eval and (max_delayed is None or 6 - r.epoch <= max_delayed)
                       for r in theirs._returns)
        if left < 3:
            break
        got = mine.get_returns_batch(batch_size=3, current_epoch=6, max_delayed_return=max_delayed)
        want = theirs.get_returns_batch(batch_size=3, current_epoch=6,
                                        max_delayed_return=max_delayed)
        assert [r.encoded_noise for r in got[0]] == [r.encoded_noise for r in want[0]]
        assert got[1:] == want[1:]
        seen += 1
    assert seen >= 2
    assert len(mine._returns) == len(theirs._returns)


def test_config_for_client_mints_seeds_as_jax_does():
    mine, theirs = ServerInterface(_state()), JServerInterface(_state(JFDState))
    for _ in range(3):
        assert mine.config_for_client() == theirs.config_for_client()
    assert mine.config_for_client()["random_seed"] == 11
    # a new experiment takes its own cfg; a new epoch of the same one does not
    mine.update(_state(epoch=1, cfg={"env_id": "x", "random_seed": 100}))
    assert mine.config_for_client()["random_seed"] == 12
    mine.update(_state(experiment="exp2", cfg={"env_id": "x", "random_seed": 100}))
    assert mine.config_for_client()["random_seed"] == 101


# -- the client's flags -------------------------------------------------------------


def test_server_client_protocol():
    server = FDServer(_state(epoch=0))
    port = server.start(port=0)
    try:
        client = FDClient()
        client.connect(port=port)
        assert client.get_server_state() == FDClient.NEW_EXPERIMENT_FLAG
        assert client.current_state.cfg["env_id"] == "SimpleTrapEnv-v0"
        seed1 = client.current_state.cfg["random_seed"]
        client2 = FDClient()
        client2.connect(port=port)
        assert client2.get_server_state() == FDClient.NEW_EXPERIMENT_FLAG
        assert client2.current_state.cfg["random_seed"] == seed1 + 1
        assert client.get_server_state() == FDClient.OPERATION_SUCCESSFUL_FLAG
        server.update(_state(epoch=1))
        assert client.get_server_state() == FDClient.NEW_STATE_FLAG
        assert client.current_state.epoch == 1
        assert client.submit_returns([
            FDReturn(epoch=1, encoded_noise="a", reward=1.0, timesteps=10),
            FDReturn(epoch=0, encoded_noise="b", reward=2.0, timesteps=10),
            FDReturn(epoch=1, encoded_noise="c", reward=3.0, timesteps=10, is_eval=True),
        ]) == FDClient.OPERATION_SUCCESSFUL_FLAG
        rets, ts, n_delayed, n_discarded = server.get_returns_batch(
            batch_size=2, current_epoch=1, max_delayed_return=5)
        assert (ts, n_delayed, n_discarded, len(rets)) == (30, 1, 0, 3)
        server.update(_state(epoch=1, experiment="exp2"))
        assert client.get_server_state() == FDClient.NEW_EXPERIMENT_FLAG
        client.disconnect()
        client2.disconnect()
    finally:
        server.stop(grace=0)


def test_client_rpc_failure_flag():
    client = FDClient()
    client.connect(port=1)  # nothing listening
    assert client.get_server_state() == FDClient.RPC_FAILED_FLAG
    client.disconnect()


# -- ServerRunner against JAX's, on recorded batches --------------------------------


def _server_kw(**kw):
    return dict(dict(env_id="SimpleTrapEnv-v0", batch_size=4, zeta_size=4,
                     max_strategy_history_size=4, normalize_obs=True, random_seed=5, port=0,
                     timestep_limit=10_000_000, learning_rate=0.05, noise_std=0.05,
                     reporter=EpochReporter(quiet=True)), **kw)


def _port_server(**kw):
    from dfd_tpu_torch.runners.server import ServerRunner

    return ServerRunner(**_server_kw(**kw), device=CPU)


def _jax_server(**kw):
    from dfd_tpu.runners.server import ServerRunner

    return ServerRunner(**_server_kw(**kw))


@pytest.mark.parametrize("env_id", ["SimpleTrapEnv-v0", "PixelGridSmall-v0"])
def test_server_runner_first_broadcast_equals_jax(env_id):
    """The same seed gives the same first broadcast: the parameters exact;
    zeta (the seed buffer's observations) within 1 ulp and the observation
    statistics over it to rtol 1e-5 (the trap env's observation is a float32
    division that XLA's CPU code rounds one ulp off in places, as the trainer
    tests allow); with those two fields and the experiment id (a uuid) taken
    from JAX's, the broadcast's bytes equal JAX's; the wire cfg is JAX's."""
    mine, theirs = _port_server(env_id=env_id), _jax_server(env_id=env_id)
    ours, their = mine.current_state, theirs.current_state
    np.testing.assert_allclose(ours.strategy_frames, their.strategy_frames, rtol=1.2e-7, atol=0)
    np.testing.assert_allclose(ours.obs_stats, their.obs_stats, rtol=1e-5, atol=0)
    assert ours.obs_stats[-1] == their.obs_stats[-1]
    same = copy.copy(ours)
    same.strategy_frames, same.obs_stats = their.strategy_frames, their.obs_stats
    same.experiment_id = their.experiment_id
    assert wire.encode_state(same) == jwire.encode_state(their)
    assert ours.cfg == their.cfg


class StubWorker:
    """The worker of a ServerRunner replaying recorded batches: its
    ``collect_returns`` hands them out in order; ``update`` keeps each
    broadcast's decoded state; ``start`` and ``stop`` do nothing."""

    def __init__(self, batches, wire_module):
        self.batches, self.wire, self.broadcasts = list(batches), wire_module, []

    def collect_returns(self, batch_size=None, current_epoch=None, max_delayed_return=None):
        return self.batches.pop(0)

    def update(self, state):
        self.broadcasts.append(self.wire.decode_state(self.wire.encode_state(state)))

    def start(self, address, port):
        return 0

    def stop(self):
        pass


def _recorded_batches(kind, d, obs_dim=2, zeta=4, n_epochs=3, batch=4):
    """Three epochs' batches (rets, timesteps, n_delayed, n_discarded): each
    epoch ``batch`` fresh returns and one eval return; epoch 1 adds a stale
    return of epoch 0 (drift-corrected), epoch 2 one of epoch -40, older
    than the learner's history (discarded), and one counted as discarded by
    the queue."""
    from dfd_tpu_torch.core.noise import RNGNoiseSource

    rng = np.random.RandomState(17)
    pcg = RNGNoiseSource(d, random_seed=99)
    member = [1000]

    def noise(epoch):
        if kind == "pcg":
            return pcg.sample()[0]
        member[0] += 1
        return f"{epoch},{member[0]}"

    def ret(epoch, **kw):
        stats = (list(rng.rand(obs_dim)) + list(rng.rand(obs_dim)) + [int(rng.randint(1, 5))]
                 if rng.rand() < 0.5 else [])
        return dict(epoch=epoch, encoded_noise=noise(epoch), reward=float(rng.randn() * 10),
                    novelty=float(rng.rand()), entropy=float(rng.rand()),
                    timesteps=int(rng.randint(10, 200)), obs_stats_update=stats, **kw)

    out = []
    for e in range(n_epochs):
        rows = [ret(e) for _ in range(batch)]
        rows.append(ret(e, is_eval=True, eval_states=rng.rand(3, obs_dim).astype(np.float32)))
        n_delayed = 0
        if e == 1:
            rows.insert(2, ret(0))
            n_delayed = 1
        if e == 2:
            rows.insert(1, ret(-40))
            n_delayed = 1
        out.append((rows, sum(r["timesteps"] for r in rows), n_delayed, int(e == 2)))
    return out


@pytest.mark.parametrize("kind", ["pcg", "counter"])
def test_server_runner_epochs_on_recorded_batches_match_jax(kind):
    mine = _port_server(noise_kind=kind)
    theirs = _jax_server(noise_kind=kind)
    batches = _recorded_batches(kind, mine.model.num_params)
    # start from JAX's seed buffer (its observations can be 1 ulp apart)
    mine.zeta[:] = theirs.zeta
    mine.global_obs_stats.deserialize(theirs.global_obs_stats.serialize())
    mine.current_state.obs_stats = theirs.current_state.obs_stats
    for runner, cls, wmod in ((mine, FDReturn, wire), (theirs, JFDReturn, jwire)):
        runner.worker = StubWorker(
            [([cls(**copy.deepcopy(r)) for r in rows], *rest) for rows, *rest in batches], wmod)
        runner.train(max_epochs=3)
    flat_tol = dict(rtol=0, atol=0) if kind == "pcg" else dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mine.learner.flat, theirs.learner.flat, **flat_tol)
    assert mine.learner.epoch == theirs.learner.epoch == 3
    assert mine.learner.discarded_returns == theirs.learner.discarded_returns == 2
    assert mine.omega.omega == theirs.omega.omega
    assert mine.omega.reward_history == theirs.omega.reward_history
    assert (mine.policy_reward, mine.policy_entropy, mine.policy_novelty) == \
        (theirs.policy_reward, theirs.policy_entropy, theirs.policy_novelty)
    np.testing.assert_array_equal(mine.zeta, theirs.zeta)
    assert mine.global_obs_stats.serialize() == theirs.global_obs_stats.serialize()
    assert len(mine.reporter.history) == len(theirs.reporter.history) == 3
    for got, want in zip(mine.reporter.history, theirs.reporter.history):
        keys = {k for k in want if k != "Epoch Time" and not k.startswith("_stage/")}
        assert keys <= set(got)
        for k in keys:
            if k == "Update Magnitude" and kind == "counter":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
            else:
                assert got[k] == want[k], k
    # every broadcast: the parameters as the flats, the archive's strategies
    # (forwards of the two models) to rtol 1e-5, the rest exact
    b_mine, b_theirs = mine.worker.broadcasts, theirs.worker.broadcasts
    assert len(b_mine) == len(b_theirs) == 4
    for g, w in zip(b_mine, b_theirs):
        np.testing.assert_allclose(g.policy_params, w.policy_params, **flat_tol)
        np.testing.assert_allclose(g.strategy_history, w.strategy_history, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(g.strategy_frames, w.strategy_frames)
        assert (g.epoch, g.obs_stats) == (w.epoch, w.obs_stats)


# -- the slice and fat clients' windows ---------------------------------------------


SLICE_CFG = dict(noise_kind="counter", random_seed=7, noise_std=0.05, normalize_obs=True,
                 obs_stats_update_chance=0.5, max_strategy_history_size=4, noise_seed=123,
                 eval_prob=1.0, antithetic=False)


def _broadcast(model, env_obs_shape, F, seed=3, Z=4, count=2):
    """A state broadcast for a model: its init at ``seed``, Z random zeta
    frames, ``count`` random archived strategies, sampled obs stats."""
    from dfd_tpu.core.welford import Welford as JWelford

    params, bn = model.init(seed)
    rng = np.random.RandomState(0)
    stats = JWelford(tuple(env_obs_shape))
    for _ in range(6):
        stats.update(rng.rand(*env_obs_shape))
    return JFDState(
        policy_params=np.asarray(model.serialize(params, bn, xp=np)).tolist(),
        strategy_frames=rng.rand(Z, *env_obs_shape).astype(np.float32),
        strategy_history=rng.rand(count, Z, F).astype(np.float32),
        obs_stats=stats.serialize(), epoch=2, experiment_id="e", cfg=None)


def _same_window(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.encoded_noise, g.is_eval, g.timesteps, g.epoch) == \
            (w.encoded_noise, w.is_eval, w.timesteps, w.epoch)
        assert g.reward == w.reward
        np.testing.assert_allclose(g.entropy, w.entropy, rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(g.novelty, w.novelty, rtol=rtol, atol=1e-7)
        assert len(g.obs_stats_update) == len(w.obs_stats_update)
        np.testing.assert_allclose(g.obs_stats_update, w.obs_stats_update, rtol=rtol, atol=1e-6)
    # the eval episode's observations, within the trap observation's 1 ulp
    np.testing.assert_allclose(np.asarray(got[-1].eval_states), np.asarray(want[-1].eval_states),
                               rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("env_id, P, chunk", [("SimpleTrapEnv-v0", 6, None),
                                              ("SimpleTrapEnv-v0", 8, 4),
                                              ("PixelGridSmall-v0", 3, None)])
def test_slice_window_matches_jax(env_id, P, chunk):
    """One window of each package's slice client at the same window key (the
    second, so the key chain is walked): the port's draws rebuilt from the
    window sub-key it hands its draw source."""
    from dfd_tpu.runners.slice_client import SliceClientRunner as JSlice
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner

    cfg = dict(SLICE_CFG, env_id=env_id)
    theirs = JSlice(n_members=P, population_chunk=chunk)
    theirs._configure(cfg)
    env, model = theirs.env, theirs.model
    F = model.output_shape if model.discrete else 2 * model.output_shape
    state = _broadcast(model, env.obs_shape, F)
    subs = []

    def draws(sub, ids):
        subs.append(np.asarray(sub))
        return jax_window_draws(sub, ids, env.max_episode_steps, mine.env)

    mine = SliceClientRunner(n_members=P, population_chunk=chunk, device=CPU, draw_source=draws)
    mine._configure(cfg)
    for r in (mine, theirs):
        r._apply_state(state)
        r.windows = 1
        r._collect_window()  # the first window moves the key chain
        r.windows = 2
    want = theirs._collect_window()
    got = mine._collect_window()
    _, sub = jax.random.split(jax.random.split(jax.random.key(7))[0])
    np.testing.assert_array_equal(subs[-1], np.asarray(jax.random.key_data(sub)))
    _same_window(got, want)
    assert got[0].obs_stats_update and min(r.novelty for r in got[:-1]) > 0


def test_slice_chunked_window_equals_dense():
    from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner

    state = _broadcast(JDiscreteMLP(2, 9), (2,), 9)
    out = []
    for chunk in (None, 2, 4):
        r = SliceClientRunner(n_members=8, population_chunk=chunk, device=CPU)
        r._configure(dict(SLICE_CFG, env_id="SimpleTrapEnv-v0"))
        r._apply_state(state)
        r.windows = 1
        out.append((r._collect_window(), r.chunks()))
    (dense, n1), (by2, n4), (by4, n2) = out
    assert (n1, n4, n2) == (1, 4, 2)
    for other, _ in out[1:]:
        _same_window(other, dense, rtol=1e-6)


def test_slice_client_on_a_mesh_of_one_equals_no_mesh():
    """``mesh=`` a mesh of one: the client lives on the mesh's device and
    its window equals the meshless client's, return for return; a chunk
    that does not divide the shard is refused either way.  Two ranks:
    ``tests/test_torch_parallel.py``."""
    from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
    from dfd_tpu_torch.parallel import make_pop_mesh
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner

    state = _broadcast(JDiscreteMLP(2, 9), (2,), 9)
    out = []
    for mesh in (None, make_pop_mesh(CPU)):
        r = SliceClientRunner(n_members=8, population_chunk=4, mesh=mesh, device=CPU)
        assert str(r.device) == CPU and r.chunks() == 2
        r._configure(dict(SLICE_CFG, env_id="SimpleTrapEnv-v0"))
        r._apply_state(state)
        r.windows = 1
        out.append(r._collect_window())
    _same_window(out[1], out[0], rtol=0)
    for mesh in (None, make_pop_mesh(CPU)):
        with pytest.raises(ValueError):
            SliceClientRunner(n_members=8, population_chunk=3, mesh=mesh, device=CPU)


def test_stale_shard_drift_correction_oracle():
    """JAX's oracle on the port's learner and noise: a shard tagged epoch
    k - Delta is corrected to sigma * eps(k - Delta, m) + (theta_hist -
    theta_now), eps JAX's own within the normal's 4e-6."""
    from dfd_tpu.core.noise import CounterNoise as JCounterNoise
    from dfd_tpu_torch.core.noise import CounterNoise
    from dfd_tpu_torch.fd import AdaptiveOmega, DSGD, FDLearner

    d, sigma = 40, 0.1
    rng = np.random.RandomState(0)
    learner = FDLearner(rng.randn(d).astype(np.float32), DSGD(d, lr=0.05), AdaptiveOmega(),
                        CounterNoise(d, random_seed=9, device=CPU), noise_std=sigma,
                        max_delayed_return=5)
    history = {0: learner.flat.copy()}
    for epoch in range(3):
        rets = [FDReturn(epoch=epoch, encoded_noise=f"{epoch},{m}", reward=float(rng.randn()),
                         timesteps=10) for m in range(6)]
        assert learner.step(rets, 0.0, 0.0, 0.0) > 0
        history[learner.epoch] = learner.flat.copy()
    stale = FDReturn(epoch=1, encoded_noise="1,777", reward=1.0, timesteps=10)
    fresh = [FDReturn(epoch=3, encoded_noise=f"3,{m}", reward=float(rng.randn()), timesteps=10)
             for m in range(3)]
    theta_now = learner.flat.copy()
    assert learner.step([stale] + fresh, 0.0, 0.0, 0.0) > 0
    assert learner.discarded_returns == 0
    eps = np.asarray(JCounterNoise(d, random_seed=9).generate(1, 777))
    np.testing.assert_allclose(stale.perturbation, eps * sigma + (history[1] - theta_now),
                               rtol=1e-5, atol=1e-6)
    too_old = FDReturn(epoch=-3, encoded_noise="-3,1", reward=1.0, timesteps=10)
    learner.step([too_old] + [FDReturn(epoch=4, encoded_noise=f"4,{m}",
                                       reward=float(rng.randn()), timesteps=10)
                              for m in range(3)], 0.0, 0.0, 0.0)
    assert learner.discarded_returns == 1


def test_fat_window_matches_jax():
    """One fat window (6 members on the native trap pool, two lanes, and the
    eval episode) of each package at the same window key, the port's action
    noise JAX's Gumbel draws under the window sub-key."""
    from dfd_tpu.runners.fat_client import FatClientRunner as JFat
    from dfd_tpu_torch.runners.fat_client import FatClientRunner

    cfg = dict(SLICE_CFG, env_id="SimpleTrapEnv-v0", obs_stats_update_chance=0.3)
    theirs = JFat(n_envs=6, pipeline_lanes=2, env_backend="serial")
    mine = FatClientRunner(
        n_envs=6, pipeline_lanes=2, env_backend="serial", device=CPU,
        action_noise_source=lambda sub: jax_action_noise(
            jax.random.wrap_key_data(np.asarray(sub, np.uint32)), 201, 9))
    from dfd_tpu.models import DiscreteMLP as JDiscreteMLP

    state = _broadcast(JDiscreteMLP(2, 9), (2,), 9)
    for r in (mine, theirs):
        r._configure(cfg)
        r._apply_state(state)
        r.windows = 1
    want = theirs._collect_window()
    got = mine._collect_window()
    assert len(got) == 7 and got[-1].is_eval
    _same_window(got, want)
    assert sum(bool(r.obs_stats_update) for r in got[:-1]) == 6


# -- live runs over localhost -----------------------------------------------------------


def _live(server, client_main, epochs, timeout=120):
    """Train ``server`` for ``epochs`` in a thread while ``client_main(port)``
    runs in another; both must end."""
    result = {}

    def client():
        for _ in range(400):
            if getattr(server, "bound_port", None):
                break
            time.sleep(0.05)
        result["ok"] = client_main(server.bound_port)

    st = threading.Thread(target=lambda: server.train(max_epochs=epochs), daemon=True)
    ct = threading.Thread(target=client, daemon=True)
    st.start()
    ct.start()
    st.join(timeout=timeout)
    assert not st.is_alive(), "server loop did not finish"
    return ct, result


def _finite_rows(reporter, n):
    assert len(reporter.history) >= n
    for row in reporter.history:
        assert all(np.isfinite(v) for v in row.values() if isinstance(v, float)), row


def _thin(port, runner_cls, **kw):
    runner = runner_cls(port=port, collect_window_s=0.001, **kw)
    return runner, runner.run(max_iterations=200, reconnect_attempts=2)


@pytest.mark.parametrize("kind", ["pcg", "counter"])
def test_port_thin_client_trains_against_port_server(kind):
    from dfd_tpu_torch.runners.client import ClientRunner

    server = _port_server(batch_size=3, normalize_obs=False, random_seed=11 + len(kind),
                          noise_kind=kind)
    ct, result = _live(server, lambda p: _thin(p, ClientRunner, device=CPU), 2)
    ct.join(timeout=30)
    assert not ct.is_alive()
    assert server.learner.discarded_returns == 0
    _finite_rows(server.reporter, 2)


def test_port_client_trains_against_jax_server():
    """A port thin client feeds a JAX learner (PCG noise: the JAX learner
    replays the port client's numpy streams)."""
    from dfd_tpu_torch.runners.client import ClientRunner

    server = _jax_server(batch_size=3, normalize_obs=True, random_seed=13)
    ct, _ = _live(server, lambda p: _thin(p, ClientRunner, device=CPU), 2)
    ct.join(timeout=30)
    assert not ct.is_alive()
    assert server.learner.discarded_returns == 0
    _finite_rows(server.reporter, 2)


def test_jax_client_trains_against_port_server():
    """A JAX thin client feeds a port learner in counter mode: the port
    decodes the JAX client's member ids."""
    from dfd_tpu.runners.client import ClientRunner as JClientRunner

    server = _port_server(batch_size=3, normalize_obs=False, random_seed=17, noise_kind="counter")
    ct, _ = _live(server, lambda p: _thin(p, JClientRunner), 2)
    ct.join(timeout=30)
    assert not ct.is_alive()
    assert server.learner.discarded_returns == 0
    _finite_rows(server.reporter, 2)


def test_fat_client_trains_against_port_server():
    from dfd_tpu_torch.runners.fat_client import FatClientRunner

    server = _port_server(batch_size=6, random_seed=21, noise_kind="counter",
                          obs_stats_update_chance=0.2, eval_prob=0.5)
    count0 = server.global_obs_stats.count
    runners = []

    def client(port):
        runners.append(FatClientRunner(n_envs=8, port=port, device=CPU))
        return runners[0].run(max_windows=30, reconnect_attempts=1)

    ct, _ = _live(server, client, 3)
    ct.join(timeout=30)
    assert not ct.is_alive()
    assert server.learner.discarded_returns == 0
    assert server.global_obs_stats.count > count0
    _finite_rows(server.reporter, 3)
    assert {"_stage/rollout", "_stage/submit"} <= set(runners[0].last_stages)


@pytest.mark.parametrize("chunk, every", [(None, 3), (3, 1)])
def test_slice_client_trains_against_port_server(chunk, every):
    """Windows applied every 3rd broadcast land late and are drift-corrected;
    the chunked shard trains as the dense one does."""
    from dfd_tpu_torch.runners.slice_client import SliceClientRunner

    server = _port_server(batch_size=6, random_seed=41, noise_kind="counter",
                          obs_stats_update_chance=0.2)
    count0, zeta0 = server.global_obs_stats.count, server.zeta.copy()

    def client(port):
        return SliceClientRunner(n_members=6, port=port, device=CPU,
                                 apply_state_every=every, population_chunk=chunk,
                                 wait_for_new_state=every == 1, state_wait_timeout=10
                                 ).run(max_windows=40, reconnect_attempts=1)

    ct, _ = _live(server, client, 4)
    ct.join(timeout=30)
    assert not ct.is_alive()
    assert server.learner.discarded_returns == 0
    assert server.global_obs_stats.count > count0
    assert not np.array_equal(server.zeta, zeta0)
    assert server.policy_reward is not None
    _finite_rows(server.reporter, 2)
    if every == 3:
        assert any(row["Delayed Ratio"] > 0 for row in server.reporter.history)


def test_thin_client_survives_server_crash_and_retargets():
    from dfd_tpu_torch.runners.client import ClientRunner
    from dfd_tpu_torch.runners.policy import HostPolicy
    from dfd_tpu_torch.utils.factory import get_init_data

    _env, model, _dist = get_init_data("SimpleTrapEnv-v0", 5, CPU)
    cfg = {"env_id": "SimpleTrapEnv-v0", "noise_std": 0.02, "normalize_obs": False,
           "obs_stats_update_chance": 0.01, "random_seed": 5, "eval_prob": 0.05,
           "max_strategy_history_size": 4, "noise_kind": "pcg", "antithetic": False,
           "noise_seed": 5}

    def make_state(experiment):
        return FDState(strategy_frames=np.zeros((4, 2), np.float32),
                       strategy_history=np.zeros((1, 4, 9), np.float32),
                       policy_params=HostPolicy(model, seed=5).serialize(), epoch=0,
                       experiment_id=experiment, obs_stats=[0.0] * 5, cfg=dict(cfg))

    def wait_returns(srv, timeout):
        t0 = time.time()
        while time.time() - t0 < timeout:
            with srv.interface._lock:
                if srv.interface._returns:
                    return
            time.sleep(0.05)
        raise AssertionError("no returns arrived")

    srv1 = FDServer(make_state("expA"))
    port = srv1.start(port=0)
    runner = ClientRunner(port=port, collect_window_s=0.002, device=CPU)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("ok", runner.run(reconnect_attempts=30)),
                         daemon=True)
    t.start()
    srv2 = None
    try:
        wait_returns(srv1, timeout=60.0)
        srv1.stop(grace=0)
        time.sleep(0.5)
        srv2 = FDServer(make_state("expB"))
        for _ in range(40):
            try:
                srv2.start(port=port)
                break
            except Exception:
                time.sleep(0.25)
        wait_returns(srv2, timeout=60.0)
        assert runner.client.current_state.experiment_id == "expB"
    finally:
        runner.request_stop()
        t.join(timeout=30)
        if srv2 is not None:
            srv2.stop(grace=0)
    assert not t.is_alive()
    assert result["ok"] is True
