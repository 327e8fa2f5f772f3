"""The port's sequential topology held against the JAX package's, on the CPU.

Each package's ``SequentialRunner`` trains on the same seed, its env behind
the same tape (every action and step reward recorded) and its worker's
returns logged.  The numpy streams (the sampler, the worker's coins, the
noise, the zeta shuffles) are the same, so on the trap env and the pixel
env the actions, the step and per-return rewards, omega and the update
magnitudes are equal and ``flat`` within rtol 1e-5 (it is the host
learner's numpy arithmetic on equal inputs); the metrics computed by the
forwards (entropy, novelty) within rtol 1e-5.

The swimmer's float32 step is only as good as its 9 x 9 system's
conditioning (``tests/test_torch_swimmer.py``'s wave-gait episode: every
step's reward within ``SWIM_STEP_REWARD`` of JAX's, the velocities within
``SWIM_OBS`` of their largest), so its step rewards are held to that
bound, a return (a sum of ``SWIM_T`` of them) to ``SWIM_T`` times it, its
continuous actions (a tanh MLP, Lipschitz of order 1, of such
observations) within ``SWIM_ACTION``, and ``flat`` within rtol
``SWIM_FLAT_RTOL``, the trainer's bound on the swimmer
(``tests/test_torch_continuous.py``); resets are exact.
"""

import numpy as np
import pytest
import torch

from dfd_tpu.envs.pixelgrid import PixelGridEnv as JPixelGridEnv
from dfd_tpu.envs.swimmer import SwimmerEnv as JSwimmerEnv
from dfd_tpu.envs.wrappers import ImpalaObsWrapper as JImpalaObsWrapper
from dfd_tpu.runners import HostEnv as JHostEnv
from dfd_tpu.runners import SequentialRunner as JSequentialRunner
from dfd_tpu.utils import factory as jfactory
from dfd_tpu.utils.metrics import EpochReporter as JEpochReporter
from dfd_tpu_torch.envs import PixelGridEnv, SwimmerEnv
from dfd_tpu_torch.envs.wrappers import ImpalaObsWrapper
from dfd_tpu_torch.models import ImpalaPolicy
from dfd_tpu_torch.ops import distances
from dfd_tpu_torch.runners import Agent, HostEnv, HostPolicy, SequentialRunner
from dfd_tpu_torch.utils import factory
from dfd_tpu_torch.utils.metrics import EpochReporter

CPU = "cpu"
EXACT = ("Epoch", "Cumulative Timesteps", "Policy Reward", "Noisy Reward", "Update Magnitude",
         "Omega")
FORWARD = ("Policy Entropy", "Policy Novelty", "Noisy Novelty")
SWIM_T = 25               # the swimmer's episode length here
SWIM_STEP_REWARD = 1e-4   # a step's reward against JAX's, through an episode
SWIM_OBS = 1e-3           # an observation against JAX's, of max(1, its largest)
SWIM_ACTION = 1e-3
SWIM_FLAT_RTOL = 1e-4
PENDULUM_ACTION = 1e-6    # a continuous action against JAX's (ulps of the pendulum's state)
PENDULUM_REWARD = 2e-4    # a step's reward (up to ~16 in size) against JAX's


class _Tape:
    """A host env that records every action and step reward."""

    def __init__(self, env):
        self.env, self.actions, self.rewards = env, [], []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self):
        return self.env.reset()

    def step(self, action):
        out = self.env.step(action)
        self.actions.append(action)
        self.rewards.append(out[1])
        return out


def _log_returns(runner):
    """Log (is_eval, reward, timesteps, epoch) of every return the worker makes."""
    log, collect = [], runner.worker.collect_returns

    def logged(n=1):
        rets = collect(n)
        log.extend((r.is_eval, r.reward, r.timesteps, r.epoch) for r in rets)
        return rets

    runner.worker.collect_returns = logged
    return log


def _pair(jenv, jmodel, jdist, penv, pmodel, pdist, epochs, **kw):
    """Both runners trained ``epochs`` epochs on the same settings: (JAX's,
    the port's), each with ``tape`` and ``returns`` attached."""
    out = []
    for runner_cls, env, model, dist, rep in (
            (JSequentialRunner, jenv, jmodel, jdist, JEpochReporter),
            (SequentialRunner, penv, pmodel, pdist, EpochReporter)):
        tape = _Tape(env)
        runner = runner_cls(model, tape, dist, reporter=rep(quiet=True), **kw)
        runner.tape, runner.returns = tape, _log_returns(runner)
        runner.train(epochs)
        out.append(runner)
    return out


def _assert_same_run(j, p, rtol=1e-5):
    assert p.tape.actions == j.tape.actions
    assert p.tape.rewards == j.tape.rewards
    assert p.returns == j.returns
    assert len(p.reporter.history) == len(j.reporter.history) > 0
    for hj, hp in zip(j.reporter.history, p.reporter.history):
        for k in EXACT:
            assert hp[k] == hj[k], k
        for k in FORWARD:
            np.testing.assert_allclose(hp[k], hj[k], rtol=rtol, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(p.learner.flat, j.learner.flat, rtol=rtol, atol=0)
    np.testing.assert_array_equal(p.zeta, j.zeta)
    assert p.omega.omega == j.omega.omega and p.agent.cumulative_timesteps == \
        j.agent.cumulative_timesteps


@pytest.mark.parametrize("normalize_obs", [False, True])
def test_sequential_trap_matches_jax(normalize_obs):
    """SimpleTrapEnv-v0, 3 epochs, batch 10, zeta 16; evals at 0.3 so that
    omega, zeta, the archive and novelty all move."""
    kw = dict(batch_size=10, zeta_size=16, max_strategy_history_size=16, random_seed=123,
              eval_prob=0.3, normalize_obs=normalize_obs)
    j, p = _pair(*jfactory.get_init_data("SimpleTrapEnv-v0", 123),
                 *factory.get_init_data("SimpleTrapEnv-v0", 123, CPU), 3, **kw)
    _assert_same_run(j, p)
    assert any(e for e, *_ in p.returns)  # evals ran
    assert p.policy_novelty != 0.0 or p.reporter.history[-1]["Noisy Novelty"] != 0.0
    if normalize_obs:
        assert p.agent.obs_stats.count > 0


def test_sequential_cartpole_matches_jax():
    """CartPole-v1 (``DiscreteMLP``), 2 epochs of 4: actions, step and
    per-return rewards, omega and the update magnitudes equal, ``flat``
    within rtol 1e-5; zeta, the visited observations, within 1e-6 absolute
    (CartPole's step is 4 ulps a step off JAX's: measured 2.4e-7)."""
    kw = dict(batch_size=4, zeta_size=8, max_strategy_history_size=8, random_seed=3,
              eval_prob=0.3)
    j, p = _pair(*jfactory.get_init_data("CartPole-v1", 3),
                 *factory.get_init_data("CartPole-v1", 3, CPU), 2, **kw)
    assert p.tape.actions == j.tape.actions and p.tape.rewards == j.tape.rewards
    assert p.returns == j.returns
    for hj, hp in zip(j.reporter.history, p.reporter.history):
        for k in EXACT:
            assert hp[k] == hj[k], k
        for k in FORWARD:
            np.testing.assert_allclose(hp[k], hj[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(p.learner.flat, j.learner.flat, rtol=1e-5, atol=0)
    np.testing.assert_allclose(p.zeta, j.zeta, rtol=0, atol=1e-6)
    assert p.omega.omega == j.omega.omega


def test_sequential_pendulum_matches_jax_within_ulps():
    """Pendulum-v1 (``GaussianMLP``), 1 epoch of 4 with evals at 0.3: the
    pendulum's float32 step drifts from JAX's by ulps (XLA's fused
    multiply-adds), so the continuous actions are held to
    ``PENDULUM_ACTION`` (measured: the first to part, at step 49 of 4,000,
    by 4.5e-8), the step rewards to ``PENDULUM_REWARD`` (measured 1.5e-4 on
    rewards of up to 16, ~1e-5 of their size: the state's ulps squared into
    the cost), the returns to 200 times it, and ``flat`` within rtol 1e-5
    (measured 9.6e-7); step counts, evals and omega exact."""
    kw = dict(batch_size=4, zeta_size=8, max_strategy_history_size=8, random_seed=5,
              eval_prob=0.3)
    j, p = _pair(*jfactory.get_init_data("Pendulum-v1", 5),
                 *factory.get_init_data("Pendulum-v1", 5, CPU), 1, **kw)
    assert len(p.tape.actions) == len(j.tape.actions) > 0
    np.testing.assert_allclose(np.asarray(p.tape.actions), np.asarray(j.tape.actions), rtol=0,
                               atol=PENDULUM_ACTION)
    np.testing.assert_allclose(p.tape.rewards, j.tape.rewards, rtol=0, atol=PENDULUM_REWARD)
    assert [r[0::2] for r in p.returns] == [r[0::2] for r in j.returns]
    assert [r[2] for r in p.returns] == [r[2] for r in j.returns]
    np.testing.assert_allclose([r[1] for r in p.returns], [r[1] for r in j.returns], rtol=0,
                               atol=200 * PENDULUM_REWARD)
    np.testing.assert_allclose(p.learner.flat, j.learner.flat, rtol=1e-5, atol=1e-7)
    assert [h["Omega"] for h in p.reporter.history] == [h["Omega"] for h in j.reporter.history]


def test_sequential_pixelgrid_lstm_matches_jax():
    """PixelGridSmall-v0 through the ImpalaObsWrapper with the LSTM
    (ImpalaPolicy at its own widths on 3x32x32 frames), 3 epochs of 4."""
    kw = dict(batch_size=4, zeta_size=8, max_strategy_history_size=8, random_seed=7,
              eval_prob=0.3)
    j, p = _pair(*jfactory.get_init_data("PixelGridSmall-v0", 7),
                 *factory.get_init_data("PixelGridSmall-v0", 7, CPU), 3, **kw)
    assert isinstance(p.model, ImpalaPolicy) and p.model.use_lstm
    _assert_same_run(j, p)


def test_sequential_swimmer_matches_jax_within_its_conditioning():
    """Swimmer-v0's 7 links, episodes of SWIM_T steps, 2 epochs, batch 4."""
    kw = dict(batch_size=4, zeta_size=8, max_strategy_history_size=8, random_seed=5,
              eval_prob=0.3)
    _, jm, jd = jfactory.get_init_data("Swimmer-v0", 5)
    _, pm, pd = factory.get_init_data("Swimmer-v0", 5, CPU)
    j, p = _pair(JHostEnv(JSwimmerEnv(max_steps=SWIM_T), seed=5), jm, jd,
                 HostEnv(SwimmerEnv(max_steps=SWIM_T, device=CPU), seed=5), pm, pd, 2, **kw)
    assert len(p.tape.actions) == len(j.tape.actions)
    np.testing.assert_allclose(np.asarray(p.tape.actions), np.asarray(j.tape.actions), rtol=0,
                               atol=SWIM_ACTION)
    np.testing.assert_allclose(p.tape.rewards, j.tape.rewards, rtol=0, atol=SWIM_STEP_REWARD)
    assert [r[0::2] for r in p.returns] == [r[0::2] for r in j.returns]
    assert [r[2] for r in p.returns] == [r[2] for r in j.returns]
    np.testing.assert_allclose([r[1] for r in p.returns], [r[1] for r in j.returns], rtol=0,
                               atol=SWIM_T * SWIM_STEP_REWARD)
    np.testing.assert_allclose(p.learner.flat, j.learner.flat, rtol=SWIM_FLAT_RTOL, atol=1e-6)
    assert [h["Omega"] for h in p.reporter.history] == [h["Omega"] for h in j.reporter.history]


@pytest.mark.parametrize("env_id", ["PixelGridSmall-v0", "Swimmer-v0"])
def test_host_env_resets_follow_jax_key_chain(env_id):
    """HostEnv's resets take JAX's ``split`` chain from ``key(seed)``: the
    trap env ignores the key, so these two envs check it.  Five resets, a
    reseed, and a few steps between them."""
    jenv = JHostEnv(jfactory.make_jax_env(env_id), seed=3)
    penv = HostEnv(factory.make_jax_env(env_id, CPU), seed=3)
    continuous = not penv.env.discrete
    rng = np.random.RandomState(0)
    firsts = []
    for k in range(6):
        if k == 4:
            jenv.seed(11)
            penv.seed(11)
        jo, po = jenv.reset(), penv.reset()
        firsts.append(po)
        np.testing.assert_array_equal(po, jo)
        for _ in range(3):
            a = rng.uniform(-1, 1, penv.env.action_dim).tolist() if continuous \
                else int(rng.randint(5))
            (jo, jr, jdn, _), (po, pr, pdn, _) = jenv.step(a), penv.step(a)
            assert pdn == jdn
            if continuous:
                np.testing.assert_allclose(po, jo, rtol=0,
                                           atol=SWIM_OBS * max(1.0, float(np.abs(jo).max())))
                np.testing.assert_allclose(pr, jr, rtol=0, atol=SWIM_STEP_REWARD)
            else:
                np.testing.assert_array_equal(po, jo)
                assert pr == jr
    assert not all(np.array_equal(firsts[0], f) for f in firsts[1:])  # the key moves


def test_impala_host_env_and_agent_match_jax():
    """An eval episode of ImpalaPolicy through HostEnv + ImpalaObsWrapper
    with the Agent: the same reward, steps, saved dict states and entropy."""
    from dfd_tpu.models.impala import ImpalaPolicy as JImpalaPolicy
    from dfd_tpu.runners import Agent as JAgent
    from dfd_tpu.runners.policy import HostPolicy as JHostPolicy

    jm = JImpalaPolicy((3, 32, 32), 5, channels=(4, 8, 8), hidden=32)
    pm = ImpalaPolicy((3, 32, 32), 5, channels=(4, 8, 8), hidden=32, device=CPU)
    out = []
    for env, model, policy_cls, agent_cls in (
            (JImpalaObsWrapper(JHostEnv(JPixelGridEnv(grid=4, scale=8, max_steps=12), 2)), jm,
             JHostPolicy, JAgent),
            (ImpalaObsWrapper(HostEnv(PixelGridEnv(grid=4, scale=8, max_steps=12, device=CPU),
                                      2)), pm, HostPolicy, Agent)):
        agent = agent_cls(policy_cls(model, seed=1), env, random_seed=3)
        res = [agent.collect_return(eval_run=det, save_states=True) for det in (True, False)]
        out.append((res, agent.saved_states))
    (jres, jstates), (pres, pstates) = out
    for (jr, je, js), (pr, pe, ps) in zip(jres, pres):
        assert (pr, ps) == (jr, js)
        np.testing.assert_allclose(pe, je, rtol=1e-5)
    assert len(pstates) == len(jstates) and isinstance(pstates[0], dict)
    for a, b in zip(pstates, jstates):
        np.testing.assert_array_equal(a["frame"], b["frame"])
        assert (a["reward"], a["done"]) == (b["reward"], b["done"])


class _FakePixelEnv:
    """Tiny deterministic pixel env with an old-gym surface (HWC frames)."""

    n_actions = 5

    def __init__(self, episode_len=3):
        self.episode_len, self.t = episode_len, 0

    def reset(self):
        self.t = 0
        return np.full((16, 16, 3), 0.0, np.float32)

    def step(self, action):
        self.t += 1
        return (np.full((16, 16, 3), self.t * 20.0, np.float32), 1.0 if action == 0 else -0.5,
                self.t >= self.episode_len, {})


def test_sequential_vbn_buffer_keeps_real_rewards():
    """The VBN refresh of a dict-obs buffer feeds the buffer's real rewards
    through the LSTM (reference policies/impala.py:12-16), not zeros; the
    refreshed statistics equal JAX's ``compute_vbn`` on the same buffer."""
    from dfd_tpu.models.impala import ImpalaPolicy as JImpalaPolicy
    from dfd_tpu.ops import distances as jdist

    kw = dict(batch_size=2, zeta_size=4, max_strategy_history_size=4, vbn_buffer_size=6,
              random_seed=0)
    model = ImpalaPolicy((3, 16, 16), 5, channels=(4, 8, 8), hidden=32, device=CPU)
    runner = SequentialRunner(model, ImpalaObsWrapper(_FakePixelEnv()),
                              distances.categorical_tvd, **kw)
    buf = runner.vbn_buffer
    assert isinstance(buf, list) and isinstance(buf[0], dict)
    rewards = np.asarray([float(o["reward"]) for o in buf], np.float32)
    assert np.abs(rewards).sum() > 0  # the fake env pays +1 / -0.5 a step

    jm = JImpalaPolicy((3, 16, 16), 5, channels=(4, 8, 8), hidden=32)
    jrunner = JSequentialRunner(jm, JImpalaObsWrapper(_FakePixelEnv()), jdist.categorical_tvd,
                                **kw)
    np.testing.assert_array_equal(runner.policy.get_trainable_flat(),
                                  jrunner.policy.get_trainable_flat())
    policy = runner.policy
    params = model.set_flat(torch.from_numpy(policy.get_trainable_flat())[None])
    frames = torch.from_numpy(np.stack([np.asarray(o["frame"], np.float32) for o in buf]))
    before = dict(policy.bn_state)
    policy.compute_vbn(buf)
    jrunner.policy.compute_vbn(jrunner.vbn_buffer)
    expect = model.vbn(params, before, frames, rewards=torch.from_numpy(rewards))
    zero = model.vbn(params, before, frames, rewards=torch.zeros(len(buf)))
    for k in expect:
        for stat in ("mean", "var", "n"):
            np.testing.assert_array_equal(policy.bn_state[k][stat].numpy(),
                                          expect[k][stat].numpy())
            np.testing.assert_allclose(policy.bn_state[k][stat].numpy(),
                                       np.asarray(jrunner.policy.bn_state[k][stat]), rtol=1e-4,
                                       atol=5e-5)
    # the rewards are live: zero rewards give another policy_bn
    assert not np.allclose(expect["policy_bn"]["mean"].numpy(), zero["policy_bn"]["mean"].numpy())
    runner.train(1)
    assert float(runner.policy.bn_state["policy_bn"]["n"]) > float(before["policy_bn"]["n"])
    assert runner.timer.totals == {}  # stage totals drain every epoch
