"""The port's gymnasium and gym-era adapters (``dfd_tpu_torch/envs/gym_adapter.py``)
and the factory's gymnasium branches, held against the JAX package's on the
CPU, on the classic-control envs gymnasium ships: ``GymnasiumEnv`` step for
step equal to JAX's adapter, the factory's models of the same types and
shapes, JAX's refusal of a procgen id without procgen, and each package's
``SequentialRunner`` on ``Acrobot-v1`` with the same actions and ``flat``
within rtol 1e-5 (the host learner's numpy arithmetic on equal returns).
"""

import numpy as np
import pytest

from dfd_tpu.envs import gym_adapter as jga
from dfd_tpu.utils import factory as jfactory
from dfd_tpu_torch.envs import gym_adapter as pga
from dfd_tpu_torch.models import DiscreteMLP, GaussianMLP
from dfd_tpu_torch.utils import factory
from test_torch_sequential import _assert_same_run, _pair

CPU = "cpu"

pytestmark = pytest.mark.skipif(not pga.gymnasium_available(), reason="gymnasium not installed")


@pytest.mark.parametrize("env_id, actions", [
    ("Acrobot-v1", lambda rng: int(rng.integers(0, 3))),
    ("MountainCarContinuous-v0", lambda rng: rng.uniform(-1, 1, 1).astype(np.float32)),
])
def test_gymnasium_env_equals_jax_step_for_step(env_id, actions):
    """Two episodes' resets (the first seeded, the second not) and 150
    steps each of the same random actions: observations, rewards, dones
    equal bit for bit."""
    mine, theirs = pga.GymnasiumEnv(env_id, seed=4), jga.GymnasiumEnv(env_id, seed=4)
    assert (mine.n_actions, mine.obs_shape) == (theirs.n_actions, theirs.obs_shape)
    rng = np.random.default_rng(0)
    for episode in range(2):
        np.testing.assert_array_equal(mine.reset(), theirs.reset())
        for _ in range(150):
            a = actions(rng)
            (om, rm, dm, _), (ot, rt, dt, _) = mine.step(a), theirs.step(a)
            np.testing.assert_array_equal(om, ot)
            assert (rm, dm) == (rt, dt)
            if dm:
                break
    mine.seed(9)
    theirs.seed(9)
    np.testing.assert_array_equal(mine.reset(), theirs.reset())
    mine.close()
    theirs.close()


@pytest.mark.parametrize("env_id, cls", [("Acrobot-v1", DiscreteMLP),
                                         ("MountainCarContinuous-v0", GaussianMLP),
                                         ("CartPole-v0", DiscreteMLP)])
def test_factory_gymnasium_ids_match_jax(env_id, cls):
    """A gymnasium id outside the native ones: the host adapter and an MLP
    on the flattened observation, of JAX's widths, on the device asked for."""
    env, model, dist = factory.get_init_data(env_id, 5, CPU)
    jenv, jmodel, jdist = jfactory.get_init_data(env_id, 5)
    assert isinstance(env, pga.GymnasiumEnv) and isinstance(model, cls)
    assert type(model).__name__ == type(jmodel).__name__
    assert (model.input_shape, model.output_shape, model.num_params) == \
        (jmodel.input_shape, jmodel.output_shape, jmodel.num_params)
    assert str(model.device) == CPU and dist.__name__ == jdist.__name__
    np.testing.assert_array_equal(env.reset(), jenv.reset())


def test_factory_procgen_id_raises_jax_error():
    """procgen is not installed: both factories refuse its ids with the
    same RuntimeError, and the port builds nothing first."""
    assert not pga.procgen_available() and not jga.procgen_available()
    with pytest.raises(RuntimeError) as want:
        jfactory.get_init_data("procgen:procgen-coinrun-v0", 0)
    with pytest.raises(RuntimeError) as got:
        factory.get_init_data("procgen:procgen-coinrun-v0", 0, CPU)
    assert str(got.value) == str(want.value)


def test_factory_without_gymnasium_raises_jax_error(monkeypatch):
    monkeypatch.setattr(pga, "gymnasium_available", lambda: False)
    monkeypatch.setattr(jga, "gymnasium_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        jfactory.get_init_data("Acrobot-v1", 0)
    with pytest.raises(RuntimeError) as got:
        factory.get_init_data("Acrobot-v1", 0, CPU)
    assert str(got.value) == str(want.value) == "gymnasium not available for env 'Acrobot-v1'"


def test_gym_env_adapts_both_api_generations():
    """GymEnv adapts gym>=0.26 (tuple reset, 5-tuple step) as well as the
    legacy 4-tuple API procgen registers against (tests/test_envs.py's)."""

    class _Modern:
        def reset(self):
            return np.zeros(3, np.float32), {}

        def step(self, action):
            return np.ones(3, np.float32), 1.0, False, True, {}

    class _Legacy:
        def reset(self):
            return np.zeros(3, np.float32)

        def step(self, action):
            return np.ones(3, np.float32), 2.0, True, {}

    for fake, want_rew in ((_Modern(), 1.0), (_Legacy(), 2.0)):
        env = pga.GymEnv.__new__(pga.GymEnv)
        env._env = fake
        env._seed = None
        assert env.reset().shape == (3,)
        obs, rew, done, _ = env.step(0)
        assert rew == want_rew and done is True


def test_gym_env_seeds_modern_envs_via_reset():
    class _Modern:
        def __init__(self):
            self.seen = []

        def reset(self, seed=None):
            self.seen.append(seed)
            return np.zeros(3, np.float32), {}

    fake = _Modern()
    env = pga.GymEnv.__new__(pga.GymEnv)
    env._env = fake
    env._seed = 123
    env.reset()
    env.reset()
    assert fake.seen == [123, None]


def test_sequential_acrobot_matches_jax():
    """Each package's SequentialRunner on ``Acrobot-v1`` through its
    factory, 2 epochs of 4 with evals at 0.3: the same actions and step
    rewards, returns, omega and update magnitudes; ``flat`` within rtol
    1e-5."""
    kw = dict(batch_size=4, zeta_size=8, max_strategy_history_size=8, random_seed=11,
              eval_prob=0.3)
    j, p = _pair(*jfactory.get_init_data("Acrobot-v1", 11),
                 *factory.get_init_data("Acrobot-v1", 11, CPU), 2, **kw)
    assert len(p.tape.actions) > 0
    _assert_same_run(j, p)
