"""Environment/policy/distance factory (reference utils/init_helper.py:8-32),
the counterpart of ``dfd_tpu.utils.factory``.

Maps an env id to (env, policy model, strategy distance fn), every piece on
``device`` (``"cuda"`` unless the caller passes another): the JAX package's
native ids and pixel ids, with the same classes and widths.  The host
topology gets the env inside a :class:`~dfd_tpu_torch.runners.HostEnv`
(and an :class:`~dfd_tpu_torch.envs.wrappers.ImpalaObsWrapper` for a pixel
id); the vectorized trainer gets it raw.  Any other id goes to the host
adapters (``envs/gym_adapter.py``), as in the JAX package: a procgen id
through the gym-era adapter and the IMPALA policy, a ``NoFrameskip`` or
``ALE/`` id through the deepmind-style pipeline (``envs/atari_wrappers.py``)
and ``AtariCNN``, another gymnasium id through an MLP on its flattened
observation; each raises JAX's ``RuntimeError`` where its package is
missing.  The env stays on the host; only the model goes on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs.cartpole import CartPoleEnv
from dfd_tpu_torch.envs.pendulum import PendulumEnv
from dfd_tpu_torch.envs.pixelgrid import PixelGridEnv
from dfd_tpu_torch.envs.procmaze import ProcMazeEnv
from dfd_tpu_torch.envs.swimmer import SwimmerEnv
from dfd_tpu_torch.envs.trap import TrapEnv
from dfd_tpu_torch.models import DiscreteMLP, GaussianMLP
from dfd_tpu_torch.models.atari import AtariCNN
from dfd_tpu_torch.models.impala import ImpalaPolicy
from dfd_tpu_torch.ops import distances

# the JAX package's native ids (dfd_tpu/utils/factory.py:27-34)
JAX_ENVS = {
    "SimpleTrapEnv-v0": TrapEnv,
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    # HalfCheetah-class continuous locomotion (16-dim obs, 6 torque actions)
    "Swimmer-v0": SwimmerEnv,
}

# its pixel ids, paired with the IMPALA policy family (dfd_tpu/utils/factory.py:39-47);
# "Small" keeps CPU test topologies fast
JAX_PIXEL_ENVS = {
    "PixelGrid-v0": lambda device: PixelGridEnv(grid=8, scale=8, device=device),
    "PixelGridSmall-v0": lambda device: PixelGridEnv(grid=4, scale=8, max_steps=12, device=device),
    "ProcMaze-v0": lambda device: ProcMazeEnv(num_levels=200, distribution_mode="easy",
                                              device=device),
    "ProcMazeHard-v0": lambda device: ProcMazeEnv(num_levels=10000, distribution_mode="hard",
                                                  device=device),
}


def make_jax_env(env_id: str, device=None):
    """The port env of a registered id, on ``device``."""
    device = resolve_device(device)
    if env_id in JAX_PIXEL_ENVS:
        return JAX_PIXEL_ENVS[env_id](device)
    if env_id not in JAX_ENVS:
        raise KeyError(f"no JAX-native env registered for {env_id!r}")
    return JAX_ENVS[env_id](device=device)


def _model(env, env_id: str, device):
    if env_id in JAX_PIXEL_ENVS:
        return ImpalaPolicy(env.obs_shape, env.n_actions, device=device), distances.categorical_tvd
    obs_dim = int(env.obs_shape[0])
    if env.discrete:
        return DiscreteMLP(obs_dim, env.n_actions, device=device), distances.categorical_tvd
    return (GaussianMLP(obs_dim, env.action_dim, device=device),
            distances.gaussian_wasserstein_from_strategies)


def get_vectorized_init_data(env_id: str, device=None) -> Tuple[object, object, object]:
    """(raw env, policy model, distance fn) for the vectorized trainer."""
    device = resolve_device(device)
    env = make_jax_env(env_id, device)
    return (env, *_model(env, env_id, device))


def get_init_data(env_id: str, random_seed: int, device=None) -> Tuple[object, object, object]:
    """(host-surface env, policy model, strategy distance fn) for ``env_id``."""
    from dfd_tpu_torch.envs.wrappers import ImpalaObsWrapper
    from dfd_tpu_torch.runners.host_env import HostEnv

    device = resolve_device(device)
    if env_id in JAX_PIXEL_ENVS or env_id in JAX_ENVS:
        env = make_jax_env(env_id, device)
        host = HostEnv(env, seed=random_seed)
        if env_id in JAX_PIXEL_ENVS:
            host = ImpalaObsWrapper(host)
        return (host, *_model(env, env_id, device))

    # through the module at call time, so a test can stand a fake env in
    from dfd_tpu_torch.envs import gym_adapter

    if "procgen" in env_id:
        # procgen is gym-era (registers against gym, not gymnasium); built
        # through the legacy adapter and wrapped as the reference does
        # (reference utils/init_helper.py:9-12 + utils/impala_env_wrapper.py)
        if not gym_adapter.procgen_available():
            raise RuntimeError(
                f"env {env_id!r} needs the gym-era 'procgen' and 'gym' packages, "
                "which are not installed in this image"
            )
        raw = gym_adapter.GymEnv(env_id, seed=random_seed, distribution_mode="easy",
                                 num_levels=500)
        h, w, c = raw.obs_shape
        model = ImpalaPolicy((c, h, w), raw.n_actions, device=device)
        return ImpalaObsWrapper(raw), model, distances.categorical_tvd

    if not gym_adapter.gymnasium_available():
        raise RuntimeError(f"gymnasium not available for env {env_id!r}")

    if "NoFrameskip" in env_id or "ALE/" in env_id:
        # deepmind preprocessing, as the reference composes from baselines
        # (reference utils/init_helper.py:13-18): noop reset, max+skip-4,
        # episodic life, fire reset, 84x84 grayscale, /255, 4-stack
        from dfd_tpu_torch.envs.atari_wrappers import wrap_deepmind_style

        env = wrap_deepmind_style(gym_adapter.GymnasiumEnv(env_id, seed=random_seed),
                                  seed=random_seed)
        shape = env.obs_shape  # (84, 84, 4) channels-last stacks
        model = AtariCNN((shape[0], shape[1]), env.n_actions, in_channels=shape[2],
                         device=device)
        return env, model, distances.categorical_tvd

    env = gym_adapter.GymnasiumEnv(env_id, seed=random_seed)
    n_in = int(np.prod(env.obs_shape))
    if env.n_actions is not None:
        return env, DiscreteMLP(n_in, env.n_actions, device=device), distances.categorical_tvd
    return (env, GaussianMLP(n_in, int(np.prod(env.action_space.shape)), device=device),
            distances.gaussian_wasserstein_from_strategies)
