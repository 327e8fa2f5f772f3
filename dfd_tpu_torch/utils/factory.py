"""Environment/policy/distance factory (reference utils/init_helper.py:8-32),
the counterpart of ``dfd_tpu.utils.factory``.

Maps an env id to (env, policy model, strategy distance fn), every piece on
``device`` (``"cuda"`` unless the caller passes another): the JAX package's
native ids and pixel ids, with the same classes and widths.  The host
topology gets the env inside a :class:`~dfd_tpu_torch.runners.HostEnv`
(and an :class:`~dfd_tpu_torch.envs.wrappers.ImpalaObsWrapper` for a pixel
id); the vectorized trainer gets it raw.  The gymnasium, procgen and Atari
ids need adapters that are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs.cartpole import CartPoleEnv
from dfd_tpu_torch.envs.pendulum import PendulumEnv
from dfd_tpu_torch.envs.pixelgrid import PixelGridEnv
from dfd_tpu_torch.envs.procmaze import ProcMazeEnv
from dfd_tpu_torch.envs.swimmer import SwimmerEnv
from dfd_tpu_torch.envs.trap import TrapEnv
from dfd_tpu_torch.models import DiscreteMLP, GaussianMLP
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
    from dfd_tpu_torch.runners.vectorized import _not_ported

    device = resolve_device(device)
    if env_id not in JAX_PIXEL_ENVS and env_id not in JAX_ENVS:
        raise _not_ported(f"env {env_id!r} (the gymnasium, procgen and Atari adapters)",
                          "item 9.5, envs/gym_adapter.py and envs/atari_wrappers.py")
    env = make_jax_env(env_id, device)
    host = HostEnv(env, seed=random_seed)
    if env_id in JAX_PIXEL_ENVS:
        host = ImpalaObsWrapper(host)
    return (host, *_model(env, env_id, device))
