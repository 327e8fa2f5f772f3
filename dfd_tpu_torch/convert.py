"""Carry weights, trainer state and the VBN buffer across from the JAX
package.

Every function takes numpy arrays (``np.asarray`` of the JAX package's
arrays), so this module needs no JAX itself.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.core.welford import WelfordState
from dfd_tpu_torch.fd.omega import OmegaState
from dfd_tpu_torch.runners.vectorized import TrainState


def _to_tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def params_from_numpy(model, params_np: Dict[str, Any], bn_state_np: Dict[str, Any], device=None):
    """The JAX package's (params, bn_state) trees -> the port's, on ``device``.

    The trees share their key paths, so ``model.get_flat`` of the result is
    the JAX flat vector."""
    device = resolve_device(device)
    params = _to_tensors(params_np, device)
    missing = {p for p, _, _ in model.param_spec.entries} - {
        (a, b) for a, sub in params.items() for b in sub
    }
    if missing:
        raise ValueError(f"params tree lacks {sorted(missing)}")
    return params, _to_tensors(bn_state_np, device)


def train_state_from_numpy(state_np, device=None) -> TrainState:
    """A JAX ``TrainState`` (as a mapping or NamedTuple of numpy arrays; its
    ``key`` is not read) -> the port's :class:`TrainState`."""
    device = resolve_device(device)
    s = state_np._asdict() if hasattr(state_np, "_asdict") else dict(state_np)
    t = lambda x: torch.as_tensor(np.array(x), device=device)
    return TrainState(
        flat=t(s["flat"]).to(torch.float32),
        bn_state=_to_tensors(s["bn_state"], device),
        omega=OmegaState(*(t(x) for x in s["omega"])),
        obs_stats=WelfordState(*(t(x) for x in s["obs_stats"])),
        zeta=t(s["zeta"]).to(torch.float32),
        policy_reward=t(s["policy_reward"]),
        policy_entropy=t(s["policy_entropy"]),
        policy_novelty=t(s["policy_novelty"]),
        epoch=int(s["epoch"]),
    )


def vbn_buffer_from_numpy(buffer_np, device=None):
    """The JAX trainer's VBN buffer ``(obs [N, *obs], arrival rewards [N])``
    -> the port trainer's ``_vbn_buffer``, float32 on ``device``."""
    device = resolve_device(device)
    obs, rewards = buffer_np
    t = lambda x: torch.as_tensor(np.array(x), device=device).to(torch.float32)
    return t(obs), t(rewards)
