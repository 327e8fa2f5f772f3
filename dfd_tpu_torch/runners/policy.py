"""Host-side policy wrapper for the sequential topology, the counterpart of
``dfd_tpu.runners.policy``.

Binds a population-batched :class:`~dfd_tpu_torch.models.base.PolicyModel`
to one flat parameter vector and BatchNorm state, exposing the reference
Policy surface (get_action / get_entropy / get_strategy / flat get-set /
serialize, reference policies/policy.py:17-69) with a pluggable action
sampler (:class:`NumpySampler`, the JAX package's numpy sampler, copied).

The model runs at M = 1 on its device.  The flat lives twice: as the numpy
float32 vector the host learner and worker read and write, and as one copy
on the device that every forward reads.  The device copy is refreshed only
where the weights change: :meth:`HostPolicy.set_trainable_flat` (once an
episode, when the worker perturbs), :meth:`HostPolicy.deserialize` and
:meth:`HostPolicy.compute_vbn`.  A step sends its observation to the device
through pinned memory without a host synchronisation
(``core/device.py::Staging``) and reads the action's probabilities (or mean
and std) back in one transfer: one synchronisation a step.
Forwards run in full float32 (``core/device.py::full_f32``), as the
trainer's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dfd_tpu_torch.core.device import Staging, full_f32, tree_to
from dfd_tpu_torch.models import layers
from dfd_tpu_torch.models.base import PolicyModel


class NumpySampler:
    """Inverse-CDF categorical / Box-Muller-free normal sampling via numpy."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)

    def sample_categorical(self, probs: np.ndarray) -> int:
        p = np.asarray(probs, np.float64)
        p = p / p.sum()
        return int(np.searchsorted(np.cumsum(p), self.rng.uniform(), side="right"))

    def sample_normal(self, mean: np.ndarray, std: np.ndarray):
        return (np.asarray(mean) + np.asarray(std) * self.rng.standard_normal(np.shape(mean))).flatten().tolist()


class HostPolicy:
    """The policy of one host worker: ``flat`` a numpy vector, ``bn_state``
    the model's tree of tensors (``model.init(seed)``'s where either is
    not given)."""

    def __init__(
        self,
        model: PolicyModel,
        flat: Optional[np.ndarray] = None,
        bn_state=None,
        seed: int = 124,
        sampler=None,
    ):
        self.model = model
        self.device = model.device
        self._stage = Staging(self.device)
        if flat is None or bn_state is None:
            params, state = model.init(seed)
            flat = model.get_flat(params).cpu().numpy() if flat is None else flat
            bn_state = state if bn_state is None else bn_state
        self.bn_state = tree_to(bn_state, self.device)
        self.sampler = sampler if sampler is not None else NumpySampler(seed)
        self.set_trainable_flat(flat)
        self._carry = model.initial_carry(1)

    # -- reference-compatible surface --------------------------------------------

    @property
    def num_params(self) -> int:
        return self.model.num_params

    @property
    def input_shape(self):
        return self.model.input_shape

    def get_trainable_flat(self) -> np.ndarray:
        return self.flat.copy()

    def set_trainable_flat(self, flat) -> None:
        self.flat = np.asarray(flat, np.float32).copy()
        self._set_device_flat(self._stage(self.flat))

    def _set_device_flat(self, flat: torch.Tensor) -> None:
        """The device copy: the weights of a population of one, with what
        the model derives from them and the BN state computed once."""
        self._flat_dev = flat
        self._params = self.model.prepare(self.model.set_flat(flat[None]), self.bn_state)

    def _tensor(self, x) -> torch.Tensor:
        return self._stage(np.asarray(x, np.float32))

    def forward(self, x):
        """The model's output for observations ``x`` ([*obs] or [N, *obs]):
        probs [1, N, A], or (mean, std) [1, N, A] each."""
        with full_f32():
            return self.model.apply(self._params, self.bn_state, self._tensor(x))

    def get_action(self, obs, deterministic: bool = False):
        if self.model.recurrent:
            frame, reward, _done = self._unpack_obs(obs)
            with full_f32():
                probs_t, self._carry = self.model.step_probs(
                    self._params, self.bn_state, self._tensor(frame)[None],
                    torch.full((1,), reward, dtype=torch.float32, device=self.device),
                    self._carry,
                )
            probs = probs_t[0].cpu().numpy()
            if deterministic:
                return int(np.argmax(probs))
            return self.sampler.sample_categorical(probs)
        out = self.forward(obs)
        if self.model.discrete:
            probs = out[0, 0].cpu().numpy()
            if deterministic:
                return int(np.argmax(probs))
            return self.sampler.sample_categorical(probs)
        mean, std = torch.stack([out[0][0, 0], out[1][0, 0]]).cpu().numpy()
        if deterministic:
            return mean.flatten().tolist()
        return self.sampler.sample_normal(mean, std)

    def get_entropy(self, states) -> float:
        with full_f32():
            if self.model.recurrent:
                frames, rewards = self._stack_dict_states(states)
                probs = self.model.apply_seq(self._params, self.bn_state, frames[None],
                                             rewards[None])
                return float(layers.categorical_entropy(probs).mean())
            return float(self.model.entropy(self._params, self.bn_state, self._tensor(states))[0])

    def get_strategy(self, zeta) -> np.ndarray:
        with full_f32():
            if self.model.recurrent and len(zeta) > 0 and isinstance(zeta[0], dict):
                # dict zeta entries carry rewards the reference's stacked
                # strategy forward feeds through the LSTM (reference
                # policies/impala.py:21-27)
                frames, rewards = self._stack_dict_states(zeta)
                probs = self.model.apply_seq(self._params, self.bn_state, frames[None],
                                             rewards[None])
                return probs[0].cpu().numpy().reshape(len(frames), -1)
            return self.model.strategy(self._params, self.bn_state,
                                       self._tensor(zeta))[0].cpu().numpy()

    @staticmethod
    def _unpack_obs(obs):
        if isinstance(obs, dict):
            return obs["frame"], float(obs["reward"]), bool(obs["done"])
        return obs, 0.0, False

    def _stack_dict_states(self, states):
        """(frames [N, *frame], rewards [N]) as tensors on the device."""
        if len(states) > 0 and isinstance(states[0], dict):
            frames = np.stack([np.asarray(s["frame"], np.float32) for s in states])
            rewards = np.asarray([float(s["reward"]) for s in states], np.float32)
        else:
            frames = np.asarray(states, np.float32)
            rewards = np.zeros(len(frames), np.float32)
        return self._tensor(frames), self._tensor(rewards)

    def compute_vbn(self, buffer) -> None:
        """The VBN refresh over ``buffer`` at the current weights."""
        entries = list(buffer)
        with full_f32():
            if entries and isinstance(entries[0], dict):
                # dict-obs buffers (recurrent wrappers): the refresh feeds the
                # buffer's real rewards through the LSTM, like the reference's
                # stacked dict-obs VBN (reference policies/impala.py:12-16)
                frames, rewards = self._stack_dict_states(entries)
                if self.model.recurrent:
                    state = self.model.vbn(self._params, self.bn_state, frames, rewards=rewards)
                else:
                    state = self.model.vbn(self._params, self.bn_state, frames)
            else:
                state = self.model.vbn(self._params, self.bn_state, self._tensor(buffer))
        self.bn_state = state
        self._set_device_flat(self._flat_dev)

    def serialize(self):
        params = self.model.set_flat(self._flat_dev)
        return self.model.serialize(params, self.bn_state).cpu().numpy().tolist()

    def deserialize(self, serialized) -> None:
        vec = self._tensor(serialized)
        params, state = self.model.deserialize(vec)
        flat = self.model.get_flat(params)
        self.flat = flat.cpu().numpy()
        if state:
            self.bn_state = state
        self._set_device_flat(flat)

    def reset(self) -> None:
        """Reset per-episode recurrent state (no-op for feed-forward models)."""
        self._carry = self.model.initial_carry(1)
