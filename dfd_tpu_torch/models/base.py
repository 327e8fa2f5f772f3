"""Policy model interface.

A policy is a static description object whose methods are functions of
``(params, state, inputs)``: ``params`` the trainable tree that the FD
learner perturbs, ``state`` the non-trainable tree (BatchNorm running
statistics), as in ``dfd_tpu.models.base``.  Here ``params`` carries a
leading population axis ``[M]`` on every leaf (see
:func:`dfd_tpu_torch.core.flat.unflatten`), and every forward serves the
whole population at once; the host topology runs them at M = 1.

The wire view (:meth:`PolicyModel.serialize`, :meth:`PolicyModel.deserialize`)
is the full-state flat vector over ``state_spec`` (trainable parameters and
BatchNorm statistics in the reference's ``state_dict`` order), for one
unbatched set of weights, as in the JAX package.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Tuple

import torch

from dfd_tpu_torch.core.flat import FlatSpec, flatten, unflatten
from dfd_tpu_torch.models import layers

Params = Dict[str, Any]
State = Dict[str, Any]


class PolicyModel(abc.ABC):
    """Static policy description with population-batched forwards."""

    #: FlatSpec over trainable parameters, in torch parameters_to_vector order
    param_spec: FlatSpec
    #: FlatSpec over the full state (params + buffers), in state_dict order
    state_spec: FlatSpec
    #: shape of one observation (for obs-normalization statistics)
    input_shape: Any
    #: number of actions (discrete) or action dimensions (continuous)
    output_shape: int
    #: True for categorical action spaces
    discrete: bool = True
    #: True when the policy carries per-episode recurrent state (an LSTM)
    recurrent: bool = False
    #: device the model's tensors live on
    device: torch.device

    @property
    def num_params(self) -> int:
        return self.param_spec.size

    @abc.abstractmethod
    def init(self, seed: int) -> Tuple[Params, State]:
        """Initial (params, state) without a population axis, on ``device``."""

    @abc.abstractmethod
    def apply(self, params: Params, state: State, x: torch.Tensor) -> torch.Tensor:
        """Distribution parameters [M, N, F] for observations [N, *obs]
        (shared by the population) or [M, N, *obs]."""

    @abc.abstractmethod
    def entropy(self, params: Params, state: State, xs: torch.Tensor) -> torch.Tensor:
        """Mean policy entropy over a batch of observations, per member [M]."""

    @abc.abstractmethod
    def strategy(self, params: Params, state: State, zeta: torch.Tensor) -> torch.Tensor:
        """Behavior signature over the state set zeta, per member [M, Z, F]."""

    def vbn(self, params: Params, state: State, buffer: torch.Tensor,
            rewards: Optional[torch.Tensor] = None) -> State:
        """The VBN refresh: BatchNorm running statistics after one
        train-mode pass over ``buffer`` at the weights of ``params`` (a
        population of one); ``state`` itself for models without BatchNorm.
        ``rewards`` [N], each frame's arrival reward, is read only by
        recurrent models."""
        return state

    def initial_carry(self, M: int):
        """Per-episode recurrent carry of M members; () for feed-forward models."""
        return ()

    def prepare(self, params: Params, state: State) -> Params:
        """``params`` with whatever a forward derives from the weights alone
        computed once, for a run of forwards on the same population (a
        rollout); forwards take either and give the same values bit for bit.
        Identity unless a model overrides it: ``ImpalaPolicy`` keeps its fused
        kernels' weight layouts and, with bf16 operands, its fc and unfused
        conv weights rounded to bf16 and back."""
        return params

    def act_step(self, params: Params, state: State, obs: torch.Tensor,
                 prev_reward: torch.Tensor, prev_done: torch.Tensor, carry,
                 deterministic: torch.Tensor, noise: torch.Tensor):
        """One acting step for each of E episodes of every member: (action
        [M, E] or [M, E, A], entropy [M, E], carry).

        ``obs`` [M, E, *obs], a member's E episodes forwarded through its
        own weights; ``prev_reward`` [M, E] the reward of the previous step
        and ``prev_done`` [M, E] whether the episode is over (read by
        recurrent models only); ``deterministic`` [M] bool picks the argmax,
        or the mean.  ``noise`` [M, E, A] is each step's draw: for a
        categorical policy Gumbel noise, and the action is
        ``argmax(log(max(p, 1e-38)) + noise)``, which is how
        ``jax.random.categorical`` samples; for a Gaussian policy standard
        normals, and the action is ``mean + std * noise``, JAX's
        ``mean + std * normal(key, (A,))``, its entropy summed over the
        action's dimensions.  Feeding JAX's draws reproduces its actions.
        This default serves feed-forward models and returns ``carry`` as it
        came."""
        if self.discrete:
            probs = self.apply(params, state, obs)
            action, entropy = sample_action(probs, deterministic, noise)
            return action, entropy, carry
        mean, std = self.apply(params, state, obs)
        det = deterministic.reshape(deterministic.shape + (1,) * (mean.ndim - 1))
        action = torch.where(det, mean, mean + std * noise)
        return action, layers.gaussian_entropy(std).sum(dim=-1), carry

    def act(self, params: Params, state: State, obs: torch.Tensor, noise: torch.Tensor,
            deterministic=False) -> torch.Tensor:
        """Each member's action for one observation ``obs`` [*obs] from a
        fresh episode (a recurrent model's initial carry, a zero previous
        reward): [M], or [M, A] for a Gaussian policy.  ``noise`` [A] or
        [M, A] is the step's draw, as :meth:`act_step` takes it (unread
        where ``deterministic``)."""
        M = next(iter(params.values()))["w"].shape[0]
        dev = obs.device
        det = torch.as_tensor(deterministic, device=dev).expand(M)
        carry = tuple(c.reshape((M, 1) + c.shape[1:]) for c in self.initial_carry(M))
        action, _, _ = self.act_step(
            params, state, obs.expand((M,) + tuple(obs.shape))[:, None],
            torch.zeros((M, 1), dtype=torch.float32, device=dev),
            torch.zeros((M, 1), dtype=torch.bool, device=dev), carry, det,
            noise.to(dev).expand(M, noise.shape[-1])[:, None])
        return action[:, 0]

    def get_flat(self, params: Params) -> torch.Tensor:
        return flatten(params, self.param_spec)

    def set_flat(self, vec: torch.Tensor) -> Params:
        """Params viewing ``vec``: [d] gives unbatched leaves, [M, d] a population."""
        return unflatten(vec, self.param_spec)

    # -- full-state (wire) view ----------------------------------------------------

    def serialize(self, params: Params, state: State) -> torch.Tensor:
        """The full-state flat vector of unbatched ``params`` and ``state``
        (the wire format of an FDState broadcast)."""
        return flatten(self._merge_full(params, state), self.state_spec)

    def deserialize(self, vec: torch.Tensor) -> Tuple[Params, State]:
        """(params, state) viewing the full-state vector ``vec`` [D]."""
        return self._split_full(unflatten(vec, self.state_spec))

    def _merge_full(self, params: Params, state: State) -> Dict[str, Any]:
        """One tree of the parameters and the statistics (the models with
        BatchNorm override it)."""
        return params

    def _split_full(self, merged: Dict[str, Any]) -> Tuple[Params, State]:
        return merged, {}

    # -- reference-construction metadata (for the torch parity init, parity.py) --

    def reference_linear_dims(self):
        """(d_in, d_out) of each torch Linear in construction order."""
        raise NotImplementedError

    def linear_names(self):
        """Param-tree keys of the Linear layers, in construction order."""
        raise NotImplementedError

    def weighted_layer_names(self):
        """Param-tree keys of every weighted layer (incl. BatchNorm), in the
        reference's normc iteration order."""
        raise NotImplementedError


def sample_action(probs: torch.Tensor, deterministic: torch.Tensor, gumbel: torch.Tensor):
    """(action [M, E], entropy [M, E]) from probs [M, E, A]: the argmax where
    ``deterministic`` [M], else the Gumbel-max sample of
    ``jax.random.categorical``."""
    greedy = probs.argmax(dim=-1)
    sampled = (torch.log(torch.clamp_min(probs, 1e-38)) + gumbel).argmax(dim=-1)
    det = deterministic.reshape(deterministic.shape + (1,) * (greedy.ndim - deterministic.ndim))
    return torch.where(det, greedy, sampled), layers.categorical_entropy(probs)
