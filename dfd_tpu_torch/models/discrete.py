"""Discrete-action MLP policy (reference policies/discrete.py:8-48).

Architecture: BatchNorm -> Linear(64) -> ReLU, twice, then BatchNorm ->
Linear(n_actions) -> Softmax, evaluated in inference mode (BatchNorm uses
running statistics).  The strategy signature is the action-probability matrix
over zeta.  Parameter order and init draws are those of
``dfd_tpu.models.discrete.DiscreteMLP``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.core.flat import FlatSpec
from dfd_tpu_torch.models import layers
from dfd_tpu_torch.models.base import Params, PolicyModel, State
from dfd_tpu_torch.models.init import normc_layers


class DiscreteMLP(PolicyModel):
    discrete = True

    def __init__(self, n_inputs: int, n_actions: int, hidden: Tuple[int, ...] = (64, 64),
                 device=None):
        self.device = resolve_device(device)
        self.input_shape = int(n_inputs)
        self.output_shape = int(n_actions)
        self.hidden = tuple(hidden)

        dims = (self.input_shape,) + self.hidden
        f32 = np.float32
        param_entries, state_entries = [], []
        # blocks of BatchNorm(d_in) + Linear(d_in -> d_out), then the head
        self._blocks = []
        for k, (d_in, d_out) in enumerate(zip(dims, self.hidden + (self.output_shape,))):
            bn, ln = f"bn{k + 1}", f"l{k + 1}"
            self._blocks.append((bn, ln, d_in, d_out))
            param_entries += [
                ((bn, "w"), (d_in,), f32),
                ((bn, "b"), (d_in,), f32),
                ((ln, "w"), (d_out, d_in), f32),
                ((ln, "b"), (d_out,), f32),
            ]
            state_entries += [
                ((bn, "w"), (d_in,), f32),
                ((bn, "b"), (d_in,), f32),
                ((bn, "mean"), (d_in,), f32),
                ((bn, "var"), (d_in,), f32),
                ((bn, "n"), (), f32),
                ((ln, "w"), (d_out, d_in), f32),
                ((ln, "b"), (d_out,), f32),
            ]
        self.param_spec = FlatSpec.make(param_entries)
        self.state_spec = FlatSpec.make(state_entries)

    def init(self, seed: int) -> Tuple[Params, State]:
        """The JAX package's init, draw for draw (numpy normc), on ``device``."""
        shapes = []
        for _, _, d_in, d_out in self._blocks:
            shapes += [(d_in,), (d_out, d_in)]
        wi = iter(normc_layers(shapes, seed))
        t = lambda a: torch.as_tensor(a, device=self.device)
        params: Params = {}
        state: State = {}
        for bn, ln, d_in, d_out in self._blocks:
            params[bn] = {"w": t(next(wi)), "b": t(np.zeros(d_in, np.float32))}
            params[ln] = {"w": t(next(wi)), "b": t(np.zeros(d_out, np.float32))}
            state[bn] = {
                "mean": t(np.zeros(d_in, np.float32)),
                "var": t(np.ones(d_in, np.float32)),
                "n": t(np.zeros((), np.float32)),
            }
        return params, state

    def apply(self, params: Params, state: State, x: torch.Tensor) -> torch.Tensor:
        M = params[self._blocks[0][1]]["w"].shape[0]
        x = x.to(torch.float32)
        x = x.reshape((M, -1, self.input_shape) if x.ndim == 3 else (1, -1, self.input_shape))
        x = x.expand(M, -1, -1)
        n_blocks = len(self._blocks)
        for k, (bn, ln, _, _) in enumerate(self._blocks):
            x = layers.batchnorm_eval(params[bn], state[bn], x)
            x = layers.linear(params[ln], x)
            if k < n_blocks - 1:
                x = torch.relu(x)
        return layers.softmax(x)

    def entropy(self, params: Params, state: State, xs: torch.Tensor) -> torch.Tensor:
        return layers.categorical_entropy(self.apply(params, state, xs)).mean(dim=-1)

    def strategy(self, params: Params, state: State, zeta: torch.Tensor) -> torch.Tensor:
        return self.apply(params, state, zeta)

    def vbn(self, params: Params, state: State, buffer: torch.Tensor, rewards=None) -> State:
        """The VBN refresh: one train-mode pass over ``buffer`` (read as
        rows of ``input_shape``) at the weights of ``params``, a population
        of one; every block's BatchNorm statistics refreshed."""
        x = buffer.to(torch.float32).reshape(1, -1, self.input_shape)
        new_state = dict(state)
        n_blocks = len(self._blocks)
        for k, (bn, ln, _, _) in enumerate(self._blocks):
            x, new_state[bn] = layers.batchnorm_train(params[bn], state[bn], x)
            x = layers.linear(params[ln], x)
            if k < n_blocks - 1:
                x = torch.relu(x)
        return new_state

    # -- reference-construction metadata -----------------------------------------

    def reference_linear_dims(self):
        return [(d_in, d_out) for _, _, d_in, d_out in self._blocks]

    def linear_names(self):
        return [ln for _, ln, _, _ in self._blocks]

    def weighted_layer_names(self):
        names = []
        for bn, ln, _, _ in self._blocks:
            names += [bn, ln]
        return names

    # -- full-state (wire) view --------------------------------------------------

    def _merge_full(self, params: Params, state: State):
        merged = {}
        for bn, ln, _, _ in self._blocks:
            merged[bn] = {**params[bn], **state[bn]}
            merged[ln] = dict(params[ln])
        return merged

    def _split_full(self, merged):
        params: Params = {}
        state: State = {}
        for bn, ln, _, _ in self._blocks:
            params[bn] = {"w": merged[bn]["w"], "b": merged[bn]["b"]}
            params[ln] = dict(merged[ln])
            state[bn] = {k: merged[bn][k] for k in ("mean", "var", "n")}
        return params, state
