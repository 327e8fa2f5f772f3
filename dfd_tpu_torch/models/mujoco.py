"""Continuous-control Gaussian MLP policy (reference policies/mujoco.py:8-41).

Architecture: Linear(64) -> Tanh, twice, then Linear(2 * n_actions) and the
tanh action map (mean in [-1, 1], stddev in [0.1, 1.0]).  No BatchNorm.  The
strategy signature concatenates (mean, std) over zeta.  Parameter order and
init draws are those of ``dfd_tpu.models.mujoco.GaussianMLP``.
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


class GaussianMLP(PolicyModel):
    discrete = False

    def __init__(self, n_inputs: int, n_actions: int, hidden: Tuple[int, ...] = (64, 64),
                 device=None):
        self.device = resolve_device(device)
        self.input_shape = int(n_inputs)
        self.output_shape = int(n_actions)
        self.hidden = tuple(hidden)

        dims = (self.input_shape,) + self.hidden + (2 * self.output_shape,)
        f32 = np.float32
        self._layer_dims = list(zip(dims[:-1], dims[1:]))
        entries = []
        for k, (d_in, d_out) in enumerate(self._layer_dims):
            entries += [((f"l{k + 1}", "w"), (d_out, d_in), f32), ((f"l{k + 1}", "b"), (d_out,), f32)]
        self.param_spec = FlatSpec.make(entries)
        self.state_spec = self.param_spec  # no buffers

    def init(self, seed: int) -> Tuple[Params, State]:
        """The JAX package's init, draw for draw (numpy normc), on ``device``."""
        weights = normc_layers([(o, i) for i, o in self._layer_dims], seed)
        t = lambda a: torch.as_tensor(a, device=self.device)
        params: Params = {}
        for k, ((_, d_out), w) in enumerate(zip(self._layer_dims, weights)):
            params[f"l{k + 1}"] = {"w": t(w), "b": t(np.zeros(d_out, np.float32))}
        return params, {}

    def apply(self, params: Params, state: State, x: torch.Tensor):
        """(mean, std) [M, N, n_actions] each for observations [N, obs]
        (shared by the population) or [M, N, obs]."""
        M = params["l1"]["w"].shape[0]
        x = x.to(torch.float32)
        x = x.reshape((M, -1, self.input_shape) if x.ndim == 3 else (1, -1, self.input_shape))
        x = x.expand(M, -1, -1)
        n = len(self._layer_dims)
        for k in range(n):
            x = layers.linear(params[f"l{k + 1}"], x)
            if k < n - 1:
                x = torch.tanh(x)
        return layers.map_continuous_to_action(x)

    def entropy(self, params: Params, state: State, xs: torch.Tensor) -> torch.Tensor:
        _, std = self.apply(params, state, xs)
        return layers.gaussian_entropy(std).sum(dim=-1).mean(dim=-1)

    def strategy(self, params: Params, state: State, zeta: torch.Tensor) -> torch.Tensor:
        """[M, Z, 2 n_actions]: the mean and the std over zeta."""
        mean, std = self.apply(params, state, zeta)
        return torch.cat([mean, std], dim=-1)

    # -- reference-construction metadata -----------------------------------------

    def reference_linear_dims(self):
        return list(self._layer_dims)

    def linear_names(self):
        return [f"l{k + 1}" for k in range(len(self._layer_dims))]

    def weighted_layer_names(self):
        return self.linear_names()
