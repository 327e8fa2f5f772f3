"""Atari CNN policy over a population of weights (reference
policies/atari.py:7-51), the port of ``dfd_tpu.models.atari.AtariCNN``.

Frames -> Conv(16, 8x8, stride 4) -> BN -> ReLU -> Conv(32, 4x4, stride 2)
-> BN -> ReLU -> flatten -> Linear(256) -> BN -> ReLU -> Linear(n_actions)
-> softmax, evaluated with the BatchNorms in inference mode.

Every leaf of ``params`` carries the population axis ``[M]``; frames are
``[M, N, C, H, W]`` or ``[N, C, H, W]`` shared by the members (channels-last
``[..., H, W, C]`` frames are turned around first).  The convs are VALID and
population-batched: im2col patches with the channels ordered (ci, kh, kw),
as ``conv_general_dilated_patches`` orders them, and one batched product per
member.  ``compute_dtype=torch.bfloat16`` rounds the conv and fc operands to
bf16 and accumulates in float32, as the JAX model's bf16 products with
``preferred_element_type=float32``; the BNs and the head stay float32.  The
layer order, the flat view and the normc init draws are the JAX model's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.core.flat import FlatSpec
from dfd_tpu_torch.models import layers
from dfd_tpu_torch.models.base import Params, PolicyModel, State
from dfd_tpu_torch.models.init import normc_layers


def _conv_out(size: int, k: int, s: int) -> int:
    return (size - k) // s + 1


def conv2d(p, x: torch.Tensor, stride: int, compute_dtype=None) -> torch.Tensor:
    """VALID conv with OIHW weights per member, as im2col + batched product:
    x [M, N, ci, H, W] (or [1, N, ...] shared by the members), w [M, co, ci,
    kh, kw], b [M, co] -> [M, N, co, H', W']."""
    w = p["w"]
    M, co, ci, kh, kw = w.shape
    N = x.shape[1]
    win = x.unfold(3, kh, stride).unfold(4, kw, stride)          # [Mx, N, ci, H', W', kh, kw]
    Ho, Wo = win.shape[3], win.shape[4]
    pat = win.permute(0, 2, 5, 6, 1, 3, 4).reshape(x.shape[0], ci * kh * kw, N * Ho * Wo)
    wk = w.reshape(M, co, ci * kh * kw)
    if compute_dtype is not None:
        pat = pat.to(compute_dtype).to(torch.float32)
        wk = wk.to(compute_dtype).to(torch.float32)
    y = torch.matmul(wk, pat).reshape(M, co, N, Ho, Wo).transpose(1, 2)
    return y + p["b"][:, None, :, None, None]


def batchnorm2d_eval(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d in inference mode over x [M, B, C, H, W]: running
    statistics ``s`` [C] shared by the population, affine ``p`` [M, C] per
    member."""
    bc = lambda v: v[:, None, None]                     # [C] -> [C, 1, 1]
    pc = lambda v: v[:, None, :, None, None]            # [M, C] -> [M, 1, C, 1, 1]
    return (x - bc(s["mean"])) / torch.sqrt(bc(s["var"]) + layers.BN_EPS) * pc(p["w"]) + pc(p["b"])


def batchnorm2d_train(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor],
                      x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm2d in training mode over one member's x [1, N, C, H, W]:
    :func:`layers.batchnorm_train` over the N * H * W positions of each
    channel.  Returns (y, new statistics)."""
    _, n, c, h, w = x.shape
    rows = x.permute(0, 1, 3, 4, 2).reshape(1, -1, c)
    y, new_s = layers.batchnorm_train(p, s, rows)
    return y.reshape(1, n, h, w, c).permute(0, 1, 4, 2, 3), new_s


class AtariCNN(PolicyModel):
    discrete = True

    def __init__(self, frame_shape: Tuple[int, int], n_actions: int, in_channels: int = 4,
                 compute_dtype=None, device=None):
        """``frame_shape`` (H, W); ``compute_dtype``: None or
        ``torch.bfloat16`` (conv and fc operands rounded to bf16, products
        accumulated in float32)."""
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        self.device = resolve_device(device)
        h, w = int(frame_shape[0]), int(frame_shape[1])
        self.frame_hw = (h, w)
        self.in_channels = in_channels
        self.compute_dtype = compute_dtype
        self.input_shape = (in_channels, h, w)
        self.output_shape = int(n_actions)

        h1, w1 = _conv_out(h, 8, 4), _conv_out(w, 8, 4)
        h2, w2 = _conv_out(h1, 4, 2), _conv_out(w1, 4, 2)
        if h2 < 1 or w2 < 1:
            raise ValueError(f"frames of {h}x{w} leave the second conv no output (20x20 at least)")
        self.flat_features = 32 * h2 * w2

        f32 = np.float32
        A = self.output_shape
        self._weight_shapes = [
            ("conv1", (16, in_channels, 8, 8)),
            ("bn1", (16,)),
            ("conv2", (32, 16, 4, 4)),
            ("bn2", (32,)),
            ("fc", (256, self.flat_features)),
            ("bn3", (256,)),
            ("head", (A, 256)),
        ]
        self._bns = ("bn1", "bn2", "bn3")
        # torch registration order: conv1, bn1, conv2, bn2, fc, bn3, head
        param_entries, state_entries = [], []
        for name, wshape in self._weight_shapes:
            b = wshape[0]
            param_entries += [((name, "w"), wshape, f32), ((name, "b"), (b,), f32)]
            state_entries += [((name, "w"), wshape, f32), ((name, "b"), (b,), f32)]
            if name in self._bns:
                state_entries += [((name, "mean"), (b,), f32), ((name, "var"), (b,), f32),
                                  ((name, "n"), (), f32)]
        self.param_spec = FlatSpec.make(param_entries)
        self.state_spec = FlatSpec.make(state_entries)

    def init(self, seed: int) -> Tuple[Params, State]:
        """The JAX model's init, draw for draw (numpy normc over every
        weighted layer in module order, BN scales included), on ``device``."""
        weights = normc_layers([s for _, s in self._weight_shapes], seed)
        t = lambda a: torch.as_tensor(a, device=self.device)
        params: Params = {}
        state: State = {}
        for (name, wshape), w in zip(self._weight_shapes, weights):
            params[name] = {"w": t(w), "b": t(np.zeros(wshape[0], np.float32))}
            if name.startswith("bn"):
                state[name] = {
                    "mean": t(np.zeros(wshape[0], np.float32)),
                    "var": t(np.ones(wshape[0], np.float32)),
                    "n": t(np.zeros((), np.float32)),
                }
        return params, state

    # -- forward -----------------------------------------------------------------

    def _features(self, params, state, x: torch.Tensor, new_state=None) -> torch.Tensor:
        """Logits [M, N, A] of frames x [M, N, C, H, W]; with ``new_state``
        (a dict) the BNs run in training mode and their refreshed statistics
        land there."""
        cd = self.compute_dtype

        def bn(name, v, two_d):
            if new_state is None:
                return (batchnorm2d_eval if two_d else layers.batchnorm_eval)(
                    params[name], state[name], v)
            v, new_state[name] = (batchnorm2d_train if two_d else layers.batchnorm_train)(
                params[name], state[name], v)
            return v

        x = torch.relu(bn("bn1", conv2d(params["conv1"], x, 4, cd), True))
        x = torch.relu(bn("bn2", conv2d(params["conv2"], x, 2, cd), True))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = torch.relu(bn("bn3", layers.linear(params["fc"], x, compute_dtype=cd), False))
        return layers.linear(params["head"], x)

    def _to_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """Frames [*frame], [N, *frame] (shared by the members) or [M, N,
        *frame], each frame (C, H, W) or channels-last (H, W, C) ->
        [M or 1, N, C, H, W] float32."""
        c, h, w = self.input_shape
        x = x.to(torch.float32)
        while x.ndim < 5:
            x = x[None]
        if tuple(x.shape[2:]) == (h, w, c):  # channels-last frames from wrappers
            x = x.permute(0, 1, 4, 2, 3)
        return x.reshape(x.shape[0], -1, c, h, w)

    def apply(self, params, state, x: torch.Tensor) -> torch.Tensor:
        return layers.softmax(self._features(params, state, self._to_nchw(x)))

    def entropy(self, params, state, xs) -> torch.Tensor:
        return layers.categorical_entropy(self.apply(params, state, xs)).mean(dim=-1)

    def strategy(self, params, state, zeta) -> torch.Tensor:
        return self.apply(params, state, zeta)

    def vbn(self, params, state, buffer: torch.Tensor, rewards=None) -> State:
        """The VBN refresh: one train-mode pass of the features over
        ``buffer`` at the weights of ``params``, a population of one.
        Unlike IMPALA's, it keeps ``compute_dtype``, as the JAX model's."""
        new_state = dict(state)
        self._features(params, state, self._to_nchw(buffer), new_state=new_state)
        return new_state

    # -- full-state (wire) view --------------------------------------------------

    def _merge_full(self, params, state):
        merged = {}
        for name, _ in self._weight_shapes:
            merged[name] = dict(params[name])
            if name in self._bns:
                merged[name].update(state[name])
        return merged

    def _split_full(self, merged):
        params, state = {}, {}
        for name, _ in self._weight_shapes:
            params[name] = {"w": merged[name]["w"], "b": merged[name]["b"]}
            if name in self._bns:
                state[name] = {k: merged[name][k] for k in ("mean", "var", "n")}
        return params, state

    # -- reference-construction metadata -----------------------------------------

    def reference_module_specs(self):
        c = self.in_channels
        A = self.output_shape
        return [
            ("conv2d", c, 16, 8, 8),
            ("conv2d", 16, 32, 4, 4),
            ("linear", self.flat_features, 256),
            ("linear", 256, A),
        ]

    def weighted_layer_names(self):
        return [n for n, _ in self._weight_shapes]

    def linear_names(self):
        return ["conv1", "conv2", "fc", "head"]
