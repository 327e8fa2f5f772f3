"""A plain IMPALA policy over a population of weights.

Espeholt et al. 2018 (arXiv:1802.01561), the deep network with an LSTM core
as the program lays it out: per frame x / 255, then for each stage a
BatchNorm, a 3x3 conv and a 3x3 max pool with stride 2, and two residual
blocks (BN, ReLU, conv, BN, ReLU, conv, plus the block's input); then ReLU,
flatten, BN, a linear layer to ``hidden``, ReLU, the previous reward
clipped to [-1, 1] appended, an LSTM cell of ``hidden`` units (gates i, f,
g, o), BN, a linear layer to the actions and a softmax.  Every BatchNorm
runs in inference mode on its initial statistics (mean 0, variance 1) with
a learned scale and shift per member.

Parameters are one flat float32 vector a member, in the layout of
:func:`leaves`; every leaf is a view of it.  Products are float32 with TF32
off unless ``precision`` says otherwise: ``"tf32"`` rounds both operands of
every product to TF32; ``"bf16"`` and ``"fp8"`` round both operands of the
convolutions and the first linear layer (the layers ``compute_dtype``
covers) to bfloat16 or to float8 e4m3 scaled per member.  Convolutions are
patches times weights, one batched product over the members.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
PRECISIONS = ("f32", "tf32", "bf16", "fp8")


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: Tuple[str, float]  # ("uniform", bound) or ("const", value)


def leaves(in_shape, channels, hidden: int, n_actions: int) -> List[Leaf]:
    """The flat layout: every leaf's name, shape and initial draw
    (PyTorch's defaults: BN scale 1 and shift 0, a conv's or linear layer's
    weight and bias uniform within 1 / sqrt(fan in), the LSTM's within
    1 / sqrt(hidden))."""
    c, h, w = in_shape
    out: List[Leaf] = []

    def bn(name, n):
        out.extend([Leaf(f"{name}.w", (n,), ("const", 1.0)), Leaf(f"{name}.b", (n,), ("const", 0.0))])

    def dense(name, shape):
        bound = 1.0 / math.sqrt(int(np.prod(shape[1:])))
        out.extend([Leaf(f"{name}.w", shape, ("uniform", bound)),
                    Leaf(f"{name}.b", shape[:1], ("uniform", bound))])

    in_ch = c
    for k, ch in enumerate(channels):
        bn(f"feat{k}_bn", in_ch)
        dense(f"feat{k}_conv", (ch, in_ch, 3, 3))
        in_ch = ch
        h, w = (h + 1) // 2, (w + 1) // 2
    for r in (1, 2):
        for k, ch in enumerate(channels):
            for j in (1, 2):
                bn(f"res{r}_{k}_bn{j}", ch)
                dense(f"res{r}_{k}_conv{j}", (ch, ch, 3, 3))
    flat = channels[-1] * h * w
    bn("fc_bn", flat)
    dense("fc", (hidden, flat))
    bound = 1.0 / math.sqrt(hidden)
    for name, shape in (("w_ih", (4 * hidden, hidden + 1)), ("w_hh", (4 * hidden, hidden)),
                        ("b_ih", (4 * hidden,)), ("b_hh", (4 * hidden,))):
        out.append(Leaf(f"lstm.{name}", shape, ("uniform", bound)))
    bn("policy_bn", hidden)
    dense("policy", (n_actions, hidden))
    return out


def offsets(layout: List[Leaf]) -> List[Tuple[str, int, int]]:
    """(name, start, end) of each leaf in the flat vector."""
    out, i = [], 0
    for leaf in layout:
        n = int(np.prod(leaf.shape))
        out.append((leaf.name, i, i + n))
        i += n
    return out


def initial_theta(layout: List[Leaf], seed: int, device) -> torch.Tensor:
    """The initial weights [d] from ``seed``: one uniform draw over the
    whole vector on ``device``, scaled leaf by leaf."""
    sizes = [int(np.prod(leaf.shape)) for leaf in layout]
    lo = torch.tensor([-leaf.init[1] if leaf.init[0] == "uniform" else leaf.init[1]
                       for leaf in layout], dtype=torch.float32, device=device)
    span = torch.tensor([2 * leaf.init[1] if leaf.init[0] == "uniform" else 0.0
                         for leaf in layout], dtype=torch.float32, device=device)
    reps = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    return torch.repeat_interleave(lo, reps) + u * torch.repeat_interleave(span, reps)


def unflatten(theta: torch.Tensor, layout: List[Leaf]) -> Dict[str, torch.Tensor]:
    """Leaves [M, *shape] viewing ``theta`` [M, d]."""
    return {name: theta[:, a:b].reshape((theta.shape[0],) + leaf.shape)
            for leaf, (name, a, b) in zip(layout, offsets(layout))}


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "tf32":  # to nearest, ties away from zero, as cvt.rna.tf32.f32
        return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":  # float8 e4m3 scaled per member, the member's largest at 448
        amax = x.abs().reshape(x.shape[0], -1).amax(1).clamp_min(1e-30)
        scale = (amax / 448.0).reshape((-1,) + (1,) * (x.ndim - 1))
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x


def _patches(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 patches of x [B, ci, H, W], zero outside: [B, 9 ci, H W] in
    ``F.unfold``'s order (channel, then row and column of the tap), made from
    nine shifted slices in a few launches whatever B is."""
    B, ci, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [xp[:, :, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, 2).reshape(B, 9 * ci, H * W)


class Policy:
    """The forward of ``in_shape`` frames through ``channels`` stages, a
    ``hidden``-unit core and ``n_actions`` actions, at ``precision``."""

    def __init__(self, in_shape, channels, hidden: int, n_actions: int, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.in_shape = tuple(in_shape)
        self.channels = tuple(channels)
        self.hidden = hidden
        self.n_actions = n_actions
        self.precision = precision
        self.layout = leaves(self.in_shape, self.channels, hidden, n_actions)
        self.d = sum(int(np.prod(leaf.shape)) for leaf in self.layout)

    def _r(self, x, wide: bool):
        """An operand of a product: ``wide`` marks the layers that
        ``compute_dtype`` covers."""
        if self.precision == "tf32" or (wide and self.precision in ("bf16", "fp8")):
            return _round(x, self.precision)
        return x

    def _conv(self, p, name, x):
        """x [M, N, ci, H, W] -> [M, N, co, H, W]."""
        w, b = p[f"{name}.w"], p[f"{name}.b"]
        M, N, ci, H, W = x.shape
        co = w.shape[1]
        pat = _patches(x.reshape(M * N, ci, H, W))                        # [M N, 9 ci, H W]
        pat = pat.reshape(M, N, 9 * ci, H * W).transpose(1, 2).reshape(M, 9 * ci, N * H * W)
        y = torch.bmm(self._r(w.reshape(M, co, 9 * ci), True), self._r(pat, True))
        y = y.reshape(M, co, N, H, W).transpose(1, 2)
        return y + b[:, None, :, None, None]

    @staticmethod
    def _bn(p, name, x):
        """BatchNorm on its initial statistics over the channels of x
        [M, N, C, H, W] or the features of x [M, N, F]."""
        shape = (x.shape[0], 1, -1, 1, 1) if x.ndim == 5 else (x.shape[0], 1, -1)
        scale = p[f"{name}.w"].reshape(shape) / math.sqrt(1.0 + BN_EPS)
        return x * scale + p[f"{name}.b"].reshape(shape)

    def features(self, p, frames: torch.Tensor) -> torch.Tensor:
        """frames [M, N, C, H, W] (raw pixels) -> [M, N, hidden]."""
        x = frames.to(torch.float32) / 255.0
        M, N = x.shape[:2]
        for k in range(len(self.channels)):
            x = self._conv(p, f"feat{k}_conv", self._bn(p, f"feat{k}_bn", x))
            y = F.max_pool2d(x.reshape((M * N,) + x.shape[2:]), 3, stride=2, padding=1)
            x = y.reshape((M, N) + y.shape[1:])
            for r in (1, 2):
                y = torch.relu(self._bn(p, f"res{r}_{k}_bn1", x))
                y = self._conv(p, f"res{r}_{k}_conv1", y)
                y = torch.relu(self._bn(p, f"res{r}_{k}_bn2", y))
                x = x + self._conv(p, f"res{r}_{k}_conv2", y)
        x = self._bn(p, "fc_bn", torch.relu(x).reshape(M, N, -1))
        x = torch.bmm(self._r(x, True), self._r(p["fc.w"], True).transpose(1, 2))
        return torch.relu(x + p["fc.b"][:, None])

    def core(self, p, feats, rewards, carry):
        """One LSTM step: feats [M, N, hidden], rewards [M, N], carry (h, c)
        [M, N, hidden] -> (h, c)."""
        x = torch.cat([feats, rewards.clamp(-1.0, 1.0)[..., None]], -1)
        h, c = carry
        gates = (torch.bmm(self._r(x, False), self._r(p["lstm.w_ih"], False).transpose(1, 2))
                 + p["lstm.b_ih"][:, None]
                 + torch.bmm(self._r(h, False), self._r(p["lstm.w_hh"], False).transpose(1, 2))
                 + p["lstm.b_hh"][:, None])
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def head(self, p, h) -> torch.Tensor:
        """Action probabilities [M, N, A] from the core's output."""
        x = self._bn(p, "policy_bn", h)
        logits = torch.bmm(self._r(x, False), self._r(p["policy.w"], False).transpose(1, 2))
        return torch.softmax(logits + p["policy.b"][:, None], -1)

    def step(self, p, frames, rewards, carry):
        """One timestep of each member's episodes: (probs [M, N, A], carry)."""
        h, c = self.core(p, self.features(p, frames), rewards, carry)
        return self.head(p, h), (h, c)

    def strategy(self, p, zeta: torch.Tensor, block: int = 64) -> torch.Tensor:
        """Each member's action probabilities over ``zeta`` [Z, C, H, W]
        read as one sequence with zero rewards, from a zero carry (the
        archive's behaviour signature): [M, Z, A], ``block`` members at a
        time."""
        out = []
        for m0 in range(0, next(iter(p.values())).shape[0], block):
            q = {k: v[m0:m0 + block] for k, v in p.items()}
            M = next(iter(q.values())).shape[0]
            feats = self.features(q, zeta[None].expand((M,) + tuple(zeta.shape)))
            h = c = torch.zeros((M, 1, self.hidden), device=zeta.device)
            zero = torch.zeros((M, 1), device=zeta.device)
            probs = []
            for t in range(zeta.shape[0]):
                h, c = self.core(q, feats[:, t:t + 1], zero, (h, c))
                probs.append(self.head(q, h))
            out.append(torch.cat(probs, 1))
        return torch.cat(out)
