"""Layer functions over a population of weights.

Parameters follow the torch memory layout (Linear weights are (out, in)) so
that flat views match the reference's ``parameters_to_vector`` order, and
carry an explicit leading population axis ``[M]``: a Linear weight is
``[M, d_out, d_in]`` and its input ``[M, N, d_in]``.  One batched matrix
product serves the whole population where the JAX package vmaps a
per-member forward.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


ROUNDED = "w_rounded"  # a layer's weight rounded to its compute dtype and back, made once


def rounded(v: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``v`` rounded to ``compute_dtype`` and back to float32 (``v`` itself
    for None): the operand of a product taken in float32."""
    return v if compute_dtype is None else v.to(compute_dtype).to(torch.float32)


def weight_operand(p: Dict[str, torch.Tensor], compute_dtype) -> torch.Tensor:
    """The layer's weight as its product's operand: ``p["w"]`` for None;
    else the image ``p[ROUNDED]`` where the layer carries one (a model's
    ``prepare`` rounds it once for a run of forwards), or ``p["w"]``
    rounded now.  The two are equal bit for bit."""
    if compute_dtype is None:
        return p["w"]
    w = p.get(ROUNDED)
    return rounded(p["w"], compute_dtype) if w is None else w


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x @ w.T + b per member: x [M, N, d_in], w [M, d_out, d_in], b [M, d_out].

    ``compute_dtype=torch.bfloat16`` rounds both operands to bf16 and takes
    the product in float32, as the JAX package's bf16 dot with
    ``preferred_element_type=float32`` does (a bf16 product would also round
    its output); the bias is added after.  The weight's rounding is the
    image ``p[ROUNDED]`` where ``p`` carries one (:func:`weight_operand`)."""
    if compute_dtype is not None:
        w = weight_operand(p, compute_dtype)
        return torch.bmm(rounded(x, compute_dtype), w.transpose(1, 2)) + p["b"].unsqueeze(1)
    return torch.baddbmm(p["b"].unsqueeze(1), x, p["w"].transpose(1, 2))


def lstm_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
              carry: Tuple[torch.Tensor, torch.Tensor]):
    """torch-layout LSTM cell, gates ordered (i, f, g, o), per member:
    x [M, N, d_in], carry (h, c) [M, N, H].  Returns (h, (h, c)); the gate
    sums are taken in the JAX package's order."""
    h, c = carry
    gates = torch.bmm(x, p["w_ih"].transpose(1, 2)) + p["b_ih"].unsqueeze(1)
    gates = gates + torch.bmm(h, p["w_hh"].transpose(1, 2))
    gates = gates + p["b_hh"].unsqueeze(1)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def batchnorm_eval(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in inference mode: running statistics ``s`` shared by the
    population, affine ``p`` per member ([M, d])."""
    return (x - s["mean"]) / torch.sqrt(s["var"] + BN_EPS) * p["w"].unsqueeze(1) + p["b"].unsqueeze(1)


def batchnorm_train(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm in training mode, the VBN refresh (reference
    policies/policy.py:31-34): x [1, N, d], one member's rows (the running
    statistics are shared by the population, so they are refreshed at one
    set of weights), affine ``p`` [1, d].

    Normalizes by the batch statistics, the variance biased and taken as the
    mean of squared deviations, as the JAX package takes it; folds them into
    the running statistics with momentum ``BN_MOMENTUM``, the variance
    unbiased by ``n / max(n - 1, 1)``, and counts ``n``.  Returns (y, new
    statistics)."""
    if x.ndim != 3 or x.shape[0] != 1:
        raise ValueError(f"batchnorm_train takes one member's rows [1, N, d], got {tuple(x.shape)}")
    n = x.shape[1]
    mean_b = x.mean(dim=1)
    var_biased = ((x - mean_b[:, None]) ** 2).mean(dim=1)
    y = (x - mean_b[:, None]) / torch.sqrt(var_biased[:, None] + BN_EPS) * p["w"].unsqueeze(1) \
        + p["b"].unsqueeze(1)
    var_unbiased = var_biased[0] * (n / max(n - 1, 1))
    new_s = {
        "mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean_b[0],
        "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * var_unbiased,
        "n": s["n"] + 1,
    }
    return y, new_s


def softmax(x: torch.Tensor) -> torch.Tensor:
    x = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=-1, keepdim=True)


def categorical_entropy(probs: torch.Tensor) -> torch.Tensor:
    """-sum p log p per row (0 log 0 := 0), matching torch's clamped form."""
    pos = probs > 0
    plogp = torch.where(pos, probs * torch.log(torch.where(pos, probs, 1.0)), 0.0)
    return -plogp.sum(dim=-1)


# 0.5 + 0.5 log(2 pi) in float32 as the JAX package computes it: log of the
# float32 2 pi correctly rounded (numpy's float32 log is one ulp off here)
_GAUSSIAN_ENTROPY_CONST = float(np.float32(0.5) + np.float32(0.5)
                                * np.float32(math.log(np.float32(2 * np.pi))))


def gaussian_entropy(std: torch.Tensor) -> torch.Tensor:
    """Per-dimension Normal entropy 0.5 + 0.5 log(2 pi) + log std."""
    return _GAUSSIAN_ENTROPY_CONST + torch.log(std)


def map_continuous_to_action(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh head: the first half is the mean in [-1, 1]; the second maps to
    a stddev in [0.1, 1.0] (reference utils/torch_helpers.py:15-25)."""
    t = torch.tanh(y)
    n = t.shape[-1] // 2
    return t[..., :n], 0.55 + 0.45 * t[..., n:]
