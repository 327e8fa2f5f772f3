"""Layer functions over a population of weights.

Parameters follow the torch memory layout (Linear weights are (out, in)) so
that flat views match the reference's ``parameters_to_vector`` order, and
carry an explicit leading population axis ``[M]``: a Linear weight is
``[M, d_out, d_in]`` and its input ``[M, N, d_in]``.  One batched matrix
product serves the whole population where the JAX package vmaps a
per-member forward.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

BN_EPS = 1e-5


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x @ w.T + b per member: x [M, N, d_in], w [M, d_out, d_in], b [M, d_out].

    ``compute_dtype=torch.bfloat16`` rounds both operands to bf16 and takes
    the product in float32, as the JAX package's bf16 dot with
    ``preferred_element_type=float32`` does (a bf16 product would also round
    its output); the bias is added after."""
    if compute_dtype is not None:
        r = lambda v: v.to(compute_dtype).to(torch.float32)
        return torch.bmm(r(x), r(p["w"]).transpose(1, 2)) + p["b"].unsqueeze(1)
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


def softmax(x: torch.Tensor) -> torch.Tensor:
    x = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=-1, keepdim=True)


def categorical_entropy(probs: torch.Tensor) -> torch.Tensor:
    """-sum p log p per row (0 log 0 := 0), matching torch's clamped form."""
    pos = probs > 0
    plogp = torch.where(pos, probs * torch.log(torch.where(pos, probs, 1.0)), 0.0)
    return -plogp.sum(dim=-1)
