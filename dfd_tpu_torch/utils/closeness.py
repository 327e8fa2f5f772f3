"""The closeness rule for BatchNorm statistics, in one place for every check
that holds two ``bn_state`` trees together (the card against the CPU, the
port against the JAX package).

A mean or var vector summed over many positions in another order agrees to
``rtol`` of each element, but an element near 0 only to ``rtol`` of the
vector's largest magnitude; the counts ``n`` are exact.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

BN_RTOL = 1e-5


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


def bn_state_mismatch(got, want, rtol: float = BN_RTOL) -> Tuple[List[str], float]:
    """``got`` against ``want`` ({layer: {"mean", "var", "n"}}, tensors or
    arrays): each mean and var element within ``rtol`` of itself plus an atol
    of ``rtol`` of its vector's largest magnitude in ``want``; ``n`` equal.
    Returns a message for each vector outside the rule (none when they agree)
    and the largest |d| relative to its vector's largest magnitude."""
    if set(got) != set(want):
        return [f"layers {sorted(got)} against {sorted(want)}"], float("inf")
    faults, worst = [], 0.0
    for layer in want:
        for k in ("mean", "var"):
            g, w = _f64(got[layer][k]), _f64(want[layer][k])
            if g.shape != w.shape:
                faults.append(f"{layer}.{k}: shape {tuple(g.shape)} against {tuple(w.shape)}")
                continue
            scale = w.abs().max().item()
            d = (g - w).abs()
            if not torch.all(d <= rtol * scale + rtol * w.abs()):
                faults.append(f"{layer}.{k}: max |d| {d.max().item()} at scale {scale}")
            worst = max(worst, d.max().item() / max(scale, 1e-30))
        if not torch.equal(_f64(got[layer]["n"]), _f64(want[layer]["n"])):
            faults.append(f"{layer}.n: {got[layer]['n']} against {want[layer]['n']}")
    return faults, worst
