"""Scalar/vector normalization primitives (reference utils/math_helpers.py:127-144)."""

from __future__ import annotations

import numpy as np
import torch


def population_std(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean((x - mean)^2)): the biased std, in the JAX package's order."""
    return torch.sqrt(((x - x.mean()) ** 2).mean())


def standardize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean)/std; returns x unchanged when std == 0 (branch-free)."""
    m = x.mean()
    s = population_std(x)
    safe = torch.where(s == 0, torch.ones_like(s), s)
    return torch.where(s == 0, x, (x - m) / safe)


def standardize_host(arr) -> np.ndarray:
    """The host learner's numpy form, branchy like the reference: (x -
    mean)/std, or x unchanged when std == 0."""
    x = np.asarray(arr)
    m = x.mean()
    s = x.std()
    if s == 0:
        return x
    return (x - m) / s


def affine_transform(value, from_min, from_max, to_min, to_max):
    """Map ``value`` from [from_min, from_max] to [to_min, to_max].

    Degenerate ranges collapse to ``to_min`` (matching the reference's guard).
    Works on python scalars and tensors alike when ranges are python numbers.
    """
    if from_max == from_min or to_max == to_min:
        return to_min
    return (value - from_min) * (to_max - to_min) / (from_max - from_min) + to_min
