"""DSGD — normalized "dynamic SGD" (reference dsgd/dynamic_sgd.py:7-51).

    theta <- theta - lr * sqrt(d) * lr_scale(omega) * grad / ||grad||

The FD learner hands it ``grad = -g`` (g being the fitness-weighted noise
combine), so the net effect is ascent along g.  ``lr_scale`` affine-maps
omega from [omega_min, omega_max] to [min_scale, max_scale].

Two forms, as in ``dfd_tpu.fd.dsgd``: the host classes :class:`DSGD` and
:class:`SGD` of the sequential topology (numpy float32, copies of the JAX
package's), and :func:`dsgd_update` over tensors for the population trainer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dfd_tpu_torch.ops.standardize import affine_transform


class DSGD:
    """Host-side optimizer over a flat float32 parameter vector."""

    def __init__(self, num_params: int, lr: float, min_scale: float = 0.23, max_scale: float = 1.0):
        self.lr = lr
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.coef = float(np.sqrt(num_params))
        self.lr_scale = 1.0
        self.steps = 0

    def adjust_lr(self, omega) -> None:
        self.lr_scale = affine_transform(
            omega.omega, omega.min_omega, omega.max_omega, self.min_scale, self.max_scale
        )

    def step(self, flat: np.ndarray, grad: np.ndarray) -> np.ndarray:
        grad = np.asarray(grad, dtype=np.float32)
        norm = float(np.linalg.norm(grad))
        if not norm > 0:
            raise FloatingPointError("DSGD received a gradient with zero (or NaN) norm")
        coef = float(self.lr * self.coef * self.lr_scale / norm)
        self.steps += 1
        return np.asarray(flat, np.float32) - np.float32(coef) * grad


class SGD:
    """Plain SGD over a flat vector (the reference's ``opt_fn`` alternative)."""

    def __init__(self, num_params: int, lr: float):
        self.lr = lr
        self.steps = 0

    def adjust_lr(self, omega) -> None:
        pass

    def step(self, flat: np.ndarray, grad: np.ndarray) -> np.ndarray:
        self.steps += 1
        return np.asarray(flat, np.float32) - np.float32(self.lr) * np.asarray(grad, np.float32)


class DSGDParams(NamedTuple):
    lr: float
    sqrt_d: float
    min_scale: float
    max_scale: float


def dsgd_update(flat: torch.Tensor, grad: torch.Tensor, lr_scale, hp: DSGDParams) -> torch.Tensor:
    """One DSGD step.  A zero-norm gradient yields a zero update (branch-free,
    no host synchronisation)."""
    norm = torch.sqrt(torch.sum(grad * grad))
    coef = hp.lr * hp.sqrt_d * lr_scale / torch.clamp_min(norm, 1e-30)
    coef = torch.where(norm > 0, coef, torch.zeros_like(coef))
    return flat - coef * grad


def lr_scale_from_omega(omega, omega_min, omega_max, min_scale=0.23, max_scale=1.0):
    return affine_transform(omega, omega_min, omega_max, min_scale, max_scale)
