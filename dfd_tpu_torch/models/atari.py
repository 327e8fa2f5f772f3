"""Pieces of ``dfd_tpu.models.atari`` that other models share.

Only :func:`batchnorm2d_eval` so far, kept here because the JAX package
keeps it here; ``AtariCNN`` itself is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict

import torch

from dfd_tpu_torch.models import layers


def batchnorm2d_eval(p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d in inference mode over x [M, B, C, H, W]: running
    statistics ``s`` [C] shared by the population, affine ``p`` [M, C] per
    member."""
    bc = lambda v: v[:, None, None]                     # [C] -> [C, 1, 1]
    pc = lambda v: v[:, None, :, None, None]            # [M, C] -> [M, 1, C, 1, 1]
    return (x - bc(s["mean"])) / torch.sqrt(bc(s["var"]) + layers.BN_EPS) * pc(p["w"]) + pc(p["b"])
