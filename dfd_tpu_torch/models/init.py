"""Weight initialization schemes.

``normc_init`` reproduces the reference's default initializer draw-for-draw
(reference policies/policy.py:88-115): a single ``numpy.random.RandomState``
visits every weighted layer in registration order — note this *includes*
BatchNorm scale vectors, which end up normalized to unit L2 norm — draws a
standard-normal tensor of the torch weight shape, and rescales each column
(axis 0) to norm ``gain``; the final weighted layer uses the small action
gain.  Biases (and BatchNorm shifts) are zeroed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

MODEL_GAIN = 1.0
ACTION_GAIN = 0.01


def normc_layers(shapes: List[Tuple[int, ...]], seed: int) -> List[np.ndarray]:
    """Generate normc weight tensors for the given ordered weight shapes."""
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(shapes):
        gain = ACTION_GAIN if i == len(shapes) - 1 else MODEL_GAIN
        w = rng.randn(*shape).astype(np.float32)
        w *= gain / np.sqrt(np.square(w).sum(axis=0, keepdims=True))
        out.append(w)
    return out



def orthogonal(shape: Tuple[int, int], gain: float, rng: np.random.RandomState) -> np.ndarray:
    """Orthogonal init (PPO/A2C-style; the reference's unused alternative,
    policies/policy.py:117-147).  Not draw-parity with torch."""
    rows, cols = shape
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return (gain * q[:rows, :cols]).astype(np.float32)
