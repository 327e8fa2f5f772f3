"""Behavioral-distance functions between policy "strategies".

A strategy is a policy's behavior signature over the state set zeta: for a
categorical policy the action-probability matrix [Z, A]; for a Gaussian one
the concatenated (mean, std) matrix [Z, 2A] (reference
policies/discrete.py:31-32, policies/mujoco.py:29-30).  Each distance
reduces over actions or features, then averages over zeta, broadcasting over
leading axes (reference utils/math_helpers.py:147-222).  The ``xp`` argument
selects numpy (the host archive) or torch (the population on the device), as
in ``dfd_tpu.ops.distances``.
"""

from __future__ import annotations

import numpy as np
import torch


def l2_dist(a, b, xp=np):
    diff = b - a
    if xp is np:
        norm = np.linalg.norm(diff, axis=-1)
    else:
        norm = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return norm.mean(axis=-1)


def categorical_tvd(p, q, xp=np):
    """Total variation distance (up to the missing 1/2), mean over zeta."""
    return xp.abs(p - q).sum(axis=-1).mean(axis=-1)


def categorical_bhattacharyya(p, q, xp=np):
    bc = xp.sqrt(p * q).sum(axis=-1)
    return (-xp.log(bc + 1e-12)).mean(axis=-1)


def _split_gaussian(strategy):
    n = strategy.shape[-1] // 2
    return strategy[..., :n], strategy[..., n:]


def gaussian_bhattacharyya(strategy_a, strategy_b, xp=np):
    m1, s1 = _split_gaussian(strategy_a)
    m2, s2 = _split_gaussian(strategy_b)
    s3 = (s1 + s2) / 2
    det1 = s1.prod(axis=-1)
    det2 = s2.prod(axis=-1)
    det3 = s3.prod(axis=-1)
    d = m1 - m2
    mean_term = (d * d / s3).sum(axis=-1)
    log_term = det3 / xp.sqrt(det1 * det2)
    return (mean_term / 8 + log_term / 4).mean(axis=-1)


def gaussian_wasserstein(m1, s1, m2, s2, xp=np):
    inside_trace = s1 + s2 - 2 * xp.sqrt(s1 * s2)
    d = m1 - m2
    return (d * d).sum(axis=-1) + inside_trace.sum(axis=-1)


def gaussian_wasserstein_from_strategies(strategy_a, strategy_b, xp=np):
    m1, s1 = _split_gaussian(strategy_a)
    m2, s2 = _split_gaussian(strategy_b)
    return gaussian_wasserstein(m1, s1, m2, s2, xp=xp).mean(axis=-1)


DISTANCES = {
    "l2": l2_dist,
    "categorical_tvd": categorical_tvd,
    "categorical_bhattacharyya": categorical_bhattacharyya,
    "gaussian_bhattacharyya": gaussian_bhattacharyya,
    "gaussian_wasserstein": gaussian_wasserstein_from_strategies,
}


def strategy_novelty(strategy, archive, distance_fn=l2_dist, xp=np, return_all=False):
    """Min distance from one strategy [Z, F] to every archived strategy
    [H, Z, F] (the reference's ``compute_strategy_novelty``,
    utils/math_helpers.py:147-155); a float with numpy, a tensor with torch."""
    dists = distance_fn(strategy, archive, xp=xp)
    m = xp.min(dists)
    m = m.item() if xp is np else m
    if return_all:
        return m, dists
    return m


def strategy_distance(strategy_a, strategy_b, distance_fn=l2_dist, xp=np):
    d = distance_fn(strategy_a, strategy_b, xp=xp)
    return d.item() if xp is np else d
