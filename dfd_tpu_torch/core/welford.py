"""Streaming observation statistics (Welford / Chan parallel merge), the
two forms of ``dfd_tpu.core.welford``:

- :class:`Welford`, the host class of the sequential topology: numpy, a
  copy of the JAX package's, so it matches it (and the reference's
  ``WelfordRunningStat``) bit for bit;
- the functional form over tensors (:class:`WelfordState`, :func:`init`,
  :func:`update_batch`, :func:`merge`, :func:`mean_std`) that the
  population trainer runs on the device.

A :class:`WelfordState` may carry leading batch axes: ``count`` has shape
``[*B]`` and ``mean``/``m2`` have shape ``[*B, *obs]``.  The rollout keeps
one state per population member this way, where the JAX package vmaps the
unbatched form.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class Welford:
    """Host-side running mean/variance with mergeable partial updates."""

    def __init__(self, shape):
        self.shape = shape
        self.running_mean = np.zeros(shape, dtype=np.float32)
        self.running_variance = np.zeros(shape, dtype=np.float32)  # sum of squared deviations (M2)
        self.count = 0

    # -- single / batched updates ------------------------------------------------

    def update(self, sample) -> None:
        if isinstance(sample, dict):  # IMPALA-style dict observations
            sample = sample["frame"]
        prev = self.count
        self.count += 1
        delta = (np.asarray(sample) - self.running_mean).reshape(self.running_mean.shape)
        delta_n = (delta / self.count).reshape(self.running_mean.shape)
        self.running_mean += delta_n
        self.running_variance += delta * delta_n * prev

    def increment(self, samples, num: int) -> None:
        if num > 1:
            for i in range(num):
                self.update(samples[i])
        else:
            self.update(samples)

    def reset(self) -> None:
        self.__init__(self.shape)

    # -- guarded views -----------------------------------------------------------

    @property
    def mean(self) -> np.ndarray:
        if self.count < 2:
            return np.zeros(self.shape, dtype=np.float32)
        return self.running_mean

    @property
    def std(self) -> np.ndarray:
        if self.count < 2:
            return np.ones(self.shape, dtype=np.float32)
        var = self.running_variance / (self.count - 1)
        # A zero-variance feature is constant; dividing by 1 leaves it constant
        # and (x - mean)/std then standardizes it to exactly zero.
        var = np.where(var == 0, 1.0, var)
        return np.sqrt(var)

    # -- parallel merge ----------------------------------------------------------

    def merge_serialized(self, update) -> None:
        """Fold a serialized partial statistic (``serialize()`` format) in."""
        n = int(np.prod(self.shape))
        other_mean = np.asarray(update[:n], dtype=np.float32).reshape(self.running_mean.shape)
        other_m2 = np.asarray(update[n:-1], dtype=np.float32).reshape(self.running_variance.shape)
        other_count = update[-1]
        if other_count == 0:
            return
        total = self.count + other_count
        delta = other_mean - self.running_mean
        self.running_mean = (self.count * self.running_mean + other_count * other_mean) / total
        self.running_variance = (
            self.running_variance + other_m2 + delta * delta * self.count * other_count / total
        )
        self.count = total

    # -- wire format -------------------------------------------------------------

    def serialize(self):
        return (
            self.running_mean.ravel().tolist()
            + self.running_variance.ravel().tolist()
            + [self.count]
        )

    def deserialize(self, data) -> None:
        self.reset()
        n = int(np.prod(self.shape))
        self.running_mean = np.reshape(np.asarray(data[:n], dtype=np.float32), self.shape)
        self.running_variance = np.reshape(np.asarray(data[n:-1], dtype=np.float32), self.shape)
        self.count = data[-1]


# ---------------------------------------------------------------------------
# Functional form over tensors
# ---------------------------------------------------------------------------


class WelfordState(NamedTuple):
    mean: torch.Tensor   # running mean, shape [*B, *obs]
    m2: torch.Tensor     # sum of squared deviations
    count: torch.Tensor  # float32, shape [*B]


def init(shape, device, batch: Tuple[int, ...] = ()) -> WelfordState:
    full = tuple(batch) + tuple(shape)
    return WelfordState(
        mean=torch.zeros(full, dtype=torch.float32, device=device),
        m2=torch.zeros(full, dtype=torch.float32, device=device),
        count=torch.zeros(tuple(batch), dtype=torch.float32, device=device),
    )


def _bc(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Right-pad ``x`` [*B] with unit axes to broadcast against [*B, *obs]."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def update_batch(state: WelfordState, xs: torch.Tensor, mask: torch.Tensor) -> WelfordState:
    """Fold a batch of samples with a 0/1 per-sample mask.

    The sample axis is the one right after the state's batch axes: ``xs`` is
    ``[*B, N, *obs]`` and ``mask`` ``[*B, N]``.  The batch's (count, mean, M2)
    is computed in one shot and Chan-merged into the running state, as in
    the JAX package."""
    axis = state.count.ndim
    mask = mask.to(torch.float32)
    n_b = mask.sum(dim=axis)
    w = _bc(mask, xs)
    safe_n = torch.clamp_min(n_b, 1.0)
    mean_b = (xs * w).sum(dim=axis) / _bc(safe_n, state.mean)
    m2_b = (w * (xs - mean_b.unsqueeze(axis)) ** 2).sum(dim=axis)
    return merge(state, WelfordState(mean=mean_b, m2=m2_b, count=n_b))


def merge(a: WelfordState, b: WelfordState) -> WelfordState:
    total = a.count + b.count
    safe_total = _bc(torch.clamp_min(total, 1.0), a.mean)
    ca, cb = _bc(a.count, a.mean), _bc(b.count, a.mean)
    delta = b.mean - a.mean
    mean = (ca * a.mean + cb * b.mean) / safe_total
    m2 = a.m2 + b.m2 + delta * delta * ca * cb / safe_total
    # If either side is empty, keep the other side untouched.
    has = _bc(total > 0, a.mean)
    return WelfordState(
        mean=torch.where(has, mean, a.mean), m2=torch.where(has, m2, a.m2), count=total
    )


def merge_population(states: WelfordState) -> WelfordState:
    """Merge a population-stacked state (leading axis) into one; further
    batch axes are kept (``count`` [N, *B] merges into [*B]).

    The JAX package folds the members in one at a time (a ``lax.scan`` of
    :func:`merge`); on the card that would be thousands of launches.  This is
    the same total in closed form -- ``mean = sum(n_i mean_i) / n`` and
    ``M2 = sum(M2_i) + sum(n_i (mean_i - mean)^2)`` -- summed in float64 and
    rounded once, so it differs from the sequential fold only by the fold's
    own float32 rounding."""
    c = states.count.to(torch.float64)
    mean_i = states.mean.to(torch.float64)
    total = c.sum(dim=0)
    cw = _bc(c, mean_i)
    mean = (cw * mean_i).sum(dim=0) / _bc(torch.clamp_min(total, 1.0), mean_i[0])
    m2 = states.m2.to(torch.float64).sum(dim=0) + (cw * (mean_i - mean) ** 2).sum(dim=0)
    return WelfordState(
        mean=mean.to(torch.float32), m2=m2.to(torch.float32), count=total.to(torch.float32)
    )


def mean_std(state: WelfordState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Guarded (mean, std) matching the reference's count<2 / zero-var rules."""
    have = _bc(state.count >= 2, state.mean)
    mean = torch.where(have, state.mean, torch.zeros_like(state.mean))
    var = state.m2 / _bc(torch.clamp_min(state.count - 1.0, 1.0), state.m2)
    var = torch.where(var == 0, torch.ones_like(var), var)
    std = torch.where(have, torch.sqrt(var), torch.ones_like(var))
    return mean, std
