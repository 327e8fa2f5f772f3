"""Novelty facade (reference strategy/strategy_handler.py:6-31).

Owns the archive and the current zeta, and answers "how novel is this
policy?" — the minimum behavioral distance from the policy's strategy on
zeta to every archived strategy.  The archive's bookkeeping stays on the
host (numpy); every strategy is evaluated on the model's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dfd_tpu_torch.novelty.archive import SparseHistoryArchive


class StrategyHandler:
    def __init__(
        self,
        model,
        bn_state,
        distance_fn: Callable,
        max_history_size: int = 200,
    ):
        """``model``: a PolicyModel; ``bn_state``: the shared non-trainable
        state used when evaluating archived flats; ``distance_fn(a, b, xp)``
        broadcasts over a leading archive axis of ``b``."""
        self.model = model
        self.bn_state = bn_state
        self.distance_fn = distance_fn
        self.zeta: Optional[np.ndarray] = None
        self.archive = SparseHistoryArchive(self._evaluate_flat, distance_fn, max_history_size)

    # -- archive management ------------------------------------------------------

    def add_policy(self, flat: np.ndarray):
        return self.archive.submit(flat)

    def set_zeta(self, zeta) -> None:
        if zeta is None or len(zeta) == 0:
            return
        self.zeta = np.asarray(zeta)
        self.archive.evaluate_strategies(self.zeta)

    @property
    def strategy_tensor(self):
        t = self.archive.strategy_tensor
        return t if isinstance(t, np.ndarray) else np.zeros(0)

    # -- queries -----------------------------------------------------------------

    def compute_novelty(self, flat: np.ndarray) -> float:
        if self.zeta is None or len(self.zeta) == 0 or len(self.strategy_tensor) < 2:
            return 0.0
        strategy = self._evaluate_flat(flat, self.zeta)
        dists = self.distance_fn(strategy, self.strategy_tensor)
        return float(np.min(dists))

    def compute_novelty_batch(self, flats: torch.Tensor, zeta) -> torch.Tensor:
        """Novelty of each of ``flats`` [K, d] against the archive, in one
        batched forward on the model's device: [K]; zeros below 2 entries."""
        dev = self.model.device
        flats = torch.as_tensor(flats, device=dev)
        t = self.strategy_tensor
        if self.zeta is None or len(t) < 2:
            return torch.zeros(flats.shape[0], dtype=torch.float32, device=dev)
        return novelty_batch(self.model, self.model.set_flat(flats), self.bn_state,
                             torch.as_tensor(np.asarray(zeta), device=dev),
                             torch.as_tensor(t, device=dev), len(t), self.distance_fn)

    # -- internals ---------------------------------------------------------------

    def _evaluate_flat(self, flat, zeta) -> np.ndarray:
        dev = self.model.device
        params = self.model.set_flat(torch.as_tensor(np.asarray(flat), device=dev)[None])
        strat = self.model.strategy(params, self.bn_state, torch.as_tensor(np.asarray(zeta), device=dev))
        return strat[0].cpu().numpy()


def novelty_batch(model, params, bn_state, zeta: torch.Tensor, archive: torch.Tensor,
                  count: int, distance_fn) -> torch.Tensor:
    """Each member's minimum behavioral distance to the first ``count``
    strategies of ``archive`` [H, Z, F] (zero-padded beyond them): [M] for
    population ``params`` of M members; zeros below 2 entries, and then, like
    the reference's guard (strategy_handler.py:25-31), no forward at all."""
    M = next(iter(params.values()))["w"].shape[0]
    if count < 2:
        return torch.zeros(M, dtype=torch.float32, device=archive.device)
    strat = model.strategy(params, bn_state, zeta)
    dists = distance_fn(strat[:, None], archive[None], xp=torch)  # [M, H]
    idx = torch.arange(archive.shape[0], device=archive.device)
    return torch.where(idx < count, dists, torch.inf).amin(dim=1)
