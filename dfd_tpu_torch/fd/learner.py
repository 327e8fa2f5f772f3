"""The finite-difference learner (reference learner/finite_differences.py),
the host class of the sequential topology: numpy, a copy of
``dfd_tpu.fd.learner.FDLearner``, so that it matches it bit for bit.

Turns a batch of (encoded perturbation, episodic return) pairs into one
optimizer step:

1. decode each return's noise and drift-correct it for staleness:
   ``lambda = sigma * eps + (theta_at_its_epoch - theta_now)`` using a
   distance map over the recent policy history; returns older than the map
   are discarded (reference :80-92);
2. normalize each lambda by its squared norm (so the combine is a
   finite-difference quotient, not a plain ES estimator);
3. subtract the EMA policy-reward baseline from rewards and standardize;
4. ``g = sum_i fitness_i * lambda_hat_i`` — a *sum*, not a mean: the
   reference's ``/ len(batch)`` result is discarded (finite_differences.py:49),
   which is harmless under DSGD's norm-normalization and is reproduced here
   deliberately for parity;
5. step the optimizer with grad = -g (net ascent) after adjusting its lr
   scale from omega; rebuild the distance map and ring policy history.

The population trainer's combine over tensors lives in
:mod:`dfd_tpu_torch.fd.combine`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from dfd_tpu_torch.fd.dsgd import DSGD
from dfd_tpu_torch.fd.returns import FDReturn
from dfd_tpu_torch.ops.standardize import standardize_host


class FDLearner:
    def __init__(
        self,
        flat_params: np.ndarray,
        optimizer,
        omega,
        noise_source,
        noise_std: float = 0.1,
        batch_size: int = 100,
        ent_coef: float = 0.0,
        max_delayed_return: int = 10,
    ):
        self.flat = np.asarray(flat_params, np.float32).copy()
        self.optimizer = optimizer
        self.omega = omega
        self.noise_source = noise_source
        self.noise_std = noise_std
        self.batch_size = batch_size
        self.ent_coef = ent_coef
        self.max_delayed_return = max_delayed_return

        self.epoch = 0
        self.discarded_returns = 0
        self.policy_history: List[Tuple[np.ndarray, int]] = [(self.flat.copy(), 0)]
        self.dist_map = {0: 0}
        self._using_dsgd = isinstance(optimizer, DSGD)

    # -- public ------------------------------------------------------------------

    def step(
        self,
        batch: List[FDReturn],
        policy_reward: Optional[float],
        policy_novelty: Optional[float],
        policy_entropy: Optional[float],
    ) -> float:
        """Consume a batch of non-eval returns; returns the update magnitude
        (0 when the whole batch was discarded)."""
        rewards, novelties, entropies, perturbations = self._process_returns(batch)
        if policy_reward is None:
            policy_reward = 0.0
        if len(rewards) == 0:
            return 0.0

        objective = standardize_host(np.subtract(rewards, policy_reward))

        gradient = np.dot(objective, perturbations)  # sum over batch (see module doc)

        if self._using_dsgd:
            self.optimizer.adjust_lr(self.omega)

        old_flat = self.flat
        self.flat = self.optimizer.step(old_flat, np.negative(gradient))
        update_size = float(np.linalg.norm(old_flat - self.flat))
        self.epoch += 1

        self._build_distance_map()
        self._update_policy_history()
        return update_size

    # -- internals ---------------------------------------------------------------

    def _build_distance_map(self) -> None:
        self.dist_map.clear()
        self.dist_map[self.epoch] = 0
        for params, epoch in self.policy_history:
            self.dist_map[epoch] = params - self.flat

    def _update_policy_history(self) -> None:
        self.policy_history.append((self.flat.copy(), self.epoch))
        while len(self.policy_history) > self.max_delayed_return:
            self.policy_history.pop(0)

    def _adjust_return(self, ret: FDReturn) -> bool:
        if ret.epoch not in self.dist_map:
            return False
        eps = self.noise_source.decode(ret.encoded_noise)
        ret.perturbation = eps * self.noise_std + self.dist_map[ret.epoch]
        return True

    def _process_returns(self, batch: List[FDReturn]):
        rewards, novelties, entropies, perturbations = [], [], [], []
        for ret in batch:
            if not self._adjust_return(ret):
                self.discarded_returns += 1
                continue
            norm = np.linalg.norm(ret.perturbation)
            rewards.append(ret.reward)
            novelties.append(ret.novelty)
            entropies.append(ret.entropy)
            perturbations.append(ret.perturbation / (norm * norm))
        return rewards, novelties, entropies, perturbations
