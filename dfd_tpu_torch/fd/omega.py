"""Adaptive omega schedule (reference utils/adaptive_omega.py:5-53).

Omega tracks reward stagnation: each step compares the policy's reward to a
threshold-scaled mean of recent rewards (sign-aware).  Improvement walks
omega down by 1/steps_to_min, stagnation walks it up by 1/steps_to_max,
clamped to [min, max].  Both values are rounded to 5 decimals first.

Two forms, as in ``dfd_tpu.fd.omega``: the host class
:class:`AdaptiveOmega` of the sequential topology (a copy of the JAX
package's), and the functional form with a fixed-size reward ring buffer
over tensors for the population trainer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdaptiveOmega:
    def __init__(
        self,
        default_value: float = 0,
        improvement_threshold: float = 1.025,
        reward_history_size: int = 10,
        min_value: float = 0,
        max_value: float = 1,
        steps_to_min: int = 15,
        steps_to_max: int = 200,
    ):
        self.omega = default_value
        self.improvement_threshold = improvement_threshold
        self.reward_history_size = reward_history_size
        self.min_omega = min_value
        self.max_omega = max_value
        self.reward_history: list = []
        self.increase = 1 / steps_to_max
        self.decrease = 1 / steps_to_min

    def step(self, theta_reward) -> None:
        """Advance the reward history, then compare (the reference's order)."""
        if theta_reward is None:
            return
        self.reward_history.append(theta_reward)
        if len(self.reward_history) > self.reward_history_size:
            self.reward_history.pop(0)

        mean_reward = round(float(np.mean(self.reward_history)), 5)
        theta_reward = round(theta_reward, 5)
        if mean_reward < 0:
            mean_reward /= self.improvement_threshold
        else:
            mean_reward *= self.improvement_threshold

        if theta_reward > mean_reward:
            self.omega = max(self.omega - self.decrease, self.min_omega)
        else:
            self.omega = min(self.omega + self.increase, self.max_omega)


class OmegaState(NamedTuple):
    omega: torch.Tensor    # scalar f32
    history: torch.Tensor  # [H] reward ring buffer
    filled: torch.Tensor   # scalar i32, number of valid entries
    cursor: torch.Tensor   # scalar i32, next write slot


class OmegaParams(NamedTuple):
    improvement_threshold: float
    min_omega: float
    max_omega: float
    increase: float        # 1/steps_to_max
    decrease: float        # 1/steps_to_min


def omega_init(default_value: float, history_size: int, device) -> OmegaState:
    return OmegaState(
        omega=torch.tensor(default_value, dtype=torch.float32, device=device),
        history=torch.zeros((history_size,), dtype=torch.float32, device=device),
        filled=torch.tensor(0, dtype=torch.int32, device=device),
        cursor=torch.tensor(0, dtype=torch.int32, device=device),
    )


def omega_step(state: OmegaState, reward: torch.Tensor, hp: OmegaParams) -> OmegaState:
    h = state.history.shape[0]
    idx = torch.arange(h, device=state.history.device)
    history = torch.where(idx == state.cursor, reward, state.history)
    filled = torch.clamp_max(state.filled + 1, h)
    cursor = (state.cursor + 1) % h

    mean = torch.where(idx < filled, history, 0.0).sum() / torch.clamp_min(filled, 1)
    mean = torch.round(mean * 1e5) / 1e5
    r = torch.round(reward * 1e5) / 1e5
    mean = torch.where(mean < 0, mean / hp.improvement_threshold, mean * hp.improvement_threshold)
    omega = torch.where(
        r > mean,
        torch.clamp_min(state.omega - hp.decrease, hp.min_omega),
        torch.clamp_max(state.omega + hp.increase, hp.max_omega),
    )
    return OmegaState(omega=omega, history=history, filled=filled, cursor=cursor)
