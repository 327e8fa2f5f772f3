"""Work-unit and broadcast-state dataclasses (reference learner/fd_return.py,
learner/fd_state.py), copies of ``dfd_tpu.fd.returns``.

``FDReturn`` is the result of evaluating one perturbation: an encoded noise
string plus a handful of scalars (and, for eval runs, the visited states that
become zeta candidates).  ``FDState`` is the learner's broadcast: parameters,
strategy archive, observation statistics, epoch, config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FDReturn:
    epoch: int = -1
    encoded_noise: str = "-1"
    perturbation: Optional[np.ndarray] = None  # filled in by the learner
    reward: float = 0.0
    novelty: float = 0.0
    entropy: float = 0.0
    timesteps: int = 0
    is_eval: bool = False
    eval_states: Any = dataclasses.field(default_factory=list)
    obs_stats_update: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FDState:
    strategy_frames: Any = None        # zeta
    strategy_history: Any = None       # archived strategy tensor
    policy_params: Any = None          # full-state flat vector (wire view)
    epoch: int = 0
    cfg: Optional[Dict[str, Any]] = None
    experiment_id: Any = None
    obs_stats: Any = None              # serialized Welford statistic
