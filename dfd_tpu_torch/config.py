"""Typed training configuration, field for field the JAX package's.

The same fields and defaults as ``dfd_tpu.config`` so that one config object
drives both packages.  ``mesh_axes`` and ``scan_unroll`` are XLA lowering
choices the port does not read.  ``e_lowering`` is checked as the JAX
trainer checks it (``flat``, ``nested`` or ``auto`` where E > 1, unchunked,
with a zeta), but E > 1 episodes are one rollout over M * E rows whichever
of the three it names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class OmegaConfig:
    default_value: float = 0.0
    improvement_threshold: float = 1.035
    reward_history_size: int = 20
    min_value: float = 0.0
    max_value: float = 1.0
    steps_to_min: int = 25
    steps_to_max: int = 75


@dataclasses.dataclass
class TrainConfig:
    env_id: str = "SimpleTrapEnv-v0"
    learning_rate: float = 0.01
    noise_std: float = 0.02
    batch_size: int = 40                 # perturbations per update (population)
    envs_per_perturbation: int = 1       # episodes averaged per member
    e_lowering: str = "auto"
    # mirrored perturbation pairs theta +- sigma*eps (members 2k/2k+1 share
    # eps_k with opposite signs); requires an even batch_size
    antithetic: bool = False
    ent_coef: float = 0.0
    random_seed: int = 123
    max_delayed_return: int = 10
    vbn_buffer_size: int = 0
    zeta_size: int = 200
    max_strategy_history_size: int = 200
    eval_prob: float = 0.05              # sequential/elastic topologies
    eval_every: int = 1                  # vectorized topology: eval cadence (epochs)
    normalize_obs: bool = False
    obs_stats_update_chance: float = 0.01
    episode_length: Optional[int] = None  # rollout horizon; None -> env default
    timestep_limit: int = 50_000_000
    omega: OmegaConfig = dataclasses.field(default_factory=OmegaConfig)
    # optimizer
    optimizer: str = "dsgd"              # "dsgd" | "sgd"
    dsgd_min_scale: float = 0.23
    dsgd_max_scale: float = 1.0
    # parallel layout
    mesh_axes: Tuple[str, ...] = ("pop",)
    population_chunk: Optional[int] = None  # microbatch population to bound memory
    # noise backend: "jax" (counter keys + a library normal) or "pallas"
    # (in-kernel counter-hash regeneration; the port's CUDA kernels)
    noise_backend: str = "jax"
    scan_unroll: int = 1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
