from dfd_tpu_torch.ops.distances import (
    DISTANCES,
    categorical_bhattacharyya,
    categorical_tvd,
    gaussian_bhattacharyya,
    gaussian_wasserstein,
    gaussian_wasserstein_from_strategies,
    l2_dist,
    strategy_distance,
    strategy_novelty,
)
from dfd_tpu_torch.ops.fused_resblock import fused_feat_pool, fused_res_stage
from dfd_tpu_torch.ops.standardize import affine_transform, standardize

__all__ = [
    "DISTANCES",
    "l2_dist",
    "categorical_tvd",
    "categorical_bhattacharyya",
    "gaussian_bhattacharyya",
    "gaussian_wasserstein",
    "gaussian_wasserstein_from_strategies",
    "strategy_novelty",
    "strategy_distance",
    "fused_res_stage",
    "fused_feat_pool",
    "standardize",
    "affine_transform",
]
