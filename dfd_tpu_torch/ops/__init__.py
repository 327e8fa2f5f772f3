from dfd_tpu_torch.ops.distances import (
    DISTANCES,
    categorical_bhattacharyya,
    categorical_tvd,
    l2_dist,
)
from dfd_tpu_torch.ops.fused_resblock import fused_feat_pool, fused_res_stage
from dfd_tpu_torch.ops.standardize import affine_transform, standardize

__all__ = [
    "DISTANCES",
    "l2_dist",
    "categorical_tvd",
    "categorical_bhattacharyya",
    "fused_res_stage",
    "fused_feat_pool",
    "standardize",
    "affine_transform",
]
