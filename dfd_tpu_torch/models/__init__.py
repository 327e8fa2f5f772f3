from dfd_tpu_torch.models.atari import AtariCNN
from dfd_tpu_torch.models.base import PolicyModel
from dfd_tpu_torch.models.discrete import DiscreteMLP
from dfd_tpu_torch.models.impala import ImpalaPolicy
from dfd_tpu_torch.models.mujoco import GaussianMLP

__all__ = ["PolicyModel", "DiscreteMLP", "GaussianMLP", "ImpalaPolicy", "AtariCNN"]
