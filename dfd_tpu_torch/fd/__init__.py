from dfd_tpu_torch.fd.dsgd import DSGD, SGD, DSGDParams, dsgd_update, lr_scale_from_omega
from dfd_tpu_torch.fd.learner import FDLearner
from dfd_tpu_torch.fd.omega import AdaptiveOmega, OmegaParams, OmegaState, omega_init, omega_step
from dfd_tpu_torch.fd.returns import FDReturn, FDState

__all__ = [
    "DSGD",
    "SGD",
    "DSGDParams",
    "dsgd_update",
    "lr_scale_from_omega",
    "FDLearner",
    "AdaptiveOmega",
    "OmegaState",
    "OmegaParams",
    "omega_init",
    "omega_step",
    "FDReturn",
    "FDState",
]
