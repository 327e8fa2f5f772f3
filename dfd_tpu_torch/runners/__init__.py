from dfd_tpu_torch.runners.agent import Agent
from dfd_tpu_torch.runners.fat_client import FatClientRunner
from dfd_tpu_torch.runners.host_env import HostEnv
from dfd_tpu_torch.runners.host_evaluator import BatchedHostEvaluator
from dfd_tpu_torch.runners.policy import HostPolicy, NumpySampler
from dfd_tpu_torch.runners.sequential import SequentialRunner
from dfd_tpu_torch.runners.slice_client import SliceClientRunner
from dfd_tpu_torch.runners.vectorized import EpochDraws, TrainState, VectorizedTrainer, make_draws
from dfd_tpu_torch.runners.worker import Worker

__all__ = [
    "Agent",
    "Worker",
    "HostEnv",
    "BatchedHostEvaluator",
    "FatClientRunner",
    "HostPolicy",
    "NumpySampler",
    "SequentialRunner",
    "SliceClientRunner",
    "EpochDraws",
    "TrainState",
    "VectorizedTrainer",
    "make_draws",
]
