from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.envs.pixelgrid import PixelGridEnv, PixelGridState
from dfd_tpu_torch.envs.procmaze import ProcMazeEnv, ProcMazeState
from dfd_tpu_torch.envs.trap import TrapEnv

__all__ = ["TorchEnv", "TrapEnv", "ProcMazeEnv", "ProcMazeState", "PixelGridEnv", "PixelGridState"]
