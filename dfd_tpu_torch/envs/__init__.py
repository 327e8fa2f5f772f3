from dfd_tpu_torch.envs.base import TorchEnv
from dfd_tpu_torch.envs.cartpole import CartPoleEnv, CartPoleState
from dfd_tpu_torch.envs.framestack import FrameStackEnv, FrameStackState, PadChannelsEnv
from dfd_tpu_torch.envs.pendulum import PendulumEnv, PendulumState
from dfd_tpu_torch.envs.pixelgrid import PixelGridEnv, PixelGridState
from dfd_tpu_torch.envs.procmaze import ProcMazeEnv, ProcMazeState
from dfd_tpu_torch.envs.swimmer import SwimmerEnv, SwimmerState
from dfd_tpu_torch.envs.trap import TrapEnv

__all__ = ["TorchEnv", "TrapEnv", "ProcMazeEnv", "ProcMazeState", "PixelGridEnv", "PixelGridState",
           "CartPoleEnv", "CartPoleState", "FrameStackEnv",
           "FrameStackState", "PadChannelsEnv", "PendulumEnv", "PendulumState", "SwimmerEnv",
           "SwimmerState"]
