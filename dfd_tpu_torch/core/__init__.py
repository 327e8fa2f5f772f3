from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.core.flat import FlatSpec, flatten, unflatten, update_from_flat
from dfd_tpu_torch.core.noise import (
    CounterNoise,
    CounterNoiseSampler,
    RNGNoiseSource,
    SharedNoiseTable,
    SimpleNoiseSource,
)
from dfd_tpu_torch.core.welford import Welford, WelfordState

__all__ = [
    "resolve_device",
    "FlatSpec",
    "flatten",
    "unflatten",
    "update_from_flat",
    "CounterNoise",
    "CounterNoiseSampler",
    "RNGNoiseSource",
    "SimpleNoiseSource",
    "SharedNoiseTable",
    "Welford",
    "WelfordState",
]
