"""The JAX package's ``dfd_tpu.utils`` names, under the port's modules.

The checkpoint, factory and sweep names load at first access (a module
``__getattr__``): ``utils/factory.py`` imports ``runners.vectorized``, which
imports ``utils.metrics``, so importing them here would make a cycle.
"""

import importlib

from dfd_tpu_torch.utils.metrics import EpochReporter
from dfd_tpu_torch.utils.profiling import StageTimer, trace

_LAZY = {
    "get_init_data": "factory",
    "get_vectorized_init_data": "factory",
    "make_jax_env": "factory",
    "save_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint",
    "random_search": "sweep",
}

__all__ = [
    "EpochReporter",
    "get_init_data",
    "get_vectorized_init_data",
    "make_jax_env",
    "save_checkpoint",
    "load_checkpoint",
    "random_search",
    "StageTimer",
    "trace",
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"dfd_tpu_torch.utils.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
