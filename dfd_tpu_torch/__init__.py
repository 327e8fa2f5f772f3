"""dfd_tpu_torch — the Deep Finite Differences trainer on PyTorch and CUDA.

The port of ``dfd_tpu`` (JAX on a TPU) to an NVIDIA H100, one slice at a
time, with the JAX package as the reference it is tested against.  It
imports torch and numpy, never JAX, and runs on the card unless the caller
passes ``device="cpu"``.  Its layout mirrors the JAX package's:

- ``core``     — device choice, flat-parameter views, Welford statistics,
                 the noise sources.
- ``ops``      — distances, standardize, and the CUDA kernels
                 (``ops/csrc``) with their plain PyTorch versions.
- ``models``   — population-batched policy forwards (``DiscreteMLP``,
                 ``GaussianMLP``, ``ImpalaPolicy``, ``AtariCNN``), their VBN
                 refreshes and wire views.
- ``envs``     — population-batched environments (``TrapEnv``,
                 ``ProcMazeEnv``, ``PixelGridEnv``, ``SwimmerEnv``, ...) and
                 the host wrappers.
- ``fd``       — rollout, fitness and combine, DSGD, the omega schedule, and
                 the host ``FDLearner``.
- ``novelty``  — the behavioral-diversity archive over zeta.
- ``runners``  — the population trainer (``VectorizedTrainer``) and the
                 sequential topology (``SequentialRunner``, one episode at
                 a time through ``HostPolicy`` and ``HostEnv``).
- ``utils``    — metrics, profiling, checkpoint and resume, level curricula,
                 the env/model factory and the sweep.
- ``parallel`` — the population mesh over ``torch.distributed``.
- ``distributed`` — the elastic gRPC control plane (server and clients).
- ``__main__`` — the command line, ``python -m dfd_tpu_torch
                 train|server|client|sweep|bench`` (the ``dfd-tpu-torch``
                 script of an installed port).
- ``bench``    — the throughput benchmark and its mesh harness.
- ``convert``  — carrying weights, trainer state and the VBN buffer across
                 from ``dfd_tpu``.
"""

from dfd_tpu_torch.version import __version__

__all__ = ["__version__"]
