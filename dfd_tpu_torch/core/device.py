"""Device selection: the port runs on the card unless told otherwise; its
float32 products in full float32 (:func:`full_f32`); and the host
topology's small copies to the card without a host synchronisation
(:class:`Staging`)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def canonical(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit (the current
    device where it names none), so ``"cuda"`` and ``"cuda:0"`` compare
    equal on card 0."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _matmul_precision() -> str:
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed the allow_tf32 flag with the newer API
        return "high" if torch.backends.cuda.matmul.allow_tf32 else "highest"


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Float32 matrix products and cuDNN convolutions in full float32 inside
    the block (no TF32: ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` read False), the caller's settings
    restored after it.  The port's float32 products are plain
    ``torch.bmm``/``baddbmm`` calls, which a caller's
    ``torch.set_float32_matmul_precision("high")`` would otherwise send to
    TF32, out of the JAX package's tolerances."""
    precision, cudnn_tf32 = _matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def tree_to(tree, device):
    """``tree`` (dicts, tuples and NamedTuples of tensors and scalars, such
    as a ``TrainState``) with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_to(v, device) for v in tree)) if hasattr(tree, "_fields") \
            else tuple(tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Staging:
    """Copies of small numpy arrays to ``device`` that make no host
    synchronisation, for the host topology's per-step transfers.

    On the card each array goes through a pinned buffer kept for its shape
    and dtype and is copied with ``non_blocking=True`` (a blocking copy from
    pageable memory waits for the stream).  A buffer is rewritten only once
    the copy that last read it has completed: its CUDA event is queried, and
    waited for only if it has not (in the host loop a read back always
    comes between two uses).  On the CPU the tensor shares the array's
    memory (a read-only array's copy)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._buffers = {}

    def __call__(self, array) -> torch.Tensor:
        a = np.ascontiguousarray(array)
        if self.device.type != "cuda":
            # a read-only array (a wire buffer) is copied: PyTorch has no read-only tensor
            return torch.as_tensor(a if a.flags.writeable else a.copy(), device=self.device)
        key = (a.shape, a.dtype.str)
        if key not in self._buffers:
            self._buffers[key] = [torch.from_numpy(np.empty_like(a)).pin_memory(), None]
        entry = self._buffers[key]
        host, done = entry
        if done is not None and not done.query():
            done.synchronize()
        host.numpy()[...] = a
        out = host.to(self.device, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
        return out
