"""Device selection: the port runs on the card unless told otherwise; and
its float32 products in full float32 (:func:`full_f32`)."""

from __future__ import annotations

import contextlib
from typing import Iterator

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
