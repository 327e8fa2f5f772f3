"""Flat-parameter views over nested-dict parameter trees.

A :class:`FlatSpec` is an explicit ordered list of (key-path, shape, dtype)
entries, the same contract as ``dfd_tpu.core.flat``: every parity test
compares flat vectors, so the order here is the order there.

:func:`unflatten` also takes a population ``[M, d]`` of flat vectors and then
returns ``[M, *shape]`` leaves that are *views* of it, so a perturbed
population is never copied into per-layer tensors.  :func:`update_from_flat`
replaces the spec's leaves of a tree the same way and keeps the others.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

KeyPath = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Ordered description of leaves participating in a flat view."""

    entries: Tuple[Tuple[KeyPath, Tuple[int, ...], Any], ...]

    @classmethod
    def make(cls, entries: Sequence[Tuple[KeyPath, Sequence[int], Any]]) -> "FlatSpec":
        return cls(tuple((tuple(k), tuple(s), d) for k, s, d in entries))

    @property
    def size(self) -> int:
        return sum(int(np.prod(s)) for _, s, _ in self.entries)

    def offsets(self) -> List[Tuple[KeyPath, int, int]]:
        """(path, start, end) for every entry, in order."""
        out = []
        idx = 0
        for path, shape, _ in self.entries:
            n = int(np.prod(shape))
            out.append((path, idx, idx + n))
            idx += n
        return out


def _get(tree: Dict[str, Any], path: KeyPath):
    node = tree
    for k in path:
        node = node[k]
    return node


def _set(tree: Dict[str, Any], path: KeyPath, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def flatten(tree: Dict[str, Any], spec: FlatSpec) -> torch.Tensor:
    """Concatenate the spec's leaves of ``tree`` into one float32 vector."""
    parts = [_get(tree, path).to(torch.float32).reshape(-1) for path, _, _ in spec.entries]
    return torch.cat(parts)


def unflatten(vec: torch.Tensor, spec: FlatSpec) -> Dict[str, Any]:
    """Inverse of :func:`flatten`.  ``vec`` is ``[d]`` or a population
    ``[M, d]``; the leaves are views of ``vec`` (``[*shape]`` or
    ``[M, *shape]``)."""
    lead = tuple(vec.shape[:-1])
    tree: Dict[str, Any] = {}
    for (path, shape, _), (_, start, end) in zip(spec.entries, spec.offsets()):
        _set(tree, path, vec[..., start:end].view(lead + shape))
    return tree


def update_from_flat(tree: Dict[str, Any], vec: torch.Tensor, spec: FlatSpec) -> Dict[str, Any]:
    """A copy of ``tree`` with the spec's leaves replaced by views of ``vec``
    ([d], or a population [M, d] as in :func:`unflatten`).

    Leaves outside the spec (such as the BatchNorm statistics when ``spec``
    is the trainable one) are carried over by reference."""
    new = _copy_tree(tree)
    lead = tuple(vec.shape[:-1])
    for (path, shape, _), (_, start, end) in zip(spec.entries, spec.offsets()):
        _set(new, path, vec[..., start:end].view(lead + shape))
    return new


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_copy_tree(v) if isinstance(v, dict) else v) for k, v in tree.items()}
