"""Checkpoint and resume of the population trainer.

The port of ``dfd_tpu.utils.checkpoint.save_checkpoint`` and
``load_checkpoint``: every piece of a :class:`VectorizedTrainer`'s state
round-trips through one npz file with the JAX package's keys (``flat``,
``zeta``, ``omega.*``, ``obs.*``, ``ema.*``, ``epoch``, ``bn.*``,
``cumulative_timesteps``, ``archive.flats``, ``last_archived`` and the
``__meta__`` JSON), written to ``path + ".tmp"`` and published with
``os.replace``.  In place of the JAX trainer's PRNG ``key`` the file holds
the state of the trainer's ``torch.Generator`` (``generator``, its
``get_state()`` bytes), from which the port draws every epoch.

:func:`load_checkpoint` also reads a file the JAX package wrote: its ``key``
is not read, and the port's draws go on from the trainer's own generator.
The strategy archive is rebuilt from its snapshot flats, its distances
re-evaluated on the restored zeta, and the duplicate-archive guard
``_last_archived`` restored.

Restore into a trainer built with the same model, env and config: the
trainer draws its zeta and VBN buffers at construction, then the load sets
its state and its generator.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from dfd_tpu_torch.convert import train_state_from_numpy


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten_tree(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_tree(v, f"{prefix}.{k}", out)
    else:
        out[prefix] = _numpy(tree)


def _unflatten_tree(flat: Dict[str, np.ndarray], prefix: str):
    tree: Dict[str, Any] = {}
    plen = len(prefix) + 1
    for key, value in flat.items():
        if not key.startswith(prefix + "."):
            continue
        parts = key[plen:].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_checkpoint(path: str, trainer) -> None:
    """Persist a VectorizedTrainer's full training state."""
    s = trainer.state
    arrays: Dict[str, np.ndarray] = {
        "flat": _numpy(s.flat),
        "zeta": _numpy(s.zeta),
        "omega.omega": _numpy(s.omega.omega),
        "omega.history": _numpy(s.omega.history),
        "omega.filled": _numpy(s.omega.filled),
        "omega.cursor": _numpy(s.omega.cursor),
        "obs.mean": _numpy(s.obs_stats.mean),
        "obs.m2": _numpy(s.obs_stats.m2),
        "obs.count": _numpy(s.obs_stats.count),
        "ema.reward": _numpy(s.policy_reward),
        "ema.entropy": _numpy(s.policy_entropy),
        "ema.novelty": _numpy(s.policy_novelty),
        "epoch": np.asarray(s.epoch, np.int32),
        "generator": trainer.generator.get_state().numpy(),
        "cumulative_timesteps": np.asarray(trainer.cumulative_timesteps),
    }
    _flatten_tree(s.bn_state, "bn", arrays)
    archive_flats = [p.flat for p in trainer.handler.archive.points]
    if archive_flats:
        arrays["archive.flats"] = np.stack(archive_flats)
    if trainer._last_archived is not None:
        arrays["last_archived"] = np.asarray(trainer._last_archived)
    meta = {"n_archive": len(archive_flats), "has_zeta": trainer.handler.zeta is not None}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str, trainer) -> None:
    """Restore a VectorizedTrainer's state in place (same model, env and
    config), from a file this module or the JAX package wrote."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("__meta__")))

    bn_state = _unflatten_tree(arrays, "bn")
    state = train_state_from_numpy({
        "flat": arrays["flat"],
        "bn_state": bn_state,
        "omega": [arrays[f"omega.{k}"] for k in ("omega", "history", "filled", "cursor")],
        "obs_stats": [arrays[f"obs.{k}"] for k in ("mean", "m2", "count")],
        "zeta": arrays["zeta"],
        "policy_reward": arrays["ema.reward"],
        "policy_entropy": arrays["ema.entropy"],
        "policy_novelty": arrays["ema.novelty"],
        "epoch": arrays["epoch"],
    }, trainer.device)
    if not bn_state:  # a model without BatchNorm statistics
        state = state._replace(bn_state=trainer.state.bn_state)
    trainer.state = state
    trainer.cumulative_timesteps = int(arrays["cumulative_timesteps"])
    if "generator" in arrays:  # a JAX package's file holds a key, not read
        trainer.generator.set_state(torch.from_numpy(arrays["generator"].copy()))

    _restore_archive(trainer.handler, arrays, meta, arrays["zeta"])
    # without the guard the next train() call's _archive_current() would
    # submit the current flat again, a distance-0 duplicate in the archive
    la = arrays.get("last_archived")
    trainer._last_archived = np.asarray(la).copy() if la is not None else None


def _restore_archive(handler, arrays, meta, zeta) -> None:
    handler.archive.points = []
    handler.archive.strategy_tensor = []
    handler.archive.known_dists = {}
    handler.archive.worst_point_idx = 0
    handler.archive.zeta = []  # else a warm archive would route submit() into _replace
    handler.zeta = None
    if meta["n_archive"] > 0:
        for flat in arrays["archive.flats"]:
            handler.archive.submit(flat)
    if meta["has_zeta"]:
        handler.set_zeta(zeta)
