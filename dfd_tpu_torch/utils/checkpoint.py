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

:func:`save_host_checkpoint` and :func:`load_host_checkpoint` do the same
for the host topologies' ``SequentialRunner`` and ``ServerRunner``, with the
JAX package's keys, so each package reads the other's file.
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


# ---------------------------------------------------------------------------
# Host-topology (sequential / server runner) checkpoints
# ---------------------------------------------------------------------------


def _state_leaves(state) -> list:
    """The tensors of a (nested) env state tuple, depth first in field
    order: ``jax.tree.leaves``' order for the JAX env's state."""
    if isinstance(state, tuple):
        return [leaf for field in state for leaf in _state_leaves(field)]
    return [state]


def _state_from_leaves(template, leaves):
    """``template``'s (nested) tuple with its tensors replaced, in order,
    by ``leaves`` (an iterator of tensors)."""
    if isinstance(template, tuple):
        return type(template)(*(_state_from_leaves(f, leaves) for f in template))
    return next(leaves)


def save_host_checkpoint(path: str, runner) -> None:
    """Persist a SequentialRunner's or a ServerRunner's training state with
    the JAX package's keys: the learner (flat, epoch, discarded returns, the
    policy history of the drift correction), omega, the EMAs, zeta, a
    server's global observation statistics (``obs.serialized``), the
    archive's flats, the host RNG streams (MT19937 states as arrays, PCG64
    states in the meta), and a sequential runner's episode in flight (the
    agent's last observation and timesteps, the env's state leaves without
    their batch axis, int64 written as int32 as JAX keeps them).  The host
    env's reset key (``env.key``, its uint32 words) rides beside them; the
    JAX package does not read it."""
    learner = runner.learner
    arrays: Dict[str, np.ndarray] = {
        "flat": np.asarray(learner.flat, np.float32),
        "epoch": np.asarray(learner.epoch),
        "discarded": np.asarray(learner.discarded_returns),
        "zeta": np.asarray(runner.zeta),
        "omega.omega": np.asarray(runner.omega.omega, np.float64),
        "omega.history": np.asarray(runner.omega.reward_history, np.float64),
        "ema.reward": np.asarray(runner.policy_reward if runner.policy_reward is not None
                                 else np.nan),
        "ema.entropy": np.asarray(runner.policy_entropy if runner.policy_entropy is not None
                                  else np.nan),
        "ema.novelty": np.asarray(runner.policy_novelty if runner.policy_novelty is not None
                                  else np.nan),
        "history.flats": np.stack([f for f, _ in learner.policy_history]),
        "history.epochs": np.asarray([e for _, e in learner.policy_history]),
    }
    if hasattr(runner, "global_obs_stats"):
        arrays["obs.serialized"] = np.asarray(runner.global_obs_stats.serialize(), np.float64)
    archive_flats = [p.flat for p in runner.strategy_handler.archive.points]
    if archive_flats:
        arrays["archive.flats"] = np.stack(archive_flats)

    pcg = {}
    for name, rs in _host_rngs(runner).items():
        if isinstance(rs, np.random.RandomState):
            kind, keys, pos, has_gauss, cached = rs.get_state()
            arrays[f"rng.{name}.keys"] = np.asarray(keys)
            arrays[f"rng.{name}.rest"] = np.asarray([pos, has_gauss, cached], np.float64)
        elif hasattr(rs, "bit_generator"):
            st = rs.bit_generator.state
            pcg[name] = {
                "state": str(st["state"]["state"]),
                "inc": str(st["state"]["inc"]),
                "has_uint32": int(st["has_uint32"]),
                "uinteger": int(st["uinteger"]),
            }

    agent = getattr(runner, "agent", None)  # the sequential topology's episode
    if agent is not None:
        arrays["agent.last_obs"] = np.asarray(agent.last_obs)
        arrays["agent.cumulative"] = np.asarray(agent.cumulative_timesteps)
        env_state = getattr(agent.env, "_state", None)
        if env_state is not None:
            for i, leaf in enumerate(_state_leaves(env_state)):
                a = _numpy(leaf)[0]
                arrays[f"env.leaf{i}"] = a.astype(np.int32) if a.dtype == np.int64 else a
        key = getattr(agent.env, "_key", None)
        if key is not None:
            arrays["env.key"] = np.asarray(key, np.uint32)

    meta = {
        "n_archive": len(archive_flats),
        "has_zeta": runner.strategy_handler.zeta is not None,
        "has_obs": hasattr(runner, "global_obs_stats"),
        "pcg": pcg,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def _host_rngs(runner) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, obj in (
        ("runner", getattr(runner, "rng", None)),
        ("buffer", getattr(runner, "_buffer_rng", None)),
        ("worker", getattr(getattr(runner, "worker", None), "rng", None)),
        ("agent", getattr(getattr(runner, "agent", None), "rng", None)),
        ("sampler", getattr(getattr(getattr(runner, "policy", None), "sampler", None), "rng",
                            None)),
        ("noise", getattr(getattr(runner, "learner", None), "noise_source", None)
         and getattr(runner.learner.noise_source, "rng", None)),
    ):
        if obj is not None:
            out[name] = obj
    return out


def load_host_checkpoint(path: str, runner) -> None:
    """Restore a SequentialRunner or a ServerRunner built with the same
    model, env and settings, from a file this module or the JAX package
    wrote."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("__meta__")))

    learner = runner.learner
    learner.flat = np.asarray(arrays["flat"], np.float32)
    learner.epoch = int(arrays["epoch"])
    learner.discarded_returns = int(arrays["discarded"])
    learner.policy_history = [
        (np.asarray(f, np.float32), int(e))
        for f, e in zip(arrays["history.flats"], arrays["history.epochs"])
    ]
    learner._build_distance_map()
    runner.policy.set_trainable_flat(learner.flat)

    runner.omega.omega = float(arrays["omega.omega"])
    runner.omega.reward_history = [float(v) for v in arrays["omega.history"]]
    nan_to_none = lambda v: None if np.isnan(v) else float(v)
    runner.policy_reward = nan_to_none(arrays["ema.reward"])
    runner.policy_entropy = nan_to_none(arrays["ema.entropy"])
    runner.policy_novelty = nan_to_none(arrays["ema.novelty"])
    runner.zeta[:] = arrays["zeta"]
    if meta["has_obs"] and "obs.serialized" in arrays:
        runner.global_obs_stats.deserialize(list(arrays["obs.serialized"]))

    for name, rs in _host_rngs(runner).items():
        if isinstance(rs, np.random.RandomState) and f"rng.{name}.keys" in arrays:
            pos, has_gauss, cached = arrays[f"rng.{name}.rest"]
            rs.set_state(("MT19937", arrays[f"rng.{name}.keys"].astype(np.uint32), int(pos),
                          int(has_gauss), float(cached)))
        elif hasattr(rs, "bit_generator") and name in meta["pcg"]:
            saved = meta["pcg"][name]
            st = rs.bit_generator.state
            st["state"] = {"state": int(saved["state"]), "inc": int(saved["inc"])}
            st["has_uint32"] = int(saved["has_uint32"])
            st["uinteger"] = int(saved["uinteger"])
            rs.bit_generator.state = st

    # the broadcast state and the worker tag returns with the restored epoch
    # (else the drift correction would treat them as stale)
    runner.current_state.epoch = learner.epoch
    runner.current_state.policy_params = runner.policy.serialize()
    worker = runner.worker
    if hasattr(worker, "epoch"):  # a sequential runner's (a server's serves the state)
        worker.epoch = learner.epoch

    agent = getattr(runner, "agent", None)
    if agent is not None and "agent.last_obs" in arrays:
        agent.last_obs = arrays["agent.last_obs"]
        agent.cumulative_timesteps = int(arrays["agent.cumulative"])
        env = agent.env
        template = getattr(env, "_state", None)
        if template is not None and "env.leaf0" in arrays:
            old = _state_leaves(template)
            leaves = (torch.as_tensor(arrays[f"env.leaf{i}"], device=t.device).to(t.dtype)[None]
                      for i, t in enumerate(old))
            env._state = _state_from_leaves(template, leaves)
        if "env.key" in arrays and hasattr(env, "_key"):
            env._key = np.asarray(arrays["env.key"], np.uint32)

    _restore_archive(runner.strategy_handler, arrays, meta, np.asarray(runner.zeta))
