"""Wire format for the elastic control plane, a copy of
``dfd_tpu.distributed.wire`` (numpy and msgpack only), so the bytes a port
process sends are the bytes a JAX process sends for the same payload.
Payloads hold numpy arrays and Python scalars only, in the dtypes the JAX
package writes (float32 parameters and frames, float64 observation
statistics); a torch tensor in a payload reaches ``_pack_hook`` and raises
``TypeError``.

The reference ships flattened ``repeated float`` protobuf arrays (reference
networking/rpc_misc/proto/client_server_interface.proto:18-42) — simple but
slow (float-by-float varint packing) and schema-frozen.  Here the payloads
are msgpack maps with zero-copy numpy buffers: arrays travel as raw
little-endian bytes + dtype + shape, scalars/strings natively.  Messages:

- ``state``: the FDState broadcast (params, zeta, strategy archive, obs
  stats, epoch, experiment id, config);
- ``returns``: a batch of FDReturns (encoded noise + scalars, plus eval
  states for eval runs).

Same bandwidth story as the reference: a non-eval return is ~a hundred
bytes because the perturbation travels as its encoding, never as a vector.
"""

from __future__ import annotations

from typing import Any, Dict, List

import msgpack
import numpy as np

from dfd_tpu_torch.fd.returns import FDReturn, FDState

_ARR = "__nd__"


def _pack_hook(obj):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {_ARR: True, "d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"unserializable type {type(obj)}")


def _unpack_hook(obj):
    if isinstance(obj, dict) and obj.get(_ARR):
        return np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).reshape(obj["s"])
    return obj


def dumps(payload: Any) -> bytes:
    return msgpack.packb(payload, default=_pack_hook, use_bin_type=True)


def loads(data: bytes) -> Any:
    return msgpack.unpackb(data, object_hook=_unpack_hook, raw=False, strict_map_key=False)


# -- FDState ------------------------------------------------------------------


def encode_state(state: FDState) -> bytes:
    return dumps(
        {
            "strategy_frames": np.asarray(state.strategy_frames, np.float32)
            if state.strategy_frames is not None
            else None,
            "strategy_history": np.asarray(state.strategy_history, np.float32)
            if state.strategy_history is not None
            else None,
            "policy_params": np.asarray(state.policy_params, np.float32)
            if state.policy_params is not None
            else None,
            "epoch": int(state.epoch),
            "experiment_id": state.experiment_id,
            "obs_stats": np.asarray(state.obs_stats, np.float64)
            if state.obs_stats is not None
            else None,
        }
    )


def decode_state(data: bytes, cfg: Dict | None = None) -> FDState:
    d = loads(data)
    return FDState(
        strategy_frames=d["strategy_frames"],
        strategy_history=d["strategy_history"],
        policy_params=d["policy_params"],
        epoch=d["epoch"],
        experiment_id=d["experiment_id"],
        obs_stats=None if d["obs_stats"] is None else list(d["obs_stats"]),
        cfg=cfg,
    )


# -- FDReturn batches ----------------------------------------------------------


def encode_returns(returns: List[FDReturn]) -> bytes:
    rows = []
    for r in returns:
        rows.append(
            {
                "epoch": int(r.epoch),
                "noise": r.encoded_noise,
                "reward": float(r.reward),
                "novelty": float(r.novelty),
                "entropy": float(r.entropy),
                "timesteps": int(r.timesteps),
                "is_eval": bool(r.is_eval),
                "eval_states": np.asarray(r.eval_states, np.float32)
                if r.is_eval and len(r.eval_states) > 0
                else None,
                "obs_stats": np.asarray(r.obs_stats_update, np.float64)
                if len(r.obs_stats_update) > 0
                else None,
            }
        )
    return dumps(rows)


def decode_returns(data: bytes) -> List[FDReturn]:
    out = []
    for d in loads(data):
        r = FDReturn(
            epoch=d["epoch"],
            encoded_noise=d["noise"],
            reward=d["reward"],
            novelty=d["novelty"],
            entropy=d["entropy"],
            timesteps=d["timesteps"],
            is_eval=d["is_eval"],
        )
        if d["eval_states"] is not None:
            r.eval_states = d["eval_states"]
        if d["obs_stats"] is not None:
            r.obs_stats_update = list(d["obs_stats"])
        out.append(r)
    return out
