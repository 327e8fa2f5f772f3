"""Elastic control-plane client (reference networking/client.py:11-93), a
copy of ``dfd_tpu.distributed.client``.

Status-flag protocol: every RPC failure is swallowed into RPC_FAILED (the
caller owns the reconnect policy); a changed ``experiment_id`` signals
NEW_EXPERIMENT (refetch config and reconfigure in place); a changed epoch
signals NEW_STATE (apply new parameters/stats).
"""

from __future__ import annotations

import time
import traceback
from typing import List, Optional

import grpc

from dfd_tpu_torch.distributed import wire
from dfd_tpu_torch.distributed.server import MAX_MESSAGE_LENGTH, SERVICE
from dfd_tpu_torch.fd.returns import FDReturn, FDState


class FDClient:
    OPERATION_SUCCESSFUL_FLAG = 0
    NEW_STATE_FLAG = 1
    NEW_EXPERIMENT_FLAG = 2
    RPC_FAILED_FLAG = 3

    def __init__(self, verbose: bool = False):
        self._channel: Optional[grpc.Channel] = None
        self._calls = {}
        self.current_state = FDState()
        self.verbose = verbose

    def connect(self, address: str = "localhost", port: int = 1025) -> None:
        self._channel = grpc.insecure_channel(
            f"{address}:{port}",
            options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_LENGTH),
                ("grpc.max_receive_message_length", MAX_MESSAGE_LENGTH),
            ],
            compression=grpc.Compression.Gzip,
        )
        ident = lambda b: b
        self._calls = {
            name: self._channel.unary_unary(
                f"/{SERVICE}/{name}", request_serializer=ident, response_deserializer=ident
            )
            for name in ("GetConfig", "GetServerState", "SubmitReturn", "SubmitReturns")
        }

    def disconnect(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    # -- RPCs ----------------------------------------------------------------

    def submit_returns(self, returns: List[FDReturn]) -> int:
        try:
            self._calls["SubmitReturns"](wire.encode_returns(returns))
            return self.OPERATION_SUCCESSFUL_FLAG
        except Exception:
            self._log("failed to send returns to server")
            time.sleep(1)
            return self.RPC_FAILED_FLAG

    def _update_cfg(self) -> int:
        try:
            raw = self._calls["GetConfig"](b"")
            self.current_state.cfg = wire.loads(raw)
            return self.OPERATION_SUCCESSFUL_FLAG
        except Exception:
            self._log("failed to receive config from server")
            return self.RPC_FAILED_FLAG

    def get_server_state(self) -> int:
        try:
            raw = self._calls["GetServerState"](b"")
        except Exception:
            self._log("failed to receive state from server")
            return self.RPC_FAILED_FLAG

        state = wire.decode_state(raw, cfg=self.current_state.cfg)
        if state.experiment_id != self.current_state.experiment_id:
            status = self._update_cfg()
            if status == self.RPC_FAILED_FLAG:
                return status
            state.cfg = self.current_state.cfg
            self.current_state = state
            return self.NEW_EXPERIMENT_FLAG
        if state.epoch != self.current_state.epoch:
            state.cfg = self.current_state.cfg
            self.current_state = state
            return self.NEW_STATE_FLAG
        return self.OPERATION_SUCCESSFUL_FLAG

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            traceback.print_exc()
