"""Elastic control-plane server (reference networking/server.py:9-162), a
copy of ``dfd_tpu.distributed.server``: the same service and method names,
message cap, compression and return classification, so a port learner
serves JAX clients and a JAX learner serves port clients.

Keeps the reference's operational properties — elastic membership (no client
registry; any client that reaches the port participates), per-client unique
seeds minted by mutating the config on every GetConfig, Gzip compression,
1 GiB message cap, LIFO return consumption with epoch-age classification —
while fixing its latent race: the returns queue and broadcast state are
guarded by explicit locks instead of relying on the GIL (see SURVEY.md
section 5.2).

Implemented over grpc *generic* method handlers with the msgpack wire codec
(``dfd_tpu_torch/distributed/wire.py``), so no generated stubs are needed.
The RPC handler threads only move bytes and numpy payloads under the lock;
they never touch a tensor or the card (the learner thread encodes its
broadcast with ``update``).
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from dfd_tpu_torch.distributed import wire
from dfd_tpu_torch.fd.returns import FDReturn, FDState

SERVICE = "dfd.CSInterface"
MAX_MESSAGE_LENGTH = 1 * 1024 ** 3


class ServerInterface:
    """Shared state between the learner thread and the RPC threads."""

    def __init__(self, initial_state: FDState):
        self._lock = threading.Lock()
        self._returns: List[FDReturn] = []
        self._state_bytes: bytes = b""
        self._cfg: Dict = {}
        self._experiment_id = None
        self.update(initial_state)

    # -- learner side ------------------------------------------------------------

    def update(self, state: FDState) -> None:
        encoded = wire.encode_state(state)
        with self._lock:
            self._state_bytes = encoded
            if state.experiment_id != self._experiment_id:
                self._experiment_id = state.experiment_id
                self._cfg = dict(state.cfg or {})

    def get_returns_batch(
        self,
        batch_size: Optional[int] = None,
        current_epoch: Optional[int] = None,
        max_delayed_return: Optional[int] = None,
        poll_interval: float = 0.01,
    ):
        """Block until ``batch_size`` non-eval returns are popped (newest
        first); eval returns ride along free.  Returns too old are counted as
        discarded here (reference networking/server.py:64-95)."""
        rets: List[FDReturn] = []
        timesteps = 0
        n_delayed = 0
        n_discarded = 0
        n_collected = 0
        if batch_size is None:
            with self._lock:
                batch_size = max(len(self._returns), 1)
        while n_collected < batch_size:
            with self._lock:
                ret = self._returns.pop(-1) if self._returns else None
            if ret is None:
                time.sleep(poll_interval)
                continue
            timesteps += ret.timesteps
            if current_epoch is not None:
                diff = current_epoch - ret.epoch
                if diff > 0:
                    if max_delayed_return is not None and diff > max_delayed_return:
                        n_discarded += 1
                        continue
                    n_delayed += 1
            rets.append(ret)
            if not ret.is_eval:
                n_collected += 1
        return rets, timesteps, n_delayed, n_discarded

    # -- RPC side ----------------------------------------------------------------

    def submit_returns(self, returns: List[FDReturn]) -> None:
        with self._lock:
            self._returns.extend(returns)

    def state_bytes(self) -> bytes:
        with self._lock:
            return self._state_bytes

    def config_for_client(self) -> Dict:
        """Each fetch mints a distinct seed — the reference's elastic-client
        RNG-stream mechanism (networking/server.py:144-149)."""
        with self._lock:
            if "random_seed" in self._cfg:
                self._cfg["random_seed"] = int(self._cfg["random_seed"]) + 1
            return dict(self._cfg)


class FDServer:
    def __init__(self, initial_state: FDState):
        self.interface = ServerInterface(initial_state)
        self._server: Optional[grpc.Server] = None
        self.port: Optional[int] = None

    def update(self, state: FDState) -> None:
        self.interface.update(state)

    def get_returns_batch(self, **kw):
        return self.interface.get_returns_batch(**kw)

    def start(self, address: str = "localhost", port: int = 1025, max_workers: int = 10) -> int:
        iface = self.interface

        def get_config(request: bytes, context) -> bytes:
            return wire.dumps(iface.config_for_client())

        def get_server_state(request: bytes, context) -> bytes:
            return iface.state_bytes()

        def submit_returns(request: bytes, context) -> bytes:
            iface.submit_returns(wire.decode_returns(request))
            return b""

        ident = lambda b: b
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=ident, response_serializer=ident
            )
            for name, fn in {
                "GetConfig": get_config,
                "GetServerState": get_server_state,
                "SubmitReturn": submit_returns,
                "SubmitReturns": submit_returns,
            }.items()
        }
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_LENGTH),
                ("grpc.max_receive_message_length", MAX_MESSAGE_LENGTH),
            ],
            compression=grpc.Compression.Gzip,
        )
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),)
        )
        self.port = server.add_insecure_port(f"{address}:{port}")
        server.start()
        self._server = server
        return self.port

    def stop(self, grace: float = 10) -> None:
        if self._server is not None:
            self._server.stop(grace=grace)
            self._server = None


class GRPCWorker:
    """Adapts FDServer to the Worker interface so the server runner's train
    loop is topology-agnostic (reference worker/grpc_worker.py:6-21)."""

    def __init__(self, state: FDState):
        self.server = FDServer(state)

    def collect_returns(self, batch_size=None, current_epoch=None, max_delayed_return=None):
        return self.server.get_returns_batch(
            batch_size=batch_size,
            current_epoch=current_epoch,
            max_delayed_return=max_delayed_return,
        )

    def update(self, state: FDState) -> None:
        self.server.update(state)

    def start(self, address: str, port: int) -> int:
        return self.server.start(address=address, port=port)

    def stop(self) -> None:
        self.server.stop()
