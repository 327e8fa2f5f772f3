"""The elastic control plane: the msgpack wire, the gRPC server and the
client (``dfd_tpu.distributed``'s counterpart)."""

from dfd_tpu_torch.distributed.client import FDClient
from dfd_tpu_torch.distributed.server import FDServer, GRPCWorker, ServerInterface

__all__ = ["FDClient", "FDServer", "GRPCWorker", "ServerInterface"]
