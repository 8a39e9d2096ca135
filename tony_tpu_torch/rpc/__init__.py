"""Control-plane + serving-data-plane RPC: protobuf messages, gRPC services.

The port's copy of ``tony_tpu/rpc/``: gRPC with the reference's protobuf
messages (``tony_pb2.py``, the same serialized ``tony.proto``), the same
service names and methods, and the per-app token in call metadata
(``auth.py``). The card's machine has ``grpc`` and ``google.protobuf``
(grpcio 1.80.0 and protobuf 6.33.6 there, grpcio 1.76.0 and protobuf 6.33.5
in the CPU test environment), so the wire is the reference's as it is: a
client of either package can reach an AM, and a gang frontend a decode
host, of either.
"""

from tony_tpu_torch.rpc import tony_pb2 as pb
from tony_tpu_torch.rpc.service import (
    SERVE_SERVICE_NAME,
    SERVICE_NAME,
    ApplicationRpcClient,
    ApplicationRpcServicer,
    ServeRpcClient,
    ServeRpcServicer,
    serve,
    serve_rpc,
)

__all__ = [
    "ApplicationRpcClient",
    "ApplicationRpcServicer",
    "SERVE_SERVICE_NAME",
    "SERVICE_NAME",
    "ServeRpcClient",
    "ServeRpcServicer",
    "pb",
    "serve",
    "serve_rpc",
]
