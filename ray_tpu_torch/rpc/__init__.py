"""Wire transport: length-prefixed framed RPC over TCP.

A port of ``ray_tpu.rpc`` for the PyTorch port (reference gRPC substrate,
``src/ray/rpc/grpc_server.h`` GrpcServer, ``src/ray/rpc/client_call.h``
ClientCall): a small framed protocol between OS processes.  Process
workers register with their node's host service over it, take their
tasks over it and reach the driver's API through it; the in-process
method-call transport stays the path between the raylets and the GCS of
one process (node hosts on the wire are ROADMAP A.4b.9b).
"""

from ray_tpu_torch.rpc.client import RpcClient, RpcConnectionError, RpcError
from ray_tpu_torch.rpc.server import RpcServer

__all__ = ["RpcClient", "RpcServer", "RpcError", "RpcConnectionError"]
