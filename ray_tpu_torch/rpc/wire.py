"""Frame and message codec for the TCP transport.

A copy of ``ray_tpu.rpc.wire`` for the PyTorch port; a plain message
encodes to the same bytes in both packages, preamble included.  Frame
layout (reference analogue: gRPC's length-prefixed messages over HTTP/2,
``src/ray/rpc``):

    [4 bytes big-endian payload length][payload]

Payload is a pickled tuple:

    request:  (msg_id, method_name, payload_obj[, dedup_token])
    response: (msg_id, ok_flag, payload_or_error)

Pickle (protocol 5) is the codec because the payloads are the same
Python object graphs the in-process transport passes by reference (task
specs, serialized-object blobs, resource dicts); the trust model is the
reference's, which runs cloudpickle bytes received over gRPC from
cluster peers: the wire is cluster-internal, never an untrusted
boundary.  Large binary blobs (``SerializedObject.to_bytes()``) ride as
raw ``bytes`` inside the tuple.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, Tuple

_LEN = struct.Struct("!I")
# One frame must hold the largest single message; bulk object data
# rides the chunked plane (rpc/chunked.py) in 5 MiB frames.  1 GiB is a
# sanity bound, not a design limit.
MAX_FRAME = 1 << 30

# Versioned connection preamble: every client opens with MAGIC+version,
# and the server drops a mismatched peer before parsing any message.
WIRE_MAGIC = b"RTPU"
WIRE_VERSION = 1
_PREAMBLE = struct.Struct("!4sH")


class ConnectionClosed(Exception):
    pass


class WireVersionMismatch(ConnectionClosed):
    pass


def send_preamble(sock: socket.socket) -> None:
    sock.sendall(_PREAMBLE.pack(WIRE_MAGIC, WIRE_VERSION))


def expect_preamble(sock: socket.socket) -> None:
    """Server side: validate the client's opening preamble."""
    raw = _recv_exact(sock, _PREAMBLE.size)
    magic, version = _PREAMBLE.unpack(raw)
    if magic != WIRE_MAGIC:
        raise WireVersionMismatch(
            f"bad wire magic {magic!r} (not a ray_tpu_torch peer?)")
    if version != WIRE_VERSION:
        raise WireVersionMismatch(
            f"wire protocol version mismatch: peer={version} "
            f"local={WIRE_VERSION}")


def send_msg(sock: socket.socket, obj: Any, lock=None) -> None:
    data = pickle.dumps(obj, protocol=5)
    if len(data) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(data)} bytes")
    frame = _LEN.pack(len(data)) + data
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_msg(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ConnectionClosed(f"oversized frame: {length}")
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionClosed("peer closed")
        parts.append(chunk)
        remaining -= len(chunk)
    return b"".join(parts) if len(parts) != 1 else parts[0]


def connect(address: Tuple[str, int], timeout: float = 10.0
            ) -> socket.socket:
    sock = socket.create_connection(address, timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_preamble(sock)
    return sock
