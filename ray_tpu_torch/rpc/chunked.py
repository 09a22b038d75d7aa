"""Chunked object transfer over the framed RPC.

A port of the session half of ``ray_tpu.rpc.chunked`` for the PyTorch
port (reference ``src/ray/object_manager/``: ``PushManager``'s chunked
sends, push_manager.cc:95, and ``ObjectBufferPool``'s chunk assembly).
The receiver drives the flow: each ``chunk`` request doubles as the ack
of the one before, and a bounded number of chunk requests is pipelined
to hide the round trip.  An object of any size crosses as
``object_manager_chunk_size`` frames, past the one-frame ceiling
(``wire.MAX_FRAME``).  Process workers' big ``get`` replies ride these
sessions.

Wire surface (:func:`serve_chunks` registers it on an RpcServer):

    fetch_meta   {object_id}        -> None | {"inline": bytes}
                                       | {"token", "size", "chunk_size"}
                                       | {"busy": True}
    fetch_chunk  {token, index}     -> bytes | None (session expired)
    fetch_close  {token}            -> True

Left out until their items: the relay of an in-flight transfer and the
store's ``TransferLedger`` admission (the cross-process fetch, ROADMAP
A.4b.9b), and sessions over a view pinned in the shared-memory segment
(A.4b.2b).  Every session here holds a ``bytes`` blob, so nothing is
pinned, and an expired session is dropped at the next admission instead
of by the reference's process-wide sweeper thread.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, Optional

from ray_tpu_torch._private.config import get_config


class _Session:
    __slots__ = ("blob", "last_access")

    def __init__(self, blob):
        self.blob = blob
        self.last_access = time.monotonic()


class ChunkServer:
    """Sender side: sessions over serialized payloads, at most
    ``max_sessions`` at once (the receiver backs off on ``busy``)."""

    SESSION_TTL_S = 120.0

    def __init__(self, get_blob: Callable[[bytes], Optional[bytes]],
                 max_sessions: int = 8):
        self._get_blob = get_blob
        self._max_sessions = max_sessions
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}

    # ---- handlers ------------------------------------------------------
    def handle_meta(self, payload):
        buf = self._get_blob(payload["object_id"])
        if buf is None:
            return None
        if len(buf) <= get_config().object_manager_chunk_size:
            return {"inline": bytes(buf)}
        meta = self.open_session(buf)
        return meta if meta is not None else {"busy": True}

    def open_session(self, blob: bytes) -> Optional[dict]:
        """Open a transfer session over an already-made blob; returns
        its meta dict, or None when the sessions are full."""
        with self._lock:
            self._expire_locked()
            if len(self._sessions) >= self._max_sessions:
                return None
            token = uuid.uuid4().hex
            self._sessions[token] = _Session(blob)
        return {"token": token, "size": len(blob),
                "chunk_size": get_config().object_manager_chunk_size}

    def handle_chunk(self, payload):
        with self._lock:
            session = self._sessions.get(payload["token"])
            if session is None:
                return None
            session.last_access = time.monotonic()
            blob = session.blob
        chunk = get_config().object_manager_chunk_size
        start = payload["index"] * chunk
        return bytes(blob[start:start + chunk])

    def handle_close(self, payload) -> bool:
        with self._lock:
            return self._sessions.pop(payload["token"], None) is not None

    def _expire_locked(self):
        now = time.monotonic()
        for token in [t for t, s in self._sessions.items()
                      if now - s.last_access > self.SESSION_TTL_S]:
            del self._sessions[token]


def serve_chunks(server, get_blob: Callable[[bytes], Optional[bytes]],
                 max_sessions: int = 8,
                 prefix: str = "fetch") -> ChunkServer:
    """Register the chunk protocol on an RpcServer."""
    cs = ChunkServer(get_blob, max_sessions=max_sessions)
    server.register(f"{prefix}_meta", cs.handle_meta)
    server.register(f"{prefix}_chunk", cs.handle_chunk)
    server.register(f"{prefix}_close", cs.handle_close)
    return cs


def fetch_chunked(client, object_id_bin: bytes,
                  timeout: float = 300.0, prefix: str = "fetch",
                  pipeline: int = 4) -> Optional[bytes]:
    """Receiver side: pull an object of any size as chunk frames;
    ``busy`` replies back off and retry until the deadline."""
    deadline = time.monotonic() + timeout
    backoff = 0.02
    while True:
        meta = client.call(f"{prefix}_meta", {"object_id": object_id_bin},
                           timeout=min(60.0, timeout))
        if meta is None:
            return None
        if "inline" in meta:
            return meta["inline"]
        if meta.get("busy"):
            if time.monotonic() >= deadline:
                return None
            time.sleep(backoff)
            backoff = min(backoff * 2, 1.0)
            continue
        break
    return fetch_session(client, meta, timeout=timeout, prefix=prefix,
                         pipeline=pipeline)


def fetch_session(client, meta: dict, timeout: float = 300.0,
                  prefix: str = "fetch",
                  pipeline: int = 4) -> Optional[bytes]:
    """Pull an already-opened transfer session into a fresh buffer;
    None on a timeout or a session that expired sender-side."""
    out = bytearray(meta["size"])
    mv = memoryview(out)
    try:
        ok = fetch_session_into(
            client, meta, lambda off, data: _assign(mv, off, data),
            timeout=timeout, prefix=prefix, pipeline=pipeline)
    finally:
        mv.release()
    return bytes(out) if ok else None


def _assign(mv: memoryview, off: int, data) -> None:
    mv[off:off + len(data)] = data


def fetch_session_into(client, meta: dict, sink, timeout: float = 300.0,
                       prefix: str = "fetch", pipeline: int = 4,
                       on_chunk=None) -> bool:
    """Pull a session through a window of ``pipeline`` chunk requests
    into ``sink(offset, chunk_bytes)``, in order; each completed request
    acks its chunk, and ``on_chunk(nbytes, inflight)`` (optional) sees
    it.  False on a timeout or a sender-side expiry."""
    deadline = time.monotonic() + timeout
    token, size, chunk = meta["token"], meta["size"], meta["chunk_size"]
    n_chunks = (size + chunk - 1) // chunk
    try:
        next_index = 0
        inflight = {}
        received = 0
        while received < n_chunks:
            while next_index < n_chunks and len(inflight) < pipeline:
                inflight[next_index] = client.call_future(
                    f"{prefix}_chunk", {"token": token,
                                        "index": next_index})
                next_index += 1
            # The oldest in flight first: ordered assembly keeps the
            # sink's writes sequential.
            index = min(inflight)
            fut = inflight.pop(index)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            data = fut.result(timeout=remaining)
            if data is None:
                return False      # session expired sender-side
            sink(index * chunk, data)
            received += 1
            if on_chunk is not None:
                on_chunk(len(data), len(inflight))
        return True
    finally:
        try:
            client.call_async(f"{prefix}_close", {"token": token},
                              lambda _r, _e: None)
        except Exception:
            pass
