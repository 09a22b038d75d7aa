"""RPC client: one persistent connection, concurrent in-flight calls.

A port of ``ray_tpu.rpc.client`` for the PyTorch port (reference
``src/ray/rpc/client_call.h``: each call carries a tag and replies are
matched back on the io context; the per-peer client pools of
``core_worker_client_pool.h``).  Calls are correlated by ``msg_id``; a
reader thread resolves each reply into its waiting future, so any
number of threads can call concurrently over the one socket.

* transport failures raise :class:`RpcConnectionError` (a subclass of
  :class:`RpcError`), so that callers and the retry loop can tell "the
  wire died" from "the remote handler raised";
* ``call`` retries timeouts and connection losses for the verbs
  classified in :mod:`ray_tpu_torch.rpc.verbs`, minting one dedup token
  per logical call for the mutating ones, so that the server's dedup
  window collapses the retries into one side effect.

Left out until the fault plane (ROADMAP A.4b.7b): the ``rpc.send`` fault
point before every request.  Left out until node hosts on the wire
(A.4b.9b), whose lease path alone uses them: ``on_reconnect`` and
``call_async``'s per-attempt timeout and retries.  ``close`` joins the
reader thread, so that no thread of the port outlives its client.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.rpc import verbs as verbs_mod
from ray_tpu_torch.rpc import wire

logger = logging.getLogger(__name__)


class RpcError(Exception):
    """Remote handler raised (payload = remote traceback) or the
    connection failed."""


class RpcConnectionError(RpcError):
    """Transport-level failure (send failed, connection lost): the
    request may never have reached the handler, so a classified verb is
    safe to retry."""


def _retry_config() -> Tuple[int, float]:
    from ray_tpu_torch._private.config import get_config
    cfg = get_config()
    return max(1, cfg.rpc_retry_attempts), cfg.rpc_retry_backoff_s


class RpcClient:
    def __init__(self, address: Tuple[str, int],
                 connect_timeout: float = 10.0):
        self.address = tuple(address)
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()          # guards sock + pending
        self._write_lock = threading.Lock()
        self._sock = None
        self._reader: Optional[threading.Thread] = None
        self._pending: Dict[int, Future] = {}
        self._ids = itertools.count(1)
        self._closed = False

    # ---- public --------------------------------------------------------
    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = 60.0,
             retry: Optional[bool] = None) -> Any:
        """Blocking call.  Verbs classified in :mod:`verbs` are retried
        with backoff on a timeout or a connection loss (``retry=False``
        opts out, ``retry=True`` forces it for an unclassified verb);
        a mutating classified verb rides one dedup token across its
        retries.  A remote handler's exception is never retried."""
        retryable = verbs_mod.is_retryable(method) if retry is None \
            else bool(retry)
        if not retryable:
            return self.call_future(method, payload).result(timeout=timeout)
        attempts, backoff = _retry_config()
        token = uuid.uuid4().bytes if verbs_mod.needs_dedup(method) else None
        last_err: Optional[Exception] = None
        for attempt in range(attempts):
            fut = self.call_future(method, payload, dedup_token=token)
            try:
                return fut.result(timeout=timeout)
            except FutureTimeoutError:
                last_err = RpcConnectionError(
                    f"{method} to {self.address} timed out "
                    f"(attempt {attempt + 1}/{attempts})")
            except RpcConnectionError as e:
                last_err = e
            if self._closed:
                break
            if attempt + 1 < attempts:
                time.sleep(backoff * (2 ** attempt))
        raise last_err

    def call_future(self, method: str, payload: Any = None,
                    dedup_token: Optional[bytes] = None) -> Future:
        fut: Future = Future()
        msg_id = next(self._ids)
        if dedup_token is None and verbs_mod.needs_dedup(method):
            # Even a one-shot send of a mutating verb carries a token:
            # a duplicate delivery collapses in the server's window as
            # a retry would.
            dedup_token = uuid.uuid4().bytes
        msg = (msg_id, method, payload) if dedup_token is None \
            else (msg_id, method, payload, dedup_token)
        try:
            sock = self._ensure_connected()
            with self._lock:
                self._pending[msg_id] = fut
            # A future completed by anything other than the reader (a
            # caller's timeout) must not leave its entry behind for the
            # connection's life; a late reply for a popped id is skipped.
            fut.add_done_callback(
                lambda _f, _mid=msg_id: self._discard_pending(_mid))
            wire.send_msg(sock, msg, lock=self._write_lock)
        except Exception as e:
            with self._lock:
                self._pending.pop(msg_id, None)
            if not fut.done():
                fut.set_exception(RpcConnectionError(
                    f"send to {self.address} failed: {e}"))
        return fut

    def _discard_pending(self, msg_id: int):
        with self._lock:
            self._pending.pop(msg_id, None)

    def call_async(self, method: str, payload: Any,
                   callback: Callable[[Any, Optional[Exception]], None]):
        """``callback(result, error)`` when the reply lands (on the
        reader thread)."""
        fut = self.call_future(method, payload)

        def on_done(f: Future):
            err = f.exception()
            callback(None if err else f.result(), err)

        fut.add_done_callback(on_done)

    def close(self, timeout: float = 5.0):
        """Close the connection, fail the calls in flight and join the
        reader thread (bounded by ``timeout``)."""
        self._closed = True
        with self._lock:
            sock, self._sock = self._sock, None
            reader, self._reader = self._reader, None
        if sock is not None:
            # shutdown() wakes the reader thread blocked in recv (close
            # alone leaves the file description pinned by the syscall).
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout)

    # ---- internals -----------------------------------------------------
    def _ensure_connected(self):
        with self._lock:
            if self._closed:
                raise RpcError("client closed")
            if self._sock is not None:
                return self._sock
            sock = wire.connect(self.address, timeout=self._connect_timeout)
            self._sock = sock
            self._reader = threading.Thread(
                target=self._reader_loop, args=(sock,), daemon=True,
                name=f"ray_tpu_torch::rpc::client::{self.address[1]}")
            self._reader.start()
        return sock

    def _reader_loop(self, sock):
        try:
            while True:
                msg_id, ok, payload = wire.recv_msg(sock)
                with self._lock:
                    fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue      # the caller stopped waiting
                # try/except, not check-then-act: a caller's timeout can
                # complete the future between the done() check and here,
                # and an error escaping this loop would kill the reader
                # without failing the pending futures.  The reference
                # counts it in its debug plane (ROADMAP A.4b.7b).
                try:
                    if ok:
                        fut.set_result(payload)
                    else:
                        fut.set_exception(RpcError(str(payload)))
                except Exception:
                    logger.debug("rpc: a stale reply to %s", self.address)
        except (wire.ConnectionClosed, OSError, EOFError) as e:
            with self._lock:
                if self._sock is sock:
                    self._sock = None   # reconnect on next call
                pending, self._pending = self._pending, {}
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(RpcConnectionError(
                        f"connection to {self.address} lost: {e}"))
        finally:
            try:
                sock.close()
            except OSError:
                pass
