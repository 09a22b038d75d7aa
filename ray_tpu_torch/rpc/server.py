"""Threaded RPC server: the process-boundary front of a service surface.

A port of ``ray_tpu.rpc.server`` for the PyTorch port (reference
``src/ray/rpc/grpc_server.h``: a ``GrpcServer`` binds a port and
dispatches each inbound call to a registered handler on an io-context
thread).  One acceptor thread, one reader thread per connection, and
each request dispatched on the port's ``DaemonPool`` of
``rpc_dispatch_pool_size`` threads (a request past the pool takes a
thread of its own, as many handlers block on other requests to the same
server), so a blocking handler never stalls pipelined requests.

Handlers are ``name -> callable(payload) -> reply``.  A handler may
instead take ``(payload, reply_cb)`` (``register_async``): the reply is
sent whenever ``reply_cb(result)`` fires.

Requests that carry a client-minted dedup token (the frame's 4th
element, see ``rpc.verbs``) run through a bounded dedup window: the
handler runs once per token, and duplicates get the recorded reply (or
park until the first run replies).

Left out until the fault plane (ROADMAP A.4b.7b): the ``rpc.recv``
fault point.  ``stop`` closes every connection and joins the server's
threads (each bounded), so that none outlives it.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Tuple

from ray_tpu_torch.rpc import wire

logger = logging.getLogger(__name__)


def _shutdown_close(sock: socket.socket):
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _DedupWindow:
    """Bounded at-most-once window over client-minted request tokens.

    One entry per token: while the first delivery's handler runs the
    entry is pending and duplicate deliveries park their repliers on it;
    once the handler replies the entry caches ``(ok, payload)`` and later
    duplicates get the recorded reply at once.  Past ``size`` entries the
    oldest completed ones are evicted (a pending one never is: its
    handler still runs, and a retry must not run it again)."""

    def __init__(self, size: int):
        self._size = max(8, size)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, dict]" = OrderedDict()
        self.hits = 0      # duplicate deliveries absorbed

    def admit(self, token: bytes, replier: Callable[[bool, Any], None]
              ) -> bool:
        """True: the caller runs the handler (first delivery).  False: a
        duplicate, whose recorded reply was sent (or whose replier is
        parked until the first run completes)."""
        with self._lock:
            entry = self._entries.get(token)
            if entry is None:
                self._entries[token] = {"done": False, "waiters": []}
                if len(self._entries) > self._size:
                    for tok in list(self._entries):
                        if len(self._entries) <= self._size:
                            break
                        if self._entries[tok]["done"]:
                            del self._entries[tok]
                return True
            self.hits += 1
            if not entry["done"]:
                entry["waiters"].append(replier)
                return False
            ok, payload = entry["ok"], entry["payload"]
        replier(ok, payload)
        return False

    def complete(self, token: bytes, ok: bool, payload: Any) -> None:
        with self._lock:
            entry = self._entries.get(token)
            if entry is None or entry["done"]:
                waiters = []
            else:
                entry["done"] = True
                entry["ok"] = ok
                entry["payload"] = payload
                waiters, entry["waiters"] = entry["waiters"], []
        for w in waiters:
            w(ok, payload)


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "rpc"):
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch._private.daemon_pool import DaemonPool
        self._handlers: Dict[str, Tuple[Callable, bool]] = {}
        self._name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._stopped = threading.Event()
        self._conns: set = set()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()   # conns, threads, active count
        cfg = get_config()
        self._pool_size = cfg.rpc_dispatch_pool_size
        self._pool = DaemonPool(self._pool_size,
                                name=f"ray_tpu_torch::rpc::{name}::pool")
        self.dedup_window = _DedupWindow(cfg.rpc_dedup_window_size)
        self._active = 0
        self._spawn(self._accept_loop, (), "accept")

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def _spawn(self, target, args, tag: str) -> None:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=f"ray_tpu_torch::rpc::{self._name}::{tag}")
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    # ---- registry ------------------------------------------------------
    def register(self, method: str, handler: Callable[[Any], Any]):
        """Sync handler: its return value is the reply."""
        self._handlers[method] = (handler, False)

    def register_async(self, method: str,
                       handler: Callable[[Any, Callable], None]):
        """Callback handler: ``handler(payload, reply_cb)``; the reply is
        sent when ``reply_cb(result)`` is called (once)."""
        self._handlers[method] = (handler, True)

    # ---- lifecycle -----------------------------------------------------
    def stop(self, timeout: float = 5.0):
        """Stop accepting, close every connection and join the server's
        threads, all of them within ``timeout`` seconds; a handler still
        running past it is logged."""
        self._stopped.set()
        # shutdown() before close(): a close alone does not tear the
        # connection down while another thread is blocked in recv on
        # the same fd (the syscall pins the file description).
        _shutdown_close(self._sock)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            _shutdown_close(c)
        self._pool.stop(timeout=timeout)
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))
        left = [t.name for t in threads if t.is_alive()]
        if left:
            logger.warning("rpc server %s: threads still running after "
                           "stop: %s", self._name, left)

    # ---- loops ---------------------------------------------------------
    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stopped.is_set():
                    _shutdown_close(conn)
                    return
                self._conns.add(conn)
            self._spawn(self._reader_loop, (conn,), "conn")

    def _reader_loop(self, conn: socket.socket):
        write_lock = threading.Lock()
        try:
            try:
                wire.expect_preamble(conn)
            except (wire.ConnectionClosed, OSError, EOFError):
                return   # a wrong-version (or non-wire) peer is dropped
            while not self._stopped.is_set():
                try:
                    msg = wire.recv_msg(conn)
                except (wire.ConnectionClosed, OSError, EOFError):
                    return
                token = msg[3] if len(msg) > 3 else None
                self._submit_dispatch(conn, write_lock, msg[0], msg[1],
                                      msg[2], token)
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _submit_dispatch(self, conn, write_lock, msg_id, method,
                         payload, token=None):
        args = (conn, write_lock, msg_id, method, payload, token)
        with self._lock:
            pooled = self._active < self._pool_size
            if pooled:
                self._active += 1
        if pooled:
            def run():
                try:
                    self._dispatch(*args)
                finally:
                    with self._lock:
                        self._active -= 1

            try:
                self._pool.submit(run)
                return
            except RuntimeError:      # the pool stopped mid-stop
                with self._lock:
                    self._active -= 1
                return
        self._spawn(self._dispatch, args, "call")

    def _dispatch(self, conn, write_lock, msg_id, method, payload,
                  token=None):
        entry = self._handlers.get(method)
        if entry is None:
            self._reply(conn, write_lock, msg_id, False,
                        f"no such method: {method}")
            return
        handler, is_async = entry
        if token is not None:
            # At most once: duplicates get the first run's reply.
            def replier(ok, result, _c=conn, _wl=write_lock, _m=msg_id):
                self._reply(_c, _wl, _m, ok, result)

            if not self.dedup_window.admit(token, replier):
                return
        if is_async:
            replied = threading.Event()

            def reply_cb(result):
                if not replied.is_set():
                    replied.set()
                    if token is not None:
                        self.dedup_window.complete(token, True, result)
                    self._reply(conn, write_lock, msg_id, True, result)

            try:
                handler(payload, reply_cb)
            except Exception:
                if not replied.is_set():
                    replied.set()
                    tb = traceback.format_exc()
                    if token is not None:
                        self.dedup_window.complete(token, False, tb)
                    self._reply(conn, write_lock, msg_id, False, tb)
            return
        try:
            result = handler(payload)
        except Exception:
            tb = traceback.format_exc()
            if token is not None:
                self.dedup_window.complete(token, False, tb)
            self._reply(conn, write_lock, msg_id, False, tb)
            return
        if token is not None:
            self.dedup_window.complete(token, True, result)
        self._reply(conn, write_lock, msg_id, True, result)

    def _reply(self, conn, write_lock, msg_id, ok, payload):
        try:
            wire.send_msg(conn, (msg_id, ok, payload), lock=write_lock)
        except (OSError, wire.ConnectionClosed):
            pass  # the peer is gone; nothing to tell it
