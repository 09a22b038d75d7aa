"""Daemon thread pool: bounded workers that never block process exit.

A copy of ``ray_tpu._private.daemon_pool`` for the PyTorch port, which
runs a node's pulls on it.  Two differences: an idle worker blocks on
its queue instead of waking every half second, and ``stop`` joins the
workers (after their current call), so that no thread of the port
outlives ``shutdown``.  A call that raises is logged, where the
reference counts it in its debug plane (ROADMAP A.4b.7).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

#: Queue entry that tells one worker to exit.
_STOP = None


class DaemonPool:
    def __init__(self, max_workers: int, name: str = "pool"):
        self._queue: "queue.Queue" = queue.Queue()
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        for i in range(max_workers):
            t = threading.Thread(target=self._loop, daemon=True,
                                 name=f"{name}::{i}")
            t.start()
            self._threads.append(t)

    def submit(self, fn: Callable, *args) -> None:
        if self._stopped.is_set():
            raise RuntimeError("pool stopped")
        self._queue.put((fn, args))

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:
                # A call's errors are its own to report; the worker must
                # survive them.
                logger.exception("daemon pool call %r failed", fn)

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        """Refuse new calls, drop the queued ones, and join every worker
        once its current call returns (each join bounded by
        ``timeout``)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        for _ in self._threads:
            self._queue.put(_STOP)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout)
