"""The spill thread of one raylet.

A port of ``ray_tpu._private.local_object_manager`` for the PyTorch port
(reference ``src/ray/raylet/local_object_manager.{h,cc}``): the raylet's
spill orchestrator, one thread per raylet (spilling is bound by the
disk, not the CPU), with the reference's semantics:

* **fused batches**: many small objects per spill file
  (``min_spilling_size``), each recorded as ``path?offset=&size=``;
* **copy-out outside the store lock**: victims are marked under the lock
  (``select_spill_victims``), written unlocked, and published at once
  (``finish_spill_batch``); a delete racing the write wins;
* **backpressure**: queued creates (``_ensure_capacity``) call
  ``request_spill`` and each finished batch wakes them.

The thread blocks until asked to spill or stopped (the reference wakes
every half second), and ``stop`` joins it.  The watchdog registration,
fault-injection point, tracing span and flight recorder of the
reference are its debug planes (ROADMAP A.4b.7).
"""

from __future__ import annotations

import logging
import os
import threading
import uuid

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch._private.object_store import write_flat

logger = logging.getLogger(__name__)


class LocalObjectManager:
    """The spill thread over one :class:`NodeObjectStore`."""

    def __init__(self, store, spill_dir: str, node_label: str = ""):
        self._store = store
        self._spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self.stats = {"spill_batches": 0, "spilled_objects": 0,
                      "spilled_bytes": 0, "spill_errors": 0}
        labels = {"node": node_label or "local"}

        def _collect(mgr):
            for k, v in mgr.stats.items():
                record_internal(f"ray_tpu.local_object_manager.{k}", v,
                                **labels)
        get_metrics_registry().register_collector(self, _collect)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"ray_tpu_torch::spill::{node_label or 'local'}")
        self._thread.start()

    # ---- control --------------------------------------------------------
    def request_spill(self) -> None:
        """Hot-path kick (queued create, put over the threshold): one
        Event set, no lock, no IO."""
        self._wake.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the thread and join it after its current batch."""
        self._stopped.set()
        self._wake.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)

    # ---- the thread -----------------------------------------------------
    def _loop(self) -> None:
        while True:
            self._wake.wait()
            if self._stopped.is_set():
                return
            self._wake.clear()
            try:
                while self._store.spill_shortfall() > 0 and \
                        not self._stopped.is_set():
                    if not self._spill_once():
                        break
            except Exception:
                # The spiller must survive anything (a full disk): the
                # create queue's deadline still bounds callers.
                self.stats["spill_errors"] += 1
                logger.exception("spill batch failed")

    def _spill_once(self) -> bool:
        cfg = get_config()
        shortfall = self._store.spill_shortfall()
        if shortfall <= 0:
            return False
        # Fuse small objects: at least min_spilling_size per file,
        # capped to half the store (a tiny store must not spill
        # everything in one sweep).
        max_bytes = max(shortfall,
                        min(cfg.min_spilling_size,
                            self._store.capacity // 2))
        batch = self._store.select_spill_victims(max_bytes)
        if not batch:
            return False
        path = os.path.join(self._spill_dir,
                            f"batch-{uuid.uuid4().hex[:12]}")
        results = []
        offset = 0
        try:
            with open(path, "wb") as f:
                for object_id, entry, source in batch:
                    nbytes = write_flat(f, source)
                    results.append((object_id, entry, offset, nbytes,
                                    True))
                    offset += nbytes
        except OSError:
            # The whole batch fails closed: its victims stay in memory
            # and the (partial) file goes.
            self.stats["spill_errors"] += 1
            self._store.finish_spill_batch(
                path, [(object_id, entry, 0, 0, False)
                       for object_id, entry, _ in batch])
            _unlink(path)
            return False
        n = self._store.finish_spill_batch(path, results)
        if n == 0:
            # Every victim was deleted mid-copy: drop the orphan file.
            _unlink(path)
            return True
        self.stats["spill_batches"] += 1
        self.stats["spilled_objects"] += n
        self.stats["spilled_bytes"] += offset
        return True


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
