"""Per-node worker pool: lease slots only.

The lease half of ``ray_tpu._private.worker_pool.WorkerPool`` for the
PyTorch port: ``pop_worker`` leases an idle worker or makes one under
``max_workers_per_node``, ``push_worker`` returns it, and
``prestart_for_backlog`` warms idle workers ahead of a queued burst.

A stand-in until the core worker is ported: a ``Worker`` here is a
lease slot (an id and the runtime env it was leased for) and executes
nothing.  Whoever holds the lease returns the worker through
``Raylet.return_worker``.  Thread and process workers, runtime-env
keyed reuse and the idle soft limit come with the core worker.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import WorkerID


class WorkerState:
    IDLE = "IDLE"
    LEASED = "LEASED"
    DEAD = "DEAD"


class Worker:
    """One lease slot of a node."""

    def __init__(self, pool: "WorkerPool", node_id, runtime_env=None):
        self.worker_id = WorkerID.from_random()
        self.node_id = node_id
        self.runtime_env = runtime_env
        self.state = WorkerState.IDLE
        self._pool = pool

    def stop(self):
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)


class WorkerPool:
    def __init__(self, node):
        self._node = node
        self._lock = threading.Lock()
        self._idle: List[Worker] = []
        self._leased: Dict[WorkerID, Worker] = {}
        self._all: Dict[WorkerID, Worker] = {}
        self._max_workers = get_config().max_workers_per_node

    def prestart_workers(self, n: int) -> int:
        """Add up to ``n`` idle workers under the cap; returns how many."""
        with self._lock:
            count = max(0, min(n, self._max_workers - len(self._all)))
            for _ in range(count):
                w = Worker(self, self._node.node_id)
                self._all[w.worker_id] = w
                self._idle.append(w)
            return count

    def prestart_for_backlog(self, depth: int, bound: int) -> int:
        """Bring idle + leased workers up to ``min(depth, bound)`` (the
        reference's predictive prestart).  A worker here is a slot, so
        it is made inline where the reference starts a thread.  Returns
        the shortfall this call saw."""
        with self._lock:
            warm = len(self._idle) + len(self._leased)
            room = self._max_workers - len(self._all)
            want = min(min(depth, bound) - warm, room)
        if want <= 0:
            return 0
        self.prestart_workers(want)
        return want

    def pop_worker(self, runtime_env=None) -> Optional[Worker]:
        """Lease an idle worker, making one if under the cap; None at
        the cap (the dispatch loop retries when a worker returns)."""
        with self._lock:
            if self._idle:
                w = self._idle.pop()
            elif len(self._all) < self._max_workers:
                w = Worker(self, self._node.node_id)
                self._all[w.worker_id] = w
            else:
                return None
            w.runtime_env = runtime_env
            w.state = WorkerState.LEASED
            self._leased[w.worker_id] = w
            return w

    def push_worker(self, worker: Worker):
        """Return a leased worker to the idle pool."""
        with self._lock:
            self._leased.pop(worker.worker_id, None)
            if worker.state == WorkerState.DEAD:
                return
            worker.state = WorkerState.IDLE
            self._idle.append(worker)

    def on_worker_exit(self, worker: Worker):
        with self._lock:
            self._all.pop(worker.worker_id, None)
            self._leased.pop(worker.worker_id, None)
            if worker in self._idle:
                self._idle.remove(worker)

    def num_idle(self) -> int:
        with self._lock:
            return len(self._idle)

    def num_total(self) -> int:
        with self._lock:
            return len(self._all)

    def shutdown(self):
        with self._lock:
            for w in self._all.values():
                w.state = WorkerState.DEAD
            self._all.clear()
            self._leased.clear()
            self._idle.clear()
