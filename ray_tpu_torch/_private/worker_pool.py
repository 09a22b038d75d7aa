"""Per-node worker pool of executor threads.

A port of the thread half of ``ray_tpu._private.worker_pool`` for the
PyTorch port (reference ``src/ray/raylet/worker_pool.{h,cc}``): a
``Worker`` is one executor thread of the node's process that runs the
normal tasks pushed to it (``CoreWorkerService.PushTask`` parity);
``pop_worker`` leases an idle worker or starts one under
``max_workers_per_node``, ``maximum_startup_concurrency`` and the
process-wide start slots (``worker_global_startup_concurrency``);
``push_worker`` returns it, keeping at most ``num_workers_soft_limit``
idle (the oldest goes first); ``prestart_for_backlog`` warms idle
workers ahead of a queued burst.

Divergences: ``prestart_for_backlog`` starts its workers inline, on the
caller's thread (the raylet's loop), where the reference uses a
throwaway thread; an idle worker blocks on its queue where the
reference polls it every second.

Left out until their items: actor workers (dedicated workers, actor
creation and method queues, concurrency groups; the actors item,
ROADMAP A.4b.5), process workers and the runtime-env keyed reuse that
comes with them (``worker_process_mode="process"`` raises at ``init``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import WorkerID

logger = logging.getLogger(__name__)


class WorkerState:
    IDLE = "IDLE"
    LEASED = "LEASED"
    DEAD = "DEAD"


class Worker:
    """One executor thread of a node."""

    def __init__(self, pool: "WorkerPool", node):
        self.worker_id = WorkerID.from_random()
        self.node = node
        self.node_id = node.node_id
        self._pool = pool
        self.state = WorkerState.IDLE
        self._queue: "queue.Queue" = queue.Queue()
        self._killed = threading.Event()
        self._thread = threading.Thread(
            target=self._main_loop, daemon=True,
            name=f"ray_tpu_torch::worker::{self.worker_id.hex()[:8]}")
        self._thread.start()

    def push_task(self, spec, on_done: Callable):
        """Execute a normal task on this worker
        (CoreWorkerService.PushTask parity); ``on_done(error or None)``
        runs on this worker's thread."""
        self._queue.put(("task", spec, on_done))

    def stop(self):
        """Stop the thread after its current task.  The worker is
        marked dead and leaves its pool at once, where the reference
        does both when the thread exits: a stopped worker takes no new
        lease either way."""
        self._killed.set()
        self._queue.put(("exit", None, None))
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)

    def join(self, timeout: Optional[float] = None):
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def _main_loop(self):
        worker_context.set_context(
            worker_context.ExecutionContext(worker=self, node=self.node))
        from ray_tpu_torch._private import executor as executor_mod
        while not self._killed.is_set():
            # Blocks without the reference's one-second poll: ``stop``
            # always enqueues "exit", and a cluster's idle workers would
            # otherwise wake thousands of times a second for the GIL.
            kind, spec, on_done = self._queue.get()
            if kind == "exit":
                break
            try:
                ok, err = executor_mod.execute_task(
                    spec, self.node, self.node.core_worker)
                on_done(None if ok else err)
            except Exception as e:  # framework error, not user error
                logger.exception("worker %s: task %s failed in the "
                                 "runtime", self.worker_id,
                                 getattr(spec, "task_id", None))
                if on_done is not None:
                    on_done(exceptions.RayTpuError(str(e)))
            # Drop the frame's bindings: an idle worker must not pin the
            # last spec (its inline args hold live ObjectRefs, keeping
            # them would defer the owner's release indefinitely).
            kind = spec = on_done = None
        self._on_exit()

    def _on_exit(self):
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)


# ---- process-wide startup gate (startup-storm throttle) -----------------
# Per-node caps (``maximum_startup_concurrency``) bound ONE pool; a
# 64-node cluster in one process is 64 pools starting workers at once.
# This gate caps workers in startup across every pool in the process
# (``worker_global_startup_concurrency``); a pop over the cap returns
# None and the dispatch tick retries.  Lock order: WorkerPool._lock may
# be held when the gate is taken, never the reverse.
_global_start_lock = threading.Lock()
_global_starting = 0


def _acquire_global_start_slots(n: int) -> int:
    """Claim up to ``n`` startup slots; returns how many were granted
    (0 when the gate is saturated)."""
    global _global_starting
    if n <= 0:
        return 0
    cap = get_config().worker_global_startup_concurrency
    with _global_start_lock:
        granted = n if cap <= 0 else \
            max(0, min(n, cap - _global_starting))
        _global_starting += granted
    return granted


def _release_global_start_slots(n: int):
    global _global_starting
    if n <= 0:
        return
    with _global_start_lock:
        _global_starting = max(0, _global_starting - n)


class WorkerPool:
    def __init__(self, node):
        self._node = node
        self._lock = threading.RLock()
        self._idle: List[Worker] = []
        self._leased: Dict[WorkerID, Worker] = {}
        self._all: Dict[WorkerID, Worker] = {}
        cfg = get_config()
        # Total cap is the runaway backstop; maximum_startup_concurrency
        # throttles concurrent starts, it is not a total cap.
        self._max_workers = cfg.max_workers_per_node
        self._max_starting = cfg.maximum_startup_concurrency
        self._starting = 0
        self._soft_limit = cfg.num_workers_soft_limit
        # Set by shutdown: a worker started after it (a tick still
        # dispatching on the raylet's loop) is stopped, not pooled.
        self._closed = False
        #: Most workers alive at once (threads of this pool).
        self.peak_workers = 0

    def _note_peak(self):
        # Callers hold self._lock.
        if len(self._all) > self.peak_workers:
            self.peak_workers = len(self._all)

    def prestart_workers(self, n: int) -> int:
        """Start up to ``n`` idle workers under the caps; returns how
        many."""
        with self._lock:
            capacity = self._max_workers - len(self._all) - self._starting
            count = max(0, min(n, capacity,
                               self._max_starting - self._starting))
            if self._closed:
                count = 0
            count = _acquire_global_start_slots(count)
            self._starting += count
        created = []
        try:
            for _ in range(count):
                created.append(Worker(self, self._node))
        finally:
            _release_global_start_slots(count)
            with self._lock:
                self._starting -= count
                for w in created:
                    if self._closed:
                        w.stop()
                        continue
                    self._all[w.worker_id] = w
                    self._idle.append(w)
                self._note_peak()
        return len(created)

    def prestart_for_backlog(self, depth: int, bound: int) -> int:
        """Bring idle + starting + leased workers up to
        ``min(depth, bound)`` (the reference's predictive prestart,
        ``PrestartWorkers``, worker_pool.h:350), started inline (module
        docstring).  Returns the shortfall this call saw."""
        with self._lock:
            warm = len(self._idle) + self._starting + len(self._leased)
            room = self._max_workers - len(self._all) - self._starting
            want = min(min(depth, bound) - warm, room)
        if want <= 0:
            return 0
        self.prestart_workers(want)
        return want

    def pop_worker(self, runtime_env=None) -> Optional[Worker]:
        """Lease an idle worker, starting one if under the caps
        (WorkerPool::PopWorker, worker_pool.h:338); None at a cap (the
        dispatch loop retries when a worker returns).  Thread workers
        are universal: ``runtime_env`` does not key them."""
        with self._lock:
            if self._closed:
                return None
            while self._idle:
                w = self._idle.pop()
                if w.state != WorkerState.IDLE:
                    continue
                w.state = WorkerState.LEASED
                self._leased[w.worker_id] = w
                return w
            total = len(self._all) + self._starting
            if total >= self._max_workers or \
                    self._starting >= self._max_starting:
                return None      # caller retries on the dispatch tick
            if _acquire_global_start_slots(1) < 1:
                return None      # process-wide storm throttle; retried
            self._starting += 1
        # Start the thread outside the lock: concurrent leases and
        # returns must not wait on it.
        try:
            w = Worker(self, self._node)
        except BaseException:
            with self._lock:
                self._starting -= 1
            _release_global_start_slots(1)
            raise
        _release_global_start_slots(1)
        with self._lock:
            self._starting -= 1
            if self._closed:
                w.stop()
                return None
            self._all[w.worker_id] = w
            w.state = WorkerState.LEASED
            self._leased[w.worker_id] = w
            self._note_peak()
            return w

    def push_worker(self, worker: Worker):
        """Return a leased worker to the idle pool; past the soft limit
        the oldest idle worker stops (LRU, ray_config_def.h:129)."""
        with self._lock:
            self._leased.pop(worker.worker_id, None)
            if worker.state == WorkerState.DEAD:
                return
            worker.state = WorkerState.IDLE
            if len(self._idle) >= self._soft_limit:
                if not self._idle:
                    # soft_limit == 0: keep no idle workers at all.
                    self._all.pop(worker.worker_id, None)
                    worker.stop()
                    return
                victim = self._idle.pop(0)
                self._all.pop(victim.worker_id, None)
                victim.stop()
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

    def shutdown(self, timeout: float = 5.0):
        """Stop every worker and wait up to ``timeout`` seconds in all
        for their threads (a task still running holds its thread until
        it returns)."""
        with self._lock:
            self._closed = True
            workers = list(self._all.values())
        for w in workers:
            w.stop()
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
