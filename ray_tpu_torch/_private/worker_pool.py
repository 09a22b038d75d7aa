"""Per-node worker pool of executor threads.

A port of the thread half of ``ray_tpu._private.worker_pool`` for the
PyTorch port (reference ``src/ray/raylet/worker_pool.{h,cc}``): a
``Worker`` is one executor thread of the node's process that runs the
normal tasks pushed to it (``CoreWorkerService.PushTask`` parity), or,
once ``assign_actor`` ran an actor's creation task on it, is dedicated
to that actor: its methods arrive by ``submit_actor_task``, in order on
the worker's own thread, on ``max_concurrency - 1`` more threads that
share its queue, or on the threads of a named concurrency group
(``concurrency_group_manager.cc``), each group with its queue and
``size`` threads; ``kill_actor`` stops it, and its exit reports the
actor's death to its raylet (``on_actor_worker_exit``).  ``pop_worker``
leases an idle worker or starts one under ``max_workers_per_node``,
``maximum_startup_concurrency`` and the process-wide start slots
(``worker_global_startup_concurrency``); ``push_worker`` returns it,
keeping at most ``num_workers_soft_limit`` idle (the oldest goes first);
``prestart_for_backlog`` warms idle workers ahead of a queued burst;
``promote_to_actor`` moves a worker whose actor started from the leased
set to the actor set, and ``worker_for_actor`` finds an actor's worker
(a restarted GCS reconciles with it).

Divergences: ``prestart_for_backlog`` starts its workers inline, on the
caller's thread (the raylet's loop), where the reference uses a
throwaway thread; an idle worker blocks on its queue where the
reference polls it every second.  A worker whose actor was created is
promoted to the actor set at once (the reference defines
``promote_to_actor`` and calls it nowhere, so its actor workers stay
counted as leased, and the backlog prestart counts them as warm).  A
constructor that raises returns its lease to the raylet (the reference
keeps the worker leased, with any resources the actor would hold, for
ever).  An actor method queued at a worker that stopped, or taken off
its queue after ``kill_actor``, fails with ``WorkerCrashedError``
(the reference leaves it unanswered).

Left out until their items: process workers and the runtime-env keyed
reuse that comes with them (``worker_process_mode="process"`` raises at
``init``; ROADMAP A.4b.9).
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

_EXIT = ("exit", None, None)


class WorkerState:
    IDLE = "IDLE"
    LEASED = "LEASED"
    ACTOR = "ACTOR"
    DEAD = "DEAD"


class Worker:
    """One executor thread of a node; may become dedicated to an actor."""

    def __init__(self, pool: "WorkerPool", node):
        self.worker_id = WorkerID.from_random()
        self.node = node
        self.node_id = node.node_id
        self._pool = pool
        self.state = WorkerState.IDLE
        self._queue: "queue.Queue" = queue.Queue()
        self.actor_id = None
        self.actor_instance = None
        self._actor_threads: List[threading.Thread] = []
        self._group_queues: Dict[str, "queue.Queue"] = {}
        self._killed = threading.Event()
        self._stop_sent = False
        self._exited = False
        self._thread = threading.Thread(
            target=self._main_loop, daemon=True,
            name=f"ray_tpu_torch::worker::{self.worker_id.hex()[:8]}")
        self._thread.start()

    def push_task(self, spec, on_done: Callable):
        """Execute a normal task on this worker
        (CoreWorkerService.PushTask parity); ``on_done(error or None)``
        runs on this worker's thread, or fails with
        ``WorkerCrashedError`` on the caller's when the worker has
        exited."""
        self._put(self._queue, ("task", spec, on_done))

    def assign_actor(self, creation_spec, on_done: Callable):
        """Run the actor's creation task; on success this worker is
        dedicated to the actor until it dies."""
        self._put(self._queue, ("create_actor", creation_spec, on_done))

    def submit_actor_task(self, spec, on_done: Callable):
        """Run an actor method: in order on this worker's thread (or on
        its ``max_concurrency`` threads), or on the threads of the
        method's concurrency group."""
        group = spec.concurrency_group
        gq = self._group_queues.get(group) if group else None
        self._put(gq if gq is not None else self._queue,
                  ("actor_task", spec, on_done))

    def _put(self, q: "queue.Queue", item) -> None:
        q.put(item)
        if self._exited:
            self._fail_queued()

    def kill_actor(self):
        """Stop the actor's threads after their current methods; the
        exit reports the actor's death to the raylet."""
        self.stop()

    def stop(self):
        """Stop the threads after their current task.  The worker is
        marked dead and leaves its pool at once, where the reference
        does both when the thread exits: a stopped worker takes no new
        lease either way."""
        if self._stop_sent:
            return
        self._stop_sent = True
        self._killed.set()
        self._queue.put(_EXIT)
        for gq in list(self._group_queues.values()):
            gq.put(_EXIT)
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)

    def join(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in [self._thread] + list(self._actor_threads):
            if t is threading.current_thread():
                continue
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))

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
                # Siblings of the default group share this queue.
                self._queue.put(_EXIT)
                break
            try:
                if kind == "create_actor":
                    self._handle_create_actor(spec, on_done, executor_mod)
                elif kind == "actor_task":
                    self._run_actor_task(spec, on_done, executor_mod)
                else:
                    ok, err = executor_mod.execute_task(
                        spec, self.node, self.node.core_worker)
                    on_done(None if ok else err)
            except Exception as e:  # framework error, not user error
                logger.exception("worker %s: task %s failed in the "
                                 "runtime", self.worker_id,
                                 getattr(spec, "task_id", None))
                self._answer(on_done, exceptions.RayTpuError(str(e)))
            # Drop the frame's bindings: an idle worker must not pin the
            # last spec (its inline args hold live ObjectRefs, keeping
            # them would defer the owner's release indefinitely).
            kind = spec = on_done = None
        self._on_exit()

    def _handle_create_actor(self, spec, on_done, executor_mod):
        ok, result = executor_mod.execute_task(
            spec, self.node, self.node.core_worker)
        if not ok:
            on_done(result)
            # The lease goes back with the resources it held.
            self.node.return_worker(self)
            return
        self.actor_id = spec.actor_id
        self.actor_instance = result
        for i in range(max(1, spec.max_concurrency) - 1):
            self._start_actor_thread(self._queue, f"cc{i}")
        # Named concurrency groups: each with its own queue and threads,
        # concurrent with the default group and with each other.
        for gname, gsize in (spec.concurrency_groups or {}).items():
            gq: "queue.Queue" = queue.Queue()
            self._group_queues[gname] = gq
            for i in range(max(1, int(gsize))):
                self._start_actor_thread(gq, f"cg-{gname}-{i}")
        if self._stop_sent:
            # Killed during the construction: the group threads exit too.
            for gq in self._group_queues.values():
                gq.put(_EXIT)
        if self.state != WorkerState.DEAD:
            self.state = WorkerState.ACTOR
            self._pool.promote_to_actor(self)
        on_done(None)

    def _start_actor_thread(self, source: "queue.Queue", tag: str):
        t = threading.Thread(target=self._actor_concurrent_loop,
                             args=(source,), daemon=True,
                             name=f"{self._thread.name}::{tag}")
        self._actor_threads.append(t)
        t.start()

    def _run_actor_task(self, spec, on_done, executor_mod):
        if self._killed.is_set():
            on_done(self._crashed(spec))
            return
        ok, err = executor_mod.execute_task(
            spec, self.node, self.node.core_worker,
            actor_instance=self.actor_instance)
        on_done(None if ok else err)

    def _actor_concurrent_loop(self, source: "queue.Queue"):
        worker_context.set_context(
            worker_context.ExecutionContext(worker=self, node=self.node))
        from ray_tpu_torch._private import executor as executor_mod
        while True:
            kind, spec, on_done = source.get()
            if kind == "exit":
                source.put(_EXIT)     # for the siblings
                return
            try:
                self._run_actor_task(spec, on_done, executor_mod)
            except Exception as e:  # framework error, not user error
                logger.exception("worker %s: actor task %s failed in the "
                                 "runtime", self.worker_id, spec.task_id)
                self._answer(on_done, exceptions.RayTpuError(str(e)))
            kind = spec = on_done = None   # no idle-frame pinning

    def _answer(self, on_done, error) -> None:
        """Report a runtime failure; a reply that raises again (its
        owner, a GCS that was shut down, is gone) is logged, and the
        thread lives on."""
        if on_done is None:
            return
        try:
            on_done(error)
        except Exception:
            logger.exception("worker %s: the failure reply raised",
                             self.worker_id)

    def _crashed(self, spec) -> exceptions.WorkerCrashedError:
        return exceptions.WorkerCrashedError(
            f"worker {self.worker_id.hex()[:8]} stopped before task "
            f"{spec.task_id.hex()[:8]} ran")

    def _on_exit(self):
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)
        self._exited = True
        self._fail_queued()
        if self.actor_id is not None:
            self.node.on_actor_worker_exit(self.actor_id, self.worker_id)

    def _fail_queued(self):
        """A task or method queued here after the stop never runs: fail
        it, so its owner retries it or learns of the death (the
        reference leaves it unanswered)."""
        for q in [self._queue] + list(self._group_queues.values()):
            while True:
                try:
                    kind, spec, on_done = q.get_nowait()
                except queue.Empty:
                    break
                if kind != "exit":
                    on_done(self._crashed(spec))
            q.put(_EXIT)


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
        # Workers dedicated to an actor: their lease is never returned.
        self._actors: Dict[WorkerID, Worker] = {}
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
        self._stopped: List[Worker] = []
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
            if worker.state == WorkerState.ACTOR:
                self._actors[worker.worker_id] = worker
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

    def promote_to_actor(self, worker: Worker):
        """The worker's actor started: it leaves the leased set for
        good."""
        with self._lock:
            if self._leased.pop(worker.worker_id, None) is not None:
                self._actors[worker.worker_id] = worker

    def on_worker_exit(self, worker: Worker):
        with self._lock:
            self._all.pop(worker.worker_id, None)
            self._leased.pop(worker.worker_id, None)
            if self._actors.pop(worker.worker_id, None) is not None:
                # Joined at shutdown: a killed actor's threads may still
                # be finishing its methods.
                self._stopped.append(worker)
            if worker in self._idle:
                self._idle.remove(worker)

    def worker_for_actor(self, actor_id) -> Optional[Worker]:
        """The live worker dedicated to ``actor_id`` (a restarted GCS
        reconciles with it), or None."""
        with self._lock:
            for w in self._all.values():
                if w.actor_id == actor_id and w.state == WorkerState.ACTOR:
                    return w
            return None

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
            # A second call (after a kill that waited for nothing) joins
            # the threads the first one stopped.
            self._stopped += workers
            workers = list(self._stopped)
        for w in workers:
            w.stop()
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
