"""CoreWorker — the in-process runtime of the driver (and, logically, of
every executor thread).

A port of the task half of ``ray_tpu._private.core_worker`` for the
PyTorch port (reference ``src/ray/core_worker/core_worker.cc``): ``Put``
(:878), ``Get`` (:1081), ``Wait``, ``SubmitTask`` (:1650), the argument
builder, the executor's argument fetch and the return path, over the
owner's memory store, the reference counter, the task manager and the
direct task submitter.

Objects live in the owner's memory store only.  The reference promotes
an object above ``max_direct_call_object_size`` (100 KiB) to a node
store, and a literal argument above ``task_args_inline_bytes_limit`` to
such an object; the port has no node store yet, so a ``put``, a return
value or an argument of that size raises ``NotImplementedError`` naming
the object plane (ROADMAP A.4b.2), as does lineage reconstruction
(``recover_object``): an object that is neither sealed nor pending
raises ``ObjectLostError``.  Actors (``create_actor``,
``submit_actor_task``) wait for the actors item, A.4b.5; the task events
and tracing spans of the reference for the GCS and the debug planes
(A.4b.4, A.4b.7).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.direct_task_submitter import DirectTaskSubmitter
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import MemoryStore, entry_value
from ray_tpu_torch._private.reference_counter import ReferenceCounter
from ray_tpu_torch._private.serialization import serialize
from ray_tpu_torch._private.task_manager import TaskManager
from ray_tpu_torch._private.task_spec import TaskArg, TaskSpec


def _too_large(what: str, nbytes: int, limit: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of {nbytes} bytes is above {limit} bytes, the most the "
        "owner's memory store holds; larger objects go to a node store, "
        "which comes with the object plane (ROADMAP A.4b.2)")


def _collect(cw: "CoreWorker") -> None:
    """Scrape-time collector: the hot path only bumps plain counters."""
    wlabel = {"worker": cw.worker_id.hex()[:8]}
    for k, v in cw.metrics.items():
        record_internal(f"ray_tpu.core_worker.{k}", v, **wlabel)
    record_internal("ray_tpu.core_worker.objects_in_memory_store",
                    cw.memory_store.size(), **wlabel)


class CoreWorker:
    def __init__(self, cluster, job_id: JobID):
        self.cluster = cluster
        self.job_id = job_id
        self.worker_id = WorkerID.from_random()
        self.memory_store = MemoryStore()
        self.reference_counter = ReferenceCounter()
        self.task_manager = TaskManager(self)
        self.function_manager = FunctionManager(cluster.function_table)
        self.task_submitter = DirectTaskSubmitter(self)
        self.driver_task_id = TaskID.for_driver(job_id)
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self.metrics: Dict[str, float] = {"tasks_finished": 0,
                                          "task_exec_seconds": 0.0,
                                          "tasks_submitted": 0}
        get_metrics_registry().register_collector(self, _collect)
        # Free stored copies when objects go out of scope.
        self.reference_counter.subscribe_deleted(self._free_object)

    # ------------------------------------------------------------------
    @property
    def local_raylet(self):
        ctx = worker_context.get_context()
        if ctx.node is not None:
            return ctx.node
        return self.cluster.head_node

    def _next_put_id(self) -> ObjectID:
        ctx = worker_context.current_task_spec()
        base_task = ctx.task_id if ctx is not None else self.driver_task_id
        with self._put_lock:
            self._put_counter += 1
            # Put ids use a high index band so they never collide with
            # return ids of the same task (reference: put index counter).
            return ObjectID.from_index(base_task, 2**40 + self._put_counter)

    # ---- Put / Get / Wait (core_worker.cc:878,1081) --------------------
    def put(self, value: Any) -> ObjectRef:
        object_id = self._next_put_id()
        self.put_value(object_id, value)
        return ObjectRef(object_id, owner_id=self.worker_id)

    def put_value(self, object_id: ObjectID, value: Any):
        serialized = serialize(value)
        limit = get_config().max_direct_call_object_size
        if serialized.total_bytes > limit:
            raise _too_large("put of an object", serialized.total_bytes,
                             limit)
        contained = [r.object_id() for r in serialized.contained_refs]
        self.reference_counter.add_owned_object(object_id,
                                                contained_ids=contained)
        self.memory_store.put(object_id, serialized)

    def put_return_value(self, object_id: ObjectID, value: Any, node) -> int:
        """Store a task return in the owner's memory store (the
        reference's 'inline reply')."""
        serialized = serialize(value)
        contained = [r.object_id() for r in serialized.contained_refs]
        if contained:
            self.reference_counter.add_owned_object(
                object_id, contained_ids=contained)
        self.put_serialized_return(object_id, serialized, node)
        return serialized.total_bytes

    def put_serialized_return(self, object_id: ObjectID, serialized,
                              node):
        """Owner-side landing of an already-serialized return: it seals
        the memory store; a value above the limit raises (module
        docstring), so the task fails with it."""
        limit = get_config().max_direct_call_object_size
        if serialized.total_bytes > limit:
            raise _too_large("a task's return value", serialized.total_bytes,
                             limit)
        self.memory_store.put(object_id, serialized)

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            out.append(self._get_one(ref, remaining))
        return out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        object_id = ref.object_id()
        deadline = None if timeout is None else time.monotonic() + timeout
        nowhere_streak = 0
        while True:
            value, found = self._try_get_local(object_id)
            if found:
                return value
            if deadline is not None and time.monotonic() >= deadline:
                raise exceptions.GetTimeoutError(
                    f"Get timed out for {object_id}")
            # A pending task return: wait on the memory store briefly,
            # then re-examine.
            try:
                entry = self.memory_store.get(object_id, timeout=0.05)
                return self._entry_to_value(object_id, entry)
            except exceptions.GetTimeoutError:
                pass
            if self._is_pending(object_id):
                nowhere_streak = 0
                continue
            # Neither sealed nor pending: allow a few rechecks (a
            # producing task may seal between reads), then surface the
            # loss: reconstruction comes with the object plane.
            nowhere_streak += 1
            if nowhere_streak >= 5:
                raise self._lost_error(
                    object_id, "not in its owner's memory store and no "
                    "pending task will produce it")
            time.sleep(0.01)

    def _try_get_local(self, object_id: ObjectID) -> Tuple[Any, bool]:
        entry = self.memory_store.get_entry(object_id)
        if entry is not None and entry.sealed:
            return self._entry_to_value(object_id, entry), True
        return None, False

    def _entry_to_value(self, object_id: ObjectID, entry):
        if entry.error is not None:
            err = entry.error
            if isinstance(err, exceptions.TaskError):
                raise err.as_instanceof_cause()
            raise err
        return entry_value(entry)

    def _is_pending(self, object_id: ObjectID) -> bool:
        return self.task_manager.is_pending(object_id.task_id())

    def _lost_error(self, object_id: ObjectID,
                    reason: str) -> exceptions.ObjectLostError:
        spec = self.task_manager.lineage_spec_for_object(object_id)
        lineage = (f"lineage=pinned ({spec.function_name}), not "
                   "reconstructed: recovery comes with the object plane "
                   "(ROADMAP A.4b.2)") if spec is not None \
            else "lineage=not pinned"
        return exceptions.ObjectLostError(
            object_id, f"{reason}; owner worker "
            f"{self.worker_id.hex()[:12]}; {lineage}")

    def get_for_executor(self, object_id: ObjectID, node) -> Any:
        """Executor-side arg materialization (GetAndPinArgsForExecutor):
        from the owner's memory store, waiting for the producer to seal
        it.  A task pushed onto a reused lease did not wait at the
        raylet, so its argument may still be pending here.  Gives up
        after the reference's 30 s."""
        deadline = time.monotonic() + 30.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._lost_error(object_id, "arg fetch timed out")
            try:
                entry = self.memory_store.get(object_id,
                                              timeout=min(remaining, 0.5))
                return self._entry_to_value(object_id, entry)
            except exceptions.GetTimeoutError:
                pass
            if not self._is_pending(object_id) and \
                    not self.memory_store.contains(object_id):
                raise self._lost_error(object_id, "arg fetch failed and "
                                       "not recoverable")

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List, List]:
        """Event-driven wait: the readiness signal is the owner memory
        store sealing; each unready ref registers one wakeup hook, and
        the loop sleeps on an Event instead of polling (reference:
        memory-store GetAsync under ``Wait``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        refs = list(refs)
        wake = threading.Event()
        hooked: Dict[ObjectID, Any] = {}

        def hook(object_id: ObjectID):
            if object_id in hooked:
                return
            mem_cb = lambda _e: wake.set()      # noqa: E731
            hooked[object_id] = mem_cb
            self.memory_store.get_async(object_id, mem_cb)

        try:
            while True:
                ready, not_ready = [], []
                for ref in refs:
                    if self._is_ready(ref.object_id()):
                        ready.append(ref)
                    else:
                        not_ready.append(ref)
                if len(ready) >= num_returns or \
                        (deadline is not None and
                         time.monotonic() >= deadline):
                    return ready, not_ready
                for ref in not_ready:
                    hook(ref.object_id())
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                wake.wait(timeout=0.2 if remaining is None
                          else min(remaining, 0.2))
                wake.clear()
        finally:
            # Deregister every hook this call planted: repeated waits on
            # a slow task must not accrete dead closures.
            for object_id, mem_cb in hooked.items():
                self.memory_store.cancel_get_async(object_id, mem_cb)

    def _is_ready(self, object_id: ObjectID) -> bool:
        return self.memory_store.contains(object_id)

    def get_async(self, ref: ObjectRef, callback):
        def run():
            try:
                callback(self._get_one(ref, None), None)
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
        threading.Thread(target=run, daemon=True,
                         name="ray_tpu_torch::get_async").start()

    # ---- task submission (core_worker.cc:1650) -------------------------
    def build_args(self, flat_args):
        """Returns (task_args, dep_ids, borrowed_ids).

        ``borrowed_ids`` are refs nested inside small inlined args — the
        task borrows them for its lifetime (reference: borrower
        protocol, reference_count.h).  They go on the spec so the
        TaskManager pins them while the task is pending.  The
        reference's promotion of a large literal argument to an owned
        object, and the holders that keep it alive until submission,
        raise here instead (module docstring).
        """
        limit = get_config().task_args_inline_bytes_limit
        out: List[TaskArg] = []
        dep_ids: List[ObjectID] = []
        borrowed: List[ObjectID] = []
        for a in flat_args:
            if isinstance(a, ObjectRef):
                out.append(TaskArg(is_inline=False, object_id=a.object_id(),
                                   owner_id=a.owner_id()))
                dep_ids.append(a.object_id())
            else:
                s = serialize(a)
                if s.total_bytes > limit:
                    raise _too_large("a task argument", s.total_bytes, limit)
                borrowed.extend(r.object_id() for r in s.contained_refs)
                out.append(TaskArg(is_inline=True, value=s))
        return out, dep_ids, borrowed

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        if spec.runtime_env:
            raise NotImplementedError(
                "runtime_env is not supported yet: thread workers run in "
                "the driver's environment, and process workers, which "
                "carry one, are not ported")
        self.task_manager.add_pending_task(spec)
        self.metrics["tasks_submitted"] += 1
        self.task_submitter.submit(spec)
        return [ObjectRef(oid, owner_id=self.worker_id)
                for oid in spec.return_ids]

    # ---- free path ------------------------------------------------------
    def _free_object(self, object_id: ObjectID):
        self.memory_store.delete(object_id)
        self.task_manager.evict_lineage(object_id.task_id())

    def free_objects(self, refs: Sequence[ObjectRef]):
        for ref in refs:
            self._free_object(ref.object_id())

    # ---- metrics hook ---------------------------------------------------
    def record_task_metric(self, spec: TaskSpec, elapsed: float):
        self.metrics["tasks_finished"] += 1
        self.metrics["task_exec_seconds"] += elapsed
