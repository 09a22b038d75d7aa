"""Owner-side task state: pending set, retries, lineage.

A copy of ``ray_tpu._private.task_manager`` for the PyTorch port, with
plain ``threading`` locks.  The reference emits a task event at each
transition (``ray_tpu.gcs.task_events``); those belong to the GCS
(ROADMAP A.4b.4) and are left out.  A task's spec stays in the lineage
table until ``evict_lineage`` (its returns went out of scope) or the
lineage budget drops it, and ``get_spec``/``lineage_spec_for_object``
give it to the core worker's ``recover_object``.

Parity: reference ``src/ray/core_worker/task_manager.{h,cc}`` — tracks every
submitted task until its returns are sealed; retries failed tasks up to
``max_retries``; pins task specs for lineage reconstruction
(``lineage_pinning_enabled``); resubmits the creating task when a lost
object must be reconstructed (``object_recovery_manager.cc``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.task_spec import TaskSpec


class _PendingTask:
    __slots__ = ("spec", "retries_left", "status")

    def __init__(self, spec: TaskSpec, retries_left: int):
        self.spec = spec
        self.retries_left = retries_left
        self.status = "PENDING"


class TaskManager:
    def __init__(self, core_worker):
        self._core = core_worker
        self._lock = threading.RLock()
        self._pending: Dict[TaskID, _PendingTask] = {}
        # Lineage: task specs pinned while their return objects may need
        # reconstruction (reference: TaskManager lineage map), bounded
        # by ``max_lineage_bytes`` of inlined-arg payload: beyond the
        # budget the OLDEST pins are dropped (insertion order), so the
        # newest — most likely still needed — lineage survives.  An
        # evicted spec makes its objects non-reconstructable, exactly
        # the doctor's "lineage=evicted" hint.
        self._lineage: Dict[TaskID, TaskSpec] = {}
        self._lineage_sizes: Dict[TaskID, int] = {}
        self._lineage_bytes = 0
        self._completion_cv = threading.Condition(self._lock)

    @staticmethod
    def _spec_lineage_bytes(spec: TaskSpec) -> int:
        """Approximate pinned footprint: inlined serialized args + a
        flat per-spec overhead for the metadata fields."""
        total = 512
        for arg in spec.args:
            v = getattr(arg, "value", None)
            if arg.is_inline and v is not None:
                total += len(getattr(v, "inband", b"") or b"")
                for buf in getattr(v, "buffers", ()) or ():
                    total += getattr(buf, "nbytes", 0)
        return total

    # ---- submission lifecycle ------------------------------------------
    def add_pending_task(self, spec: TaskSpec) -> None:
        cfg = get_config()
        with self._lock:
            self._pending[spec.task_id] = _PendingTask(spec, spec.max_retries)
            if cfg.lineage_pinning_enabled:
                sz = self._spec_lineage_bytes(spec)
                self._lineage[spec.task_id] = spec
                self._lineage_sizes[spec.task_id] = sz
                self._lineage_bytes += sz
                budget = cfg.max_lineage_bytes
                while self._lineage_bytes > budget and len(self._lineage) > 1:
                    oldest = next(iter(self._lineage))
                    if oldest == spec.task_id:
                        break
                    self._lineage.pop(oldest)
                    self._lineage_bytes -= self._lineage_sizes.pop(oldest, 0)
        # Register owned return objects with lineage pointers.
        rc = self._core.reference_counter
        for oid in spec.return_ids:
            rc.add_owned_object(oid, lineage_task_id=spec.task_id)
        rc.add_submitted_task_refs(
            spec.arg_object_ids() + list(spec.borrowed_ids))

    def is_pending(self, task_id: TaskID) -> bool:
        with self._lock:
            return task_id in self._pending

    def get_spec(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            t = self._pending.get(task_id)
            if t is not None:
                return t.spec
            return self._lineage.get(task_id)

    # ---- completion/failure (called from transport) ---------------------
    def complete_task(self, spec: TaskSpec):
        with self._lock:
            t = self._pending.pop(spec.task_id, None)
            self._completion_cv.notify_all()
        if t is None:
            # Stale/duplicate completion: a retried task's original
            # attempt landing after the retry already transitioned it,
            # or two failure paths racing on node death.  The first
            # terminal transition already removed the submitted-task
            # refs — removing them again would drive the args' counts
            # negative and prematurely free objects the driver still
            # holds (observed as lost-object + evicted-lineage in the
            # sigkill chaos test).
            return
        self._core.reference_counter.remove_submitted_task_refs(
            spec.arg_object_ids() + list(spec.borrowed_ids))

    def fail_or_retry(self, spec: TaskSpec, error: BaseException,
                      resubmit: Callable[[TaskSpec], None]) -> bool:
        """Returns True if the task will be retried."""
        retryable = isinstance(error, (exceptions.WorkerCrashedError,
                                       exceptions.NodeDiedError)) or \
            (spec.retry_exceptions and isinstance(error, exceptions.TaskError))
        with self._lock:
            t = self._pending.get(spec.task_id)
            if t is None:
                return False
            if retryable and t.retries_left > 0:
                t.retries_left -= 1
                do_retry = True
            elif not retryable and not isinstance(error, exceptions.TaskError) \
                    and t.retries_left > 0:
                # System failures (lease/dispatch) always consume a retry.
                t.retries_left -= 1
                do_retry = True
            else:
                do_retry = False
        if do_retry:
            resubmit(spec)
            return True
        self.fail_task(spec, error)
        return False

    def fail_task(self, spec: TaskSpec, error: BaseException):
        """Store the error into all return objects so gets raise."""
        with self._lock:
            t = self._pending.pop(spec.task_id, None)
            self._completion_cv.notify_all()
        if t is None:
            # Duplicate terminal transition (see complete_task): the
            # task already completed or failed — don't double-remove
            # arg refs, and don't overwrite sealed returns with errors.
            return
        for oid in spec.return_ids:
            self._core.memory_store.put_error(oid, _user_error(error))
        self._core.reference_counter.remove_submitted_task_refs(
            spec.arg_object_ids() + list(spec.borrowed_ids))

    # ---- lineage / reconstruction ---------------------------------------
    def lineage_spec_for_object(self, object_id: ObjectID) -> Optional[TaskSpec]:
        with self._lock:
            return self._lineage.get(object_id.task_id())

    def evict_lineage(self, task_id: TaskID):
        with self._lock:
            if self._lineage.pop(task_id, None) is not None:
                self._lineage_bytes -= self._lineage_sizes.pop(task_id, 0)


def _user_error(error: BaseException) -> BaseException:
    if isinstance(error, exceptions.TaskError):
        return error
    if isinstance(error, exceptions.RayTpuError):
        return error
    return exceptions.RayTpuError(str(error))
