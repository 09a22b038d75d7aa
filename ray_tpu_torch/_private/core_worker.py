"""CoreWorker — the in-process runtime of the driver (and, logically, of
every executor thread).

A port of ``ray_tpu._private.core_worker`` for the PyTorch port, normal
tasks only (reference ``src/ray/core_worker/core_worker.cc``): ``Put``
(:878), ``Get`` (:1081, merging the memory store, the node store and the
pull from other nodes), ``Wait``, ``SubmitTask`` (:1650), the argument
builder, the executor's argument fetch and the return path, over the
owner's memory store, the node stores, the reference counter, the task
manager and the direct task submitter; and the ``ObjectRecoveryManager``
(object_recovery_manager.cc): a lost object is reconstructed by
resubmitting its creating task from pinned lineage.

An object above ``max_direct_call_object_size`` (100 KiB) goes to the
local raylet's node store and the object directory, with an
``InPlasmaMarker`` in the owner's memory store for a task's return; a
literal argument above ``task_args_inline_bytes_limit`` is promoted to
such an object.  Actors: ``create_actor`` (core_worker.cc:1709)
registers the actor with the GCS's actor manager and pins the creation
arguments until the actor is DEAD (a restart runs the creation task
again), and ``submit_actor_task`` (:1940) hands a method to the
``actor_submitter``; an actor task's returns and an actor's creation are
never reconstructed from lineage (actor state is not reconstructable).
A tensor put or returned whole is a device object (the reference's
``jax.Array`` branch, ``_is_device_array``): the store of the local (or
executing) node keeps a private copy of it on its own device (ROADMAP
C.19), whatever its size, and the directory records the location; the
owner's memory store holds nothing for it.
Owner-death invalidation (``fail_owned_object``) seals ``OwnerDiedError``
over the objects a crashed process worker put; the tracing spans and
flight recorder of the reference belong to the debug planes (A.4b.7).  The task
events of the submit (PENDING_ARGS_AVAIL, with the parent and the
argument ids) and of a reconstruction (RECONSTRUCTING) go to the GCS's
buffer (``gcs.task_events``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.direct_actor_submitter import \
    DirectActorTaskSubmitter
from ray_tpu_torch._private.direct_task_submitter import DirectTaskSubmitter
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import (DeviceObject,
                                                 InPlasmaMarker,
                                                 MemoryStore,
                                                 ObjectVanishedError,
                                                 entry_value)
from ray_tpu_torch._private.reference_counter import ReferenceCounter
from ray_tpu_torch._private.serialization import copy_stats, serialize
from ray_tpu_torch._private.task_manager import TaskManager
from ray_tpu_torch._private.task_spec import TaskArg, TaskSpec
from ray_tpu_torch.gcs import pubsub as pubsub_mod
from ray_tpu_torch.gcs import task_events



def _collect(cw: "CoreWorker") -> None:
    """Scrape-time collector: the hot path only bumps plain counters."""
    wlabel = {"worker": cw.worker_id.hex()[:8]}
    for k, v in cw.metrics.items():
        record_internal(f"ray_tpu.core_worker.{k}", v, **wlabel)
    record_internal("ray_tpu.core_worker.objects_in_memory_store",
                    cw.memory_store.size(), **wlabel)
    # A top-level name: recovery dashboards key on it.
    record_internal("ray_tpu.lineage_reconstructions",
                    cw.metrics["lineage_reconstructions"], **wlabel)


class CoreWorker:
    def __init__(self, cluster, job_id: JobID):
        self.cluster = cluster
        self.job_id = job_id
        self.worker_id = WorkerID.from_random()
        self.memory_store = MemoryStore()
        self.reference_counter = ReferenceCounter()
        self.task_manager = TaskManager(self)
        self.function_manager = FunctionManager(cluster)
        self.task_submitter = DirectTaskSubmitter(self)
        self.actor_submitter = DirectActorTaskSubmitter(self)
        self.driver_task_id = TaskID.for_driver(job_id)
        self._put_counter = 0
        self._put_lock = threading.Lock()
        self.metrics: Dict[str, float] = {"tasks_finished": 0,
                                          "task_exec_seconds": 0.0,
                                          "tasks_submitted": 0,
                                          "actor_tasks_submitted": 0,
                                          "lineage_reconstructions": 0}
        # Per-creating-task reconstruction state (attempts and the
        # exponential-backoff gate).
        self._recon_lock = threading.Lock()
        self._reconstructions: Dict[TaskID, _ReconState] = {}
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
        if _is_device_tensor(value):
            data = _device_object(value)
            self.reference_counter.add_owned_object(object_id)
            raylet = self.local_raylet
            raylet.object_store.put(object_id, data)
            self.cluster.object_directory.add_location(
                object_id, raylet.node_id, size=data.nbytes)
            return
        serialized = serialize(value)
        contained = [r.object_id() for r in serialized.contained_refs]
        self.reference_counter.add_owned_object(object_id,
                                                contained_ids=contained)
        if serialized.total_bytes <= \
                get_config().max_direct_call_object_size:
            self.memory_store.put(object_id, serialized)
        else:
            raylet = self.local_raylet
            raylet.object_store.put(object_id, serialized)
            self.cluster.object_directory.add_location(
                object_id, raylet.node_id, size=serialized.total_bytes)

    def put_return_value(self, object_id: ObjectID, value: Any, node) -> int:
        """Store a task return (small: the owner's memory store, the
        'inline reply'; big: the executing node's store and the
        directory; a tensor: the executing node's store and the
        directory, as a device object, with no memory-store entry)."""
        if _is_device_tensor(value):
            data = _device_object(value)
            node.object_store.put(object_id, data)
            self.cluster.object_directory.add_location(
                object_id, node.node_id, size=data.nbytes)
            return data.nbytes
        serialized = serialize(value)
        contained = [r.object_id() for r in serialized.contained_refs]
        if contained:
            self.reference_counter.add_owned_object(
                object_id, contained_ids=contained)
        self.put_serialized_return(object_id, serialized, node)
        return serialized.total_bytes

    def put_serialized_return(self, object_id: ObjectID, serialized,
                              node):
        """Owner-side landing of an already-serialized return: a small
        value seals the memory store; a big one goes to the executing
        node's store and the directory, with an InPlasmaMarker so that
        owner-side gets unblock at once."""
        if serialized.total_bytes <= \
                get_config().max_direct_call_object_size:
            self.memory_store.put(object_id, serialized)
        else:
            node.object_store.put(object_id, serialized)
            self.cluster.object_directory.add_location(
                object_id, node.node_id, size=serialized.total_bytes)
            self.memory_store.put(object_id, InPlasmaMarker(node.node_id))

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
            # The deadline gate sits at the top: every retry arm below
            # comes back here.
            if deadline is not None and time.monotonic() >= deadline:
                raise exceptions.GetTimeoutError(
                    f"Get timed out for {object_id}")
            # Not local: is it in some node's store?
            locations = self.cluster.object_directory.get_locations(
                object_id)
            if locations:
                done = threading.Event()
                result = {}

                def cb(ok):
                    result["ok"] = ok
                    done.set()

                self.local_raylet.object_manager.pull_async(object_id, cb)
                done.wait(timeout=5.0)
                if result.get("ok"):
                    continue
            else:
                # Maybe a pending task return: wait on the memory store
                # briefly, then re-examine.
                try:
                    entry = self.memory_store.get(object_id, timeout=0.05)
                    return self._entry_to_value(object_id, entry)
                except exceptions.GetTimeoutError:
                    pass
                except _Retry:
                    continue
            # Nowhere and not pending: lineage reconstruction.  The
            # directory is read again after the pending check: a device
            # return seals nothing in the memory store, and its location
            # lands just before its task stops pending, so the read
            # above may predate it (ROADMAP C.21).
            if not self._is_pending(object_id) and \
                    not self.cluster.object_directory.get_locations(
                        object_id):
                if self.recover_object(object_id):
                    # Resubmitted now, or a backoff window is open:
                    # polled every pass, so a copy lost again gets its
                    # next attempt when the window opens.
                    nowhere_streak = 0
                    continue
                # Unrecoverable: a few rechecks (a producing task may
                # seal between reads), then surface the loss.
                nowhere_streak += 1
                if nowhere_streak >= 5:
                    raise self._lost_error(
                        object_id,
                        "all copies lost and lineage reconstruction "
                        "unavailable")
                time.sleep(0.01)
            else:
                nowhere_streak = 0

    def _try_get_local(self, object_id: ObjectID) -> Tuple[Any, bool]:
        entry = self.memory_store.get_entry(object_id)
        if entry is not None and entry.sealed:
            try:
                return self._entry_to_value(object_id, entry), True
            except _Retry:
                return None, False
        raylet = self.local_raylet
        if raylet is not None:
            try:
                e = raylet.object_store.get(object_id)
                if e is not None:
                    return entry_value(e), True
            except ObjectVanishedError:
                # Heal the entry (else ``contains`` keeps short-
                # circuiting pulls "local") and re-resolve.
                self._heal_vanished(object_id)
        return None, False

    def _heal_vanished(self, object_id: ObjectID, raylet=None) -> None:
        """Drop a local entry whose bytes vanished, and its stale
        directory row for this node, so pulls re-fetch a real copy."""
        raylet = raylet or self.local_raylet
        if raylet is not None and \
                raylet.object_store.drop_vanished(object_id):
            self.cluster.object_directory.remove_location(
                object_id, raylet.node_id)

    def _entry_to_value(self, object_id: ObjectID, entry):
        if entry.error is not None:
            err = entry.error
            if isinstance(err, exceptions.TaskError):
                raise err.as_instanceof_cause()
            raise err
        if isinstance(entry.data, InPlasmaMarker):
            # The bytes are in a node store.
            raylet = self.local_raylet
            try:
                e = raylet.object_store.get(object_id)
                if e is not None:
                    return entry_value(e)
            except ObjectVanishedError:
                self._heal_vanished(object_id)
            raise _Retry()
        return entry_value(entry)

    def _is_pending(self, object_id: ObjectID) -> bool:
        return self.task_manager.is_pending(object_id.task_id())

    def get_for_executor(self, object_id: ObjectID, node) -> Any:
        """Executor-side argument fetch (GetAndPinArgsForExecutor):
        store check, pull, store check.  A pull can complete through the
        owner's memory store (small returns never enter a node store),
        and the producer may seal between any two checks, so both
        stores are read again after every pull.  Gives up after the
        reference's 30 s."""
        deadline = time.monotonic() + 30.0
        misses = 0
        while True:
            try:
                entry = node.object_store.get(object_id)
                if entry is not None:
                    return entry_value(entry)
            except ObjectVanishedError:
                self._heal_vanished(object_id, raylet=node)
            entry = self.memory_store.get_entry(object_id)
            if entry is not None and entry.sealed and \
                    not isinstance(entry.data, InPlasmaMarker):
                return self._entry_to_value(object_id, entry)
            if misses:
                # A "successful" pull that left no bytes here (a marker
                # whose node died): back off, and after repeated misses
                # try reconstruction.
                if misses >= 5:
                    self.recover_object(object_id)
                time.sleep(min(0.005 * misses, 0.1))
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._lost_error(object_id, "arg fetch failed")
            done = threading.Event()
            ok_box = [False]

            def _cb(ok, done=done, ok_box=ok_box):
                ok_box[0] = ok
                done.set()
            node.object_manager.pull_async(object_id, _cb)
            if not done.wait(timeout=remaining):
                raise self._lost_error(object_id, "arg fetch timed out")
            if not ok_box[0]:
                # Failed pull (the source died): reconstruct, then check
                # and pull again.
                if not self.recover_object(object_id):
                    raise self._lost_error(
                        object_id, "arg fetch failed and not recoverable")
                time.sleep(0.01)
            else:
                misses += 1

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List, List]:
        """Event-driven wait: the readiness signals are the owner's
        memory store sealing (small returns, errors, markers) and the
        directory gaining a location (big objects on any node); each
        unready ref hooks one wakeup per signal and the loop sleeps on
        an Event (reference: memory-store GetAsync and the directory
        subscription under ``Wait``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        refs = list(refs)
        wake = threading.Event()
        hooked: Dict[ObjectID, Tuple] = {}
        directory = self.cluster.object_directory

        def hook(object_id: ObjectID):
            if object_id in hooked:
                return
            mem_cb = lambda _e: wake.set()      # noqa: E731
            dir_cb = lambda _n: wake.set()      # noqa: E731
            hooked[object_id] = (mem_cb, dir_cb)
            self.memory_store.get_async(object_id, mem_cb)
            directory.subscribe_location(object_id, dir_cb)

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
            for object_id, (mem_cb, dir_cb) in hooked.items():
                self.memory_store.cancel_get_async(object_id, mem_cb)
                directory.unsubscribe_location(object_id, dir_cb)

    def _is_ready(self, object_id: ObjectID) -> bool:
        entry = self.memory_store.get_entry(object_id)
        if entry is not None and entry.sealed:
            return True
        if self.cluster.object_directory.get_locations(object_id):
            return True
        raylet = self.local_raylet
        return raylet is not None and raylet.object_store.contains(object_id)

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
        """Returns (task_args, dep_ids, holders, borrowed_ids).

        ``holders`` are refs to literal arguments above
        ``task_args_inline_bytes_limit``, promoted to owned objects
        (_raylet.pyx:1487): the caller keeps them alive until
        ``submit_task`` registered the submitted-task refs, or the
        promoted object could be freed in between.  ``borrowed_ids`` are
        refs nested inside small inlined args: the task borrows them for
        its lifetime (reference: borrower protocol, reference_count.h),
        so they go on the spec and the TaskManager pins them while the
        task is pending.
        """
        limit = get_config().task_args_inline_bytes_limit
        out: List[TaskArg] = []
        dep_ids: List[ObjectID] = []
        holders: List[ObjectRef] = []
        borrowed: List[ObjectID] = []
        for a in flat_args:
            if isinstance(a, ObjectRef):
                out.append(TaskArg(is_inline=False, object_id=a.object_id(),
                                   owner_id=a.owner_id()))
                dep_ids.append(a.object_id())
            else:
                # A tensor above the limit is promoted without making
                # its host form first (a device-to-host copy of all of
                # it, only to be measured).
                s = None if _is_device_tensor(a) and \
                    a.numel() * a.element_size() > limit else serialize(a)
                if s is None or s.total_bytes > limit:
                    ref = self.put(a)
                    holders.append(ref)
                    out.append(TaskArg(is_inline=False,
                                       object_id=ref.object_id(),
                                       owner_id=self.worker_id))
                    dep_ids.append(ref.object_id())
                else:
                    borrowed.extend(r.object_id() for r in s.contained_refs)
                    out.append(TaskArg(is_inline=True, value=s))
        return out, dep_ids, holders, borrowed

    @staticmethod
    def _provenance(spec: TaskSpec) -> Dict[str, Any]:
        """The submit event's provenance: the submitting task and the
        argument objects (their ids embed their producers' ids)."""
        out: Dict[str, Any] = {}
        if spec.parent_task_id is not None:
            out["parent_task_id"] = spec.parent_task_id.hex()
        args = spec.arg_object_ids()
        if args:
            out["arg_object_ids"] = [oid.hex() for oid in args]
        return out

    def submit_task(self, spec: TaskSpec, holders=()) -> List[ObjectRef]:
        self.task_manager.add_pending_task(spec)
        del holders  # the submitted-task refs now pin the promoted args
        self.metrics["tasks_submitted"] += 1
        task_events.emit(self.cluster, spec.task_id,
                         task_events.PENDING_ARGS_AVAIL,
                         name=spec.function_name,
                         job_id=spec.job_id.hex(),
                         task_type=spec.task_type,
                         **self._provenance(spec))
        self.task_submitter.submit(spec)
        return [ObjectRef(oid, owner_id=self.worker_id)
                for oid in spec.return_ids]

    def submit_actor_task(self, spec: TaskSpec,
                          holders=()) -> List[ObjectRef]:
        self.task_manager.add_pending_task(spec)
        del holders
        self.metrics["actor_tasks_submitted"] += 1
        task_events.emit(self.cluster, spec.task_id,
                         task_events.PENDING_ARGS_AVAIL,
                         name=spec.function_name,
                         job_id=spec.job_id.hex(),
                         task_type=spec.task_type,
                         **self._provenance(spec))
        self.actor_submitter.submit(spec)
        return [ObjectRef(oid, owner_id=self.worker_id)
                for oid in spec.return_ids]

    def create_actor(self, creation_spec: TaskSpec, name: str = "",
                     namespace: str = "", detached: bool = False):
        from ray_tpu_torch.gcs.actor_manager import GcsActor

        # The creation arguments (object arguments and the refs inside
        # inlined ones) must outlive the actor, not the creation task:
        # every restart runs the pinned creation spec again.  Released
        # when the actor is DEAD.
        pinned = creation_spec.arg_object_ids() + \
            list(creation_spec.borrowed_ids)
        if pinned:
            self.reference_counter.add_submitted_task_refs(pinned)
            released = threading.Event()

            def on_update(_key, info, ids=tuple(pinned)):
                if info.get("state") == "DEAD" and not released.is_set():
                    released.set()
                    self.reference_counter.remove_submitted_task_refs(
                        list(ids))

            self.cluster.gcs.publisher.subscribe(
                pubsub_mod.ACTOR_CHANNEL, creation_spec.actor_id.binary(),
                on_update)
        actor = GcsActor(creation_spec.actor_id, creation_spec, name=name,
                         namespace=namespace,
                         max_restarts=creation_spec.max_restarts,
                         detached=detached)
        self.cluster.gcs.actor_manager.register_actor(actor)
        return actor

    # ---- recovery (object_recovery_manager.cc) -------------------------
    def recover_object(self, object_id: ObjectID, _depth: int = 0) -> bool:
        """Resubmit the creating task from pinned lineage.

        Lost arguments of the creating task are recovered first,
        recursively, bounded by ``max_lineage_reconstruction_depth``.
        Repeated reconstructions of one task are gated by exponential
        backoff: inside the window the call reports in progress without
        resubmitting, so polling loops cannot stampede the scheduler.
        Returns True when the object is being recomputed (now or
        already), False when it cannot be."""
        cfg = get_config()
        if not cfg.lineage_pinning_enabled:
            return False
        if _depth > cfg.max_lineage_reconstruction_depth:
            return False
        spec = self.task_manager.lineage_spec_for_object(object_id)
        if spec is None:
            return False
        if self.task_manager.is_pending(spec.task_id):
            return True  # already being recomputed
        if spec.is_actor_task() or spec.is_actor_creation():
            return False  # actor state is not reconstructable
        now = time.monotonic()
        with self._recon_lock:
            st = self._reconstructions.get(spec.task_id)
            if st is None:
                st = self._reconstructions[spec.task_id] = _ReconState()
            if now < st.next_allowed:
                return True   # backoff window: resubmission pending
            st.attempts += 1
            st.next_allowed = now + cfg.lineage_reconstruction_backoff_s \
                * (2 ** (st.attempts - 1))
            attempt = st.attempts
        # The recomputed task cannot run without its own inputs.
        for arg_id in spec.arg_object_ids():
            if not self._object_available(arg_id):
                self.recover_object(arg_id, _depth=_depth + 1)
        self.metrics["lineage_reconstructions"] += 1
        # The attempt rides above the retry band (retries never pass
        # max_retries), so the task's FINISHED record rewinds.
        task_events.emit(self.cluster, spec.task_id,
                         task_events.RECONSTRUCTING,
                         name=spec.function_name,
                         attempt=spec.max_retries + attempt)
        self.task_manager.add_pending_task(spec)
        self.task_submitter.submit(spec)
        return True

    def _lost_error(self, object_id: ObjectID,
                    reason: str) -> exceptions.ObjectLostError:
        """An ObjectLostError with its context: the owner, where the
        copies last were, whether lineage could (or did) try to
        recompute it, and any spill record."""
        parts = [reason]
        ref = self.reference_counter.describe(object_id)
        if ref is not None:
            parts.append("owner worker=" +
                         ("this driver" if ref["owned"] else "borrowed") +
                         f" ({self.worker_id.hex()[:12]})")
            if ref.get("spilled_url"):
                parts.append(f"spilled_url={ref['spilled_url']}")
        locations = self.cluster.object_directory.get_locations(object_id)
        parts.append("known locations=" +
                     (",".join(n.hex()[:12] for n in locations)
                      if locations else "none"))
        spec = self.task_manager.lineage_spec_for_object(object_id)
        if spec is None:
            parts.append("lineage=not pinned (cannot reconstruct; "
                         "check lineage_pinning_enabled / "
                         "max_lineage_bytes)")
        elif spec.is_actor_task() or spec.is_actor_creation():
            parts.append(f"lineage={spec.function_name} is an actor "
                         "task (actor state is not reconstructable)")
        else:
            with self._recon_lock:
                st = self._reconstructions.get(spec.task_id)
                attempts = st.attempts if st is not None else 0
            parts.append(f"lineage=pinned ({spec.function_name}), "
                         f"{attempts} reconstruction attempt(s)")
        return exceptions.ObjectLostError(object_id, "; ".join(parts))

    def _object_available(self, object_id: ObjectID) -> bool:
        """Needs no recovery: a sealed value (not a marker pointing at a
        store that may have died), a live location, or a pending
        producing task."""
        entry = self.memory_store.get_entry(object_id)
        if entry is not None and entry.sealed and \
                not isinstance(entry.data, InPlasmaMarker):
            return True
        if self.cluster.object_directory.get_locations(object_id):
            return True
        return self.task_manager.is_pending(object_id.task_id())

    def on_node_death(self, node_id, lost_objects: List[ObjectID]):
        """Reconstruct at once the referenced objects a dead node held
        the last copy of."""
        for oid in lost_objects:
            if self.reference_counter.has_reference(oid):
                self.memory_store.delete(oid)
                self.recover_object(oid)

    def fail_owned_object(self, object_id: ObjectID,
                          error: BaseException):
        """Owner-death invalidation: seal ``error`` over the object, so
        that every borrower's get and wait raises instead of hanging, and
        drop the copies that no owner stands behind (reference:
        reference_count.cc OWNER_DIED propagation)."""
        self.memory_store.fail(object_id, error)
        directory = self.cluster.object_directory
        for node_id in directory.get_locations(object_id):
            raylet = self.cluster.raylet(node_id)
            if raylet is not None:
                raylet.object_store.delete(object_id)
        directory.remove_object(object_id)

    # ---- free path ------------------------------------------------------
    def _free_object(self, object_id: ObjectID):
        self.memory_store.delete(object_id)
        directory = self.cluster.object_directory
        for node_id in directory.get_locations(object_id):
            raylet = self.cluster.raylet(node_id)
            if raylet is not None:
                raylet.object_store.delete(object_id)
        directory.remove_object(object_id)
        self.task_manager.evict_lineage(object_id.task_id())
        with self._recon_lock:
            self._reconstructions.pop(object_id.task_id(), None)

    def free_objects(self, refs: Sequence[ObjectRef]):
        for ref in refs:
            self._free_object(ref.object_id())

    # ---- metrics hook ---------------------------------------------------
    def record_task_metric(self, spec: TaskSpec, elapsed: float):
        self.metrics["tasks_finished"] += 1
        self.metrics["task_exec_seconds"] += elapsed


def _is_device_tensor(value) -> bool:
    """True for a tensor the device-object plane keeps (reference
    ``_is_device_array``, a live ``jax.Array``): a plain strided tensor
    on the card or the CPU, not a subclass, sparse or quantized one,
    which take the serialized path."""
    import torch
    return type(value) is torch.Tensor and \
        value.layout == torch.strided and not value.is_quantized and \
        value.device.type in ("cuda", "cpu")


def _device_object(value) -> DeviceObject:
    """A device object over a private copy of ``value`` on its own
    device (ROADMAP C.19: a tensor, unlike a ``jax.Array``, can be
    written after the put), counted in
    ``copy_stats["device_bytes_copied"]``."""
    import torch
    with torch.no_grad():
        copy = value.detach().clone(memory_format=torch.preserve_format)
    if value.requires_grad:
        copy.requires_grad_()
    data = DeviceObject(copy)
    copy_stats["device_bytes_copied"] += data.nbytes
    return data


class _ReconState:
    """Reconstruction bookkeeping for one creating task."""

    __slots__ = ("attempts", "next_allowed")

    def __init__(self):
        self.attempts = 0
        self.next_allowed = 0.0


class _Retry(Exception):
    """A marker's bytes are not local: re-resolve through a pull."""
