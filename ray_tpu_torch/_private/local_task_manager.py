"""Per-node dispatch: args -> resources -> worker binding.

A port of ``ray_tpu._private.local_task_manager`` for the PyTorch port:
the dispatch queue, the resources each leased worker holds,
``release_worker_resources`` and the actor-creation hand-back of
placement-only resources.  Resources were reserved by the
``ClusterTaskManager`` when it chose this node, so dispatch only needs a
worker.

``DependencyManager`` is the reference's (``dependency_manager.h``):
a task whose argument objects are not all local (in this node's store,
or inline in the owner's memory store) waits while the node's object
manager pulls them; a failed pull asks the owner to reconstruct the
object and pulls again, up to ``_MAX_PULL_RETRIES`` times, after which
the task dispatches anyway and its executor's fetch raises the
``ObjectLostError``.  The pull callbacks arrive on pull threads (or the
thread that seals an object), so they post to this raylet's loop, where
the waiting state is kept (the reference takes a lock instead).  A
granted lease pins its task's arguments in the node store until the
worker is returned (GetAndPinArgsForExecutor), so a spill cannot take
them from under the executor's read.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch._private.thread_registry import loop_only
from ray_tpu_torch.scheduler.resources import ResourceRequest


class _Waiting:
    __slots__ = ("spec", "reply", "missing", "retries")

    def __init__(self, spec, reply, missing):
        self.spec = spec
        self.reply = reply
        self.missing = missing
        self.retries = {}  # oid -> failed-pull retry count


class DependencyManager:
    """Holds a task until its argument objects are local to the node."""

    _MAX_PULL_RETRIES = 3

    def __init__(self, raylet):
        self._raylet = raylet
        self._waiting: Dict = {}  # token -> _Waiting, on the loop only

    def wait_for_args(self, spec: TaskSpec, ready_cb: Callable[[], None]):
        oids = spec.arg_object_ids()
        if not oids:
            ready_cb()
            return
        om = self._raylet.object_manager
        missing = [oid for oid in oids if not om.is_local_or_inline(oid)]
        if not missing:
            ready_cb()
            return
        # Keyed by a unique token, NOT task_id: duplicate lease requests
        # may carry the same representative spec.
        token = object()
        self._waiting[token] = _Waiting(spec, ready_cb, set(missing))
        for oid in missing:
            self._pull(token, oid)

    def _pull(self, token, oid):
        """Pull ``oid``; its callback runs on a pull thread (or the
        sealing thread) and posts the outcome to this raylet's loop."""
        loop = self._raylet.loop
        self._raylet.object_manager.pull_async(
            oid, lambda ok: loop.post(lambda: self._on_arg(token, oid, ok),
                                      "dep.arg_ready"))

    @loop_only("raylet")
    def _on_arg(self, token, oid, ok):
        state = self._waiting.get(token)
        if state is None:
            return
        retry = False
        if not ok:
            state.retries[oid] = state.retries.get(oid, 0) + 1
            retry = state.retries[oid] <= self._MAX_PULL_RETRIES
        if retry:
            # A failed pull (the source died, the object was freed): ask
            # the owner to reconstruct from lineage, then pull again
            # after a short delay.
            core = self._raylet.core_worker
            if core is not None:
                core.recover_object(oid)
            self._raylet.loop.schedule_after(
                0.02 * state.retries[oid],
                lambda: self._pull(token, oid), "dep.repull")
            return
        # The argument is ready, or its retries are spent: then the task
        # dispatches anyway and the executor's fetch raises the loss.
        state.missing.discard(oid)
        if not state.missing:
            del self._waiting[token]
            state.reply()

    def num_waiting(self) -> int:
        return len(self._waiting)


class LocalTaskManager:
    def __init__(self, raylet):
        self._raylet = raylet
        self._lock = threading.RLock()
        self._dispatch_queue: deque = deque()
        # Resources held by leased workers: worker_id -> ResourceRequest.
        self._allocated: Dict = {}
        # Argument objects pinned for a lease: worker_id -> [ObjectID],
        # released with the lease (a pin left for ever would make every
        # consumed object unspillable).
        self._arg_pins: Dict = {}
        self.dependency_manager = DependencyManager(raylet)

    # step 1-2: queue + wait for args
    def queue_and_schedule(self, spec: TaskSpec, reply: Callable):
        self.dependency_manager.wait_for_args(
            spec, lambda: self._on_args_ready(spec, reply))

    def _on_args_ready(self, spec: TaskSpec, reply: Callable):
        with self._lock:
            self._dispatch_queue.append((spec, reply))
        self._raylet.loop.post(self.dispatch, "local.dispatch")

    # steps 3-6: pop a worker and bind it.
    def dispatch(self):
        prestart_bound = get_config().num_prestart_workers
        if prestart_bound:
            with self._lock:
                backlog = len(self._dispatch_queue)
            if backlog > 1:
                self._raylet.worker_pool.prestart_for_backlog(
                    backlog, prestart_bound)
        while True:
            with self._lock:
                if not self._dispatch_queue:
                    return
                spec, reply = self._dispatch_queue[0]
                worker = self._raylet.worker_pool.pop_worker(
                    runtime_env=spec.runtime_env)
                if worker is None:
                    return  # no worker slot; retried when one frees up
                self._dispatch_queue.popleft()
                held = spec.resources
                if spec.is_actor_creation() and \
                        spec.lifetime_resources is not None:
                    # Return placement-only resources (the default actor
                    # CPU) to the node as soon as the actor is placed.
                    held = spec.lifetime_resources
                    placed = spec.resources.to_dict()
                    kept = held.to_dict()
                    delta = {k: v - kept.get(k, 0.0)
                             for k, v in placed.items()
                             if v - kept.get(k, 0.0) > 0}
                    if delta:
                        self._raylet.cluster_view.add_back(
                            self._raylet.node_id, ResourceRequest(delta))
                        self._raylet.cluster_task_manager.on_resources_freed()
                self._allocated[worker.worker_id] = held
                pinned = list(spec.arg_object_ids())
                self._arg_pins[worker.worker_id] = pinned
            for oid in pinned:
                self._raylet.object_store.pin(oid)
            reply({"worker": worker, "raylet": self._raylet,
                   "resources": spec.resources})

    def release_worker_resources(self, worker) -> None:
        with self._lock:
            req = self._allocated.pop(worker.worker_id, None)
            pinned = self._arg_pins.pop(worker.worker_id, None)
        for oid in pinned or ():
            self._raylet.object_store.unpin(oid)
        if req is not None:
            self._raylet.cluster_view.add_back(self._raylet.node_id, req)
            self._raylet.loop.post(self.dispatch, "local.dispatch")
            self._raylet.cluster_task_manager.on_resources_freed()

    def allocated_for(self, worker_id) -> ResourceRequest:
        with self._lock:
            return self._allocated.get(worker_id, ResourceRequest())

    def num_queued(self) -> int:
        with self._lock:
            return len(self._dispatch_queue)
