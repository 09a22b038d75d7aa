"""Per-node dispatch: args -> resources -> worker binding.

A port of ``ray_tpu._private.local_task_manager`` for the PyTorch port:
the dispatch queue, the resources each leased worker holds,
``release_worker_resources`` and the actor-creation hand-back of
placement-only resources.  Resources were reserved by the
``ClusterTaskManager`` when it chose this node, so dispatch only needs a
worker slot.

The raylet has no object manager yet (the device-object plane comes
later), so ``DependencyManager`` dispatches a spec whose arguments are
all inline at once and raises ``NotImplementedError`` for one that
passes an object by reference: it never waits for an argument it
cannot fetch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.scheduler.resources import ResourceRequest


class DependencyManager:
    """Holds a task until its argument objects are node-local."""

    def __init__(self, raylet):
        self._raylet = raylet

    def wait_for_args(self, spec: TaskSpec, ready_cb: Callable[[], None]):
        refs = spec.arg_object_ids()
        if refs:
            raise NotImplementedError(
                f"task {spec.task_id} passes {len(refs)} object(s) by "
                "reference; the raylet has no object manager until the "
                "device-object plane is ported (ROADMAP A.5)")
        ready_cb()


class LocalTaskManager:
    def __init__(self, raylet):
        self._raylet = raylet
        self._lock = threading.RLock()
        self._dispatch_queue: deque = deque()
        # Resources held by leased workers: worker_id -> ResourceRequest.
        self._allocated: Dict = {}
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
            reply({"worker": worker, "raylet": self._raylet,
                   "resources": spec.resources})

    def release_worker_resources(self, worker) -> None:
        with self._lock:
            req = self._allocated.pop(worker.worker_id, None)
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
