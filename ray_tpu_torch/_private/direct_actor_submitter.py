"""Actor-task transport: ordered per-actor queues and restart handling.

A port of ``ray_tpu._private.direct_actor_submitter`` (reference
``src/ray/core_worker/transport/direct_actor_task_submitter.h``): one
queue per actor, sent in submission order to the actor's worker
(``sequential_actor_submit_queue.cc``), held while the actor is
PENDING_CREATION or RESTARTING, and failed with ``ActorDiedError`` once
it is DEAD; the actor's state and worker come from the GCS's actor
channel, and ``on_gcs_restart`` moves the subscriptions to a restarted
GCS.  A method's SUBMITTED_TO_WORKER task event is emitted as it is sent
(reference ``direct_actor_submitter.py:104-108``).

Divergence (ROADMAP C.15): a method that fails for a system reason (its
worker stopped, or its node died under it) is answered as an
``ActorDiedError`` and retried per ``max_task_retries`` after the actor
is ALIVE again on another worker; until the GCS publishes that worker
the queue holds, and it never sends to the worker that failed.  In the
reference such a method is retried at once, onto the worker the queue
still names, or is never answered (a method queued at a killed worker),
or completes from the dead node's thread.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Set

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.gcs import pubsub as pubsub_mod
from ray_tpu_torch.gcs import task_events
from ray_tpu_torch.gcs.actor_manager import ActorState


class _ActorQueue:
    __slots__ = ("pending", "inflight", "state", "worker", "failed")

    def __init__(self):
        self.pending: deque = deque()
        self.inflight = 0
        self.state = ActorState.PENDING_CREATION
        self.worker = None
        # Workers a method failed on: never sent to again.
        self.failed: Set = set()


class DirectActorTaskSubmitter:
    def __init__(self, core_worker):
        self._core = core_worker
        self._lock = threading.RLock()
        self._queues: Dict[ActorID, _ActorQueue] = {}
        self.stats = {"system_failures": 0}

    def _subscribe(self, gcs, actor_id: ActorID) -> None:
        gcs.publisher.subscribe(
            pubsub_mod.ACTOR_CHANNEL, actor_id.binary(),
            lambda key, info, aid=actor_id: self._on_actor_update(aid, info))

    def _queue_for(self, actor_id: ActorID) -> _ActorQueue:
        q = self._queues.get(actor_id)
        if q is None:
            q = _ActorQueue()
            self._queues[actor_id] = q
            gcs = self._core.cluster.gcs
            self._subscribe(gcs, actor_id)
            # Seed the current state.
            actor = gcs.actor_manager.get_actor(actor_id)
            if actor is not None:
                q.state = actor.state
                q.worker = actor.worker
        return q

    def submit(self, spec: TaskSpec):
        actor_id = spec.actor_id
        with self._lock:
            q = self._queue_for(actor_id)
            q.pending.append(spec)
        self._pump(actor_id)

    def _pump(self, actor_id: ActorID):
        while True:
            with self._lock:
                q = self._queues.get(actor_id)
                if q is None or not q.pending:
                    return
                if q.state == ActorState.DEAD:
                    spec = q.pending.popleft()
                    actor = self._core.cluster.gcs.actor_manager.get_actor(
                        actor_id)
                    reason = actor.death_cause if actor else "actor dead"
                    err = exceptions.ActorDiedError(actor_id, reason)
                    fail = True
                elif q.state == ActorState.ALIVE and \
                        q.worker is not None and \
                        q.worker.worker_id not in q.failed:
                    spec = q.pending.popleft()
                    q.inflight += 1
                    worker = q.worker
                    fail = False
                else:
                    return  # PENDING, RESTARTING or a failed worker: hold.
            if fail:
                self._core.task_manager.fail_task(spec, err)
                continue

            def on_done(error, spec=spec, worker=worker):
                with self._lock:
                    q2 = self._queues.get(actor_id)
                    if q2 is not None:
                        q2.inflight -= 1
                        if error is not None and \
                                not isinstance(error, exceptions.TaskError):
                            q2.failed.add(worker.worker_id)
                if error is None:
                    self._core.task_manager.complete_task(spec)
                elif isinstance(error, exceptions.TaskError):
                    self._core.task_manager.fail_task(spec, error)
                else:
                    # The worker or its node died under the method: the
                    # GCS restarts or buries the actor; retry per
                    # max_task_retries once it is ALIVE elsewhere.
                    self.stats["system_failures"] += 1
                    if not isinstance(error, exceptions.ActorError):
                        error = exceptions.ActorDiedError(
                            actor_id, f"the actor's worker died under the "
                                      f"call ({type(error).__name__})")
                    self._core.task_manager.fail_or_retry(
                        spec, error, resubmit=self.submit)
                self._pump(actor_id)

            nid = getattr(worker, "node_id", None)
            wid = getattr(worker, "worker_id", None)
            task_events.emit(self._core.cluster, spec.task_id,
                             task_events.SUBMITTED_TO_WORKER,
                             node_id=nid.hex() if nid is not None else "",
                             worker_id=wid.hex() if wid is not None else "")
            worker.submit_actor_task(spec, on_done)

    def on_gcs_restart(self):
        """Move every queue to the restarted GCS: the subscriptions
        died with the old publisher, and the workers are read again
        from the reconciled registry."""
        with self._lock:
            actor_ids = list(self._queues)
        gcs = self._core.cluster.gcs
        for actor_id in actor_ids:
            self._subscribe(gcs, actor_id)
            actor = gcs.actor_manager.get_actor(actor_id)
            with self._lock:
                q = self._queues.get(actor_id)
                if q is not None and actor is not None:
                    q.state = actor.state
                    q.worker = actor.worker
            self._pump(actor_id)

    def _on_actor_update(self, actor_id: ActorID, info: dict):
        actor = self._core.cluster.gcs.actor_manager.get_actor(actor_id)
        with self._lock:
            q = self._queues.get(actor_id)
            if q is None:
                return
            q.state = info.get("state", q.state)
            q.worker = actor.worker if actor is not None else None
        self._pump(actor_id)
