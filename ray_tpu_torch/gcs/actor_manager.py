"""GCS actor management and scheduling.

A port of ``ray_tpu.gcs.actor_manager`` (reference
``src/ray/gcs/gcs_server/gcs_actor_manager.{h,cc}``): the actor registry
and its state machine (PENDING_CREATION -> ALIVE -> RESTARTING -> DEAD),
restarts per ``max_restarts`` (0 none, n at most n, -1 for ever), named
actors per namespace, the actor table a restarted GCS reloads, state
changes published on ``ACTOR_CHANNEL``, and the two actor schedulers
that ``gcs_actor_scheduling_enabled`` switches between: by default the
creation lease goes to a raylet, whose tick places it (on the card's
``class_fill`` when its queue holds more than one lease), and may spill
back (``gcs_actor_scheduler.cc:459-493``); with the switch on the GCS
picks the node on its own resource view (``gcs_actor_distribution.h:66``)
through ``scheduler.policy.schedule``.  The raylet is drawn from
``rng``, a ``random.Random`` the GCS seeds from the config's
``actor_scheduling_seed`` (the reference draws from the module-level
``random``).

Divergences, each pinned by ``tests/test_torch_actor_manager.py`` and
``tests/test_torch_actor_fault.py`` beside the reference's outcome
(ROADMAP C.13-C.16):

* One death, one restart.  A worker's death report names the worker
  (``on_actor_worker_died(..., worker_id)``) and is dropped when it is
  not the actor's current worker; ``on_node_death`` takes the actors
  whose current worker lives on the node, not those whose last node it
  was.  The reference matches a RESTARTING actor again by its stale
  node, so a death reported by the worker and then by the node spends
  two restarts (or turns a ``max_restarts=1`` actor DEAD).  A creation
  reply from a worker the actor no longer has changes nothing, and an
  instance it made is killed; a lease granted to an actor killed
  while it waited goes back to its raylet.
* Placement from the loop never strands an actor.  A restart, a retry
  after an infeasible or rejected lease and a re-placement after a GCS
  restart all enter through ``_retry_schedule``, which turns a raise
  (no raylet left) into DEAD; the reference posts ``_schedule`` for
  these, and an actor whose placement raises there stays RESTARTING
  with its callers blocked.
* A creation lease re-sent to the raylet a spillback named carries
  ``grant_or_reject`` (ROADMAP C.4): granted there or rejected, never
  spilled again; a rejection is retried like an infeasible lease.
* A creation lost with its node (``NodeDiedError``) is retried like one
  whose worker crashed.
"""

from __future__ import annotations

import logging
import pickle
import random
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch.gcs import pubsub as pubsub_mod
from ray_tpu_torch.scheduler.policy import schedule

logger = logging.getLogger(__name__)


class ActorState:
    DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class GcsActor:
    def __init__(self, actor_id: ActorID, creation_spec, name: str = "",
                 namespace: str = "", max_restarts: int = 0,
                 detached: bool = False):
        self.actor_id = actor_id
        self.creation_spec = creation_spec
        self.name = name
        self.namespace = namespace
        self.max_restarts = max_restarts
        self.num_restarts = 0
        self.creation_retries = 0
        self.detached = detached
        self.state = ActorState.DEPENDENCIES_UNREADY
        self.node_id: Optional[NodeID] = None
        self.worker = None
        self.death_cause: str = ""

    def info(self) -> dict:
        return {
            "actor_id": self.actor_id.hex(),
            "state": self.state,
            "name": self.name,
            "namespace": self.namespace,
            "node_id": self.node_id.hex() if self.node_id else None,
            "max_restarts": self.max_restarts,
            "num_restarts": self.num_restarts,
            "death_cause": self.death_cause,
            "class_name": getattr(self.creation_spec, "function_name", ""),
        }


# Creation retries (a lease lost before the actor ran) are cheap and
# outside max_restarts, but must end: a constructor that reliably kills
# its worker would otherwise retry for ever.
_MAX_CREATION_RETRIES = 20

# A system failure of the creation task: the lease is lost, not the
# actor.
_LEASE_LOST = (exceptions.WorkerCrashedError, exceptions.NodeDiedError)


class GcsActorManager:
    def __init__(self, gcs, rng: random.Random):
        self._gcs = gcs
        self._rng = rng
        self._lock = threading.RLock()
        self._actors: Dict[ActorID, GcsActor] = {}
        # (namespace, name) -> actor_id for named actors.
        self._named: Dict[Tuple[str, str], ActorID] = {}
        self.stats = {"stale_worker_deaths": 0, "stale_creation_replies": 0,
                      "placement_errors": 0}

    # ---- registration and scheduling (gcs_actor_scheduler.cc:44) -------
    def register_actor(self, actor: GcsActor, ready_cb=None):
        with self._lock:
            if actor.name:
                key = (actor.namespace, actor.name)
                if key in self._named:
                    raise ValueError(
                        f"Actor name {actor.name!r} already taken in "
                        f"namespace {actor.namespace!r}")
                self._named[key] = actor.actor_id
            self._actors[actor.actor_id] = actor
            self._persist(actor)
        self._schedule(actor, ready_cb)
        return actor

    def _schedule(self, actor: GcsActor, ready_cb=None):
        actor.state = ActorState.PENDING_CREATION
        self._publish(actor)
        spec = actor.creation_spec
        raylets = self._gcs.raylets()
        if not raylets:
            raise exceptions.RayTpuError("No nodes available to create actor")
        if get_config().gcs_actor_scheduling_enabled:
            # The GCS picks the node on its own view.
            target = schedule(self._gcs.resource_manager.view,
                              spec.resources, spec.scheduling_options,
                              local_node_id=None)
            if target is None or target not in raylets:
                target = self._rng.choice(list(raylets.keys()))
        elif spec.scheduling_options.node_affinity_node_id is not None:
            target = spec.scheduling_options.node_affinity_node_id
        else:
            # Forward to a raylet, whose tick places the lease and may
            # spill it back.
            target = self._rng.choice(list(raylets.keys()))
        raylet = raylets.get(target)
        if raylet is None:
            raylet = self._rng.choice(list(raylets.values()))

        def on_lease(result):
            if "worker" in result:
                self._on_actor_created(actor, result["worker"], ready_cb)
            elif "retry_at" in result:
                retry = self._gcs.raylet(result["retry_at"])
                if retry is None:
                    self._gcs.loop.schedule_after(
                        0.05, lambda: self._retry_schedule(actor, ready_cb),
                        "actor.reschedule")
                else:
                    retry.request_worker_lease(spec, on_lease,
                                               grant_or_reject=True)
            else:
                # Infeasible or rejected now: retry on the loop.
                self._gcs.loop.schedule_after(
                    0.1, lambda: self._retry_schedule(actor, ready_cb),
                    "actor.retry")

        raylet.request_worker_lease(spec, on_lease)

    def _retry_schedule(self, actor: GcsActor, ready_cb=None):
        """Enter scheduling from a loop callback: ``_schedule`` raises
        when the cluster has no raylet, and a raise on the loop would
        leave the actor waiting for ever, so it becomes DEAD."""
        with self._lock:
            if actor.state == ActorState.DEAD:
                return
        try:
            self._schedule(actor, ready_cb)
        except Exception as e:      # noqa: BLE001 — becomes the cause
            self.stats["placement_errors"] += 1
            self._creation_failed(actor, f"creation failed: {e}", ready_cb)

    def _creation_failed(self, actor: GcsActor, cause: str, ready_cb):
        with self._lock:
            if actor.state == ActorState.DEAD:
                return
            actor.state = ActorState.DEAD
            actor.death_cause = cause
            actor.worker = None
            if actor.name:
                self._named.pop((actor.namespace, actor.name), None)
            self._persist(actor)
        self._publish(actor)
        if ready_cb:
            ready_cb(actor, exceptions.ActorError(reason=cause))

    def _on_actor_created(self, actor: GcsActor, worker, ready_cb):
        with self._lock:
            dead = actor.state == ActorState.DEAD
            if not dead:
                actor.worker = worker
                actor.node_id = worker.node_id
        if dead:
            # Killed while its lease was in flight: the lease goes back
            # (the reference would build the instance and mark it ALIVE).
            self.stats["stale_creation_replies"] += 1
            worker.node.return_worker(worker)
            return

        # Push the creation task to the leased worker, which becomes
        # dedicated to the actor.
        def on_done(error):
            with self._lock:
                stale = actor.worker is not worker
            if stale:
                # The actor moved on (its node died, it was killed or
                # restarted) while this creation ran: an instance made
                # here must not live beside the current one.
                self.stats["stale_creation_replies"] += 1
                if error is None:
                    worker.kill_actor()
                return
            if isinstance(error, _LEASE_LOST):
                # The lease was lost around the creation.  Retry the
                # placement, but first kill the old worker: it may have
                # built an instance whose reply was lost, and at most
                # one instance may live.
                with self._lock:
                    if actor.state == ActorState.DEAD:
                        return
                    old_worker, actor.worker = actor.worker, None
                    actor.creation_retries += 1
                    attempt = actor.creation_retries
                if old_worker is not None:
                    try:
                        old_worker.kill_actor()
                    except Exception:
                        logger.exception("actor %s: kill of the old worker "
                                         "failed", actor.actor_id.hex())
                if attempt > _MAX_CREATION_RETRIES:
                    self._creation_failed(
                        actor, f"creation failed after {attempt} "
                               f"lease losses: {error}", ready_cb)
                    return
                delay = min(2.0, 0.05 * (2 ** min(attempt, 6)))
                self._gcs.loop.schedule_after(
                    delay, lambda: self._retry_schedule(actor, ready_cb),
                    "actor.recreate")
                return
            with self._lock:
                if error is not None:
                    actor.state = ActorState.DEAD
                    actor.death_cause = f"creation failed: {error}"
                    actor.worker = None
                    if actor.name:
                        self._named.pop((actor.namespace, actor.name), None)
                else:
                    actor.state = ActorState.ALIVE
                    actor.creation_retries = 0
                self._persist(actor)
            self._publish(actor)
            if ready_cb:
                ready_cb(actor, error)

        worker.assign_actor(actor.creation_spec, on_done)

    # ---- death and restart (max_restarts) -------------------------------
    def on_actor_worker_died(self, actor_id: ActorID, reason: str,
                             worker_id=None):
        """The actor's worker died.  A report naming a worker that is
        not the actor's current one is stale (the death was already
        handled) and changes nothing."""
        with self._lock:
            actor = self._actors.get(actor_id)
            if actor is None or actor.state == ActorState.DEAD:
                return
            if worker_id is not None and (
                    actor.worker is None or
                    actor.worker.worker_id != worker_id):
                self.stats["stale_worker_deaths"] += 1
                return
            restarting = (actor.max_restarts == -1 or
                          actor.num_restarts < actor.max_restarts)
            if restarting:
                actor.num_restarts += 1
                actor.state = ActorState.RESTARTING
                actor.worker = None
            else:
                actor.state = ActorState.DEAD
                actor.death_cause = reason
                actor.worker = None
                if actor.name:
                    self._named.pop((actor.namespace, actor.name), None)
            self._persist(actor)
        self._publish(actor)
        if restarting:
            self._gcs.loop.post(lambda: self._retry_schedule(actor),
                                "actor.restart")

    def on_node_death(self, node_id: NodeID):
        """The actors whose current worker lived on ``node_id`` lost it;
        an actor waiting for a lease there is answered by the raylet
        ("node dead") and placed again without a restart."""
        with self._lock:
            victims = [(a.actor_id, a.worker.worker_id)
                       for a in self._actors.values()
                       if a.worker is not None and
                       a.worker.node_id == node_id and
                       a.state != ActorState.DEAD]
        for actor_id, worker_id in victims:
            self.on_actor_worker_died(actor_id, f"node {node_id} died",
                                      worker_id=worker_id)

    def destroy_actor(self, actor_id: ActorID, no_restart: bool = True):
        with self._lock:
            actor = self._actors.get(actor_id)
            if actor is None:
                return
            if no_restart:
                actor.max_restarts = actor.num_restarts
            worker = actor.worker
        if worker is not None:
            worker.kill_actor()
        else:
            self.on_actor_worker_died(actor_id, "killed via destroy_actor")

    def _persist(self, actor: GcsActor):
        """The durable record: the info and the pickled creation spec,
        so a restarted GCS can rebuild the registry."""
        record = actor.info()
        try:
            record["spec_blob"] = pickle.dumps(actor.creation_spec,
                                               protocol=5)
        except Exception:
            record["spec_blob"] = None
        self._gcs.storage.actor_table.put(actor.actor_id, record)

    # ---- after a GCS restart (gcs_init_data.cc) -------------------------
    def reconcile(self, raylets):
        """Rebuild the registry from the actor table: an actor whose
        dedicated worker still runs on a surviving raylet is re-attached
        ALIVE, in-memory state and all; one that was ALIVE and lost its
        worker in the outage restarts (spending a restart); one whose
        creation was in flight is placed without spending one."""
        for key, record in self._gcs.storage.actor_table.get_all():
            actor_id = key if isinstance(key, ActorID) else ActorID(key)
            if record.get("state") == ActorState.DEAD:
                continue
            blob = record.get("spec_blob")
            if not blob:
                continue
            try:
                spec = pickle.loads(blob)
            except Exception:
                logger.exception("actor %s: its spec does not load",
                                 actor_id.hex())
                continue
            actor = GcsActor(
                actor_id, spec,
                name=record.get("name", ""),
                namespace=record.get("namespace", ""),
                max_restarts=record.get("max_restarts", 0),
                detached=record.get("detached", False))
            actor.num_restarts = record.get("num_restarts", 0)
            worker = node_id = None
            for raylet in raylets:
                w = raylet.worker_pool.worker_for_actor(actor_id)
                if w is not None:
                    worker, node_id = w, raylet.node_id
                    break
            with self._lock:
                self._actors[actor_id] = actor
                if actor.name:
                    self._named[(actor.namespace, actor.name)] = actor_id
                if worker is not None:
                    actor.worker = worker
                    actor.node_id = node_id
                    actor.state = ActorState.ALIVE
                    self._persist(actor)
                elif record.get("state") == ActorState.ALIVE:
                    # Running before the outage: the restart below goes
                    # through the worker-death path.
                    actor.state = ActorState.ALIVE
            if worker is not None:
                self._publish(actor)
            elif record.get("state") == ActorState.ALIVE:
                self.on_actor_worker_died(actor_id,
                                          "lost during GCS restart")
            else:
                self._gcs.loop.post(
                    lambda a=actor: self._retry_schedule(a),
                    "actor.reconcile")

    # ---- lookup ---------------------------------------------------------
    def get_actor(self, actor_id: ActorID) -> Optional[GcsActor]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str,
                        namespace: str = "") -> Optional[GcsActor]:
        with self._lock:
            actor_id = self._named.get((namespace, name))
            return self._actors.get(actor_id) if actor_id else None

    def list_named_actors(self, all_namespaces: bool = False,
                          namespace: str = ""):
        with self._lock:
            if all_namespaces:
                return [{"namespace": ns, "name": n}
                        for (ns, n) in self._named]
            return [n for (ns, n) in self._named if ns == namespace]

    def all_actor_info(self):
        with self._lock:
            return {aid: a.info() for aid, a in self._actors.items()}

    def _publish(self, actor: GcsActor):
        self._gcs.publisher.publish(pubsub_mod.ACTOR_CHANNEL,
                                    actor.actor_id.binary(), actor.info())
