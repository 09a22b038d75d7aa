"""The GCS server: the cluster's control plane.

A port of ``ray_tpu.gcs.server`` (reference
``src/ray/gcs/gcs_server/gcs_server.h:182-237``): the table storage
(memory, or a journaled file that a restarted GCS reloads), the
publisher, the internal KV with namespaces, the node manager with
incarnations and fencing counts, the heartbeat manager (a node is
SUSPECT after ``num_heartbeats_suspect`` missed beats and DEAD after
``num_heartbeats_timeout``), the resource manager's poll and broadcast
on the GCS loop, the job and worker managers, the task-event buffer and
manager, the actor manager and the placement-group manager;
``reconcile`` rebuilds the live state from the tables after a restart.
A node's death reaches the actor manager first (its actors restart or
die), then the placement-group manager, then the listeners, as in the
reference; a SUSPECT node's actors are left alone.  One ``GcsServer`` serves
the raylets of one process; a raylet "RPC" is a method call.

The GCS runs its batched solves on ``device`` (the placement-group
manager's bundle solve), the card unless the caller passes ``"cpu"``.

Divergence: the heartbeat check runs on a loop of its own
(``heartbeat_loop``, thread ``ray_tpu_torch::gcs-heartbeat``) on its
period's grid, making up at most ``HEARTBEAT_CATCH_UP`` missed checks
(``EventLoop.schedule_every(catch_up=...)``), so that a node dies
``num_heartbeats_timeout`` periods after its last beat even while the
GCS loop broadcasts and the host is loaded, while a pause of the whole
process is not counted against the raylets, which could not beat in it
either.  A death is declared (and published)
there, and the cascade (the resource view, the placement groups, the
listeners) is posted to the GCS loop.  The reference checks on the GCS
loop, by a timer that drifts.

Divergence (ROADMAP C.33, C.34): a raylet stamps each beat when it sends
it (``heartbeat(node_id, sent_at)``), and ``Raylet.kill`` fences the
stamp, so no beat stamped after a kill reaches the GCS.  A node has
missed the checks run since its newest stamp, so a beat sent before a
kill and landing after it is no sign of life after the kill.  A node is
dead at a check that makes ``num_heartbeats_timeout`` misses, or all but
``HEARTBEAT_LOST_CHECKS`` of them once its stamp is that many periods
old by the clock.  The reference resets the count at every beat's
arrival.
Left out until their items: the timeline store, which has no producer
before the remote node hosts (A.4b.9), and the flight recorder (A.4b.7).  Where the reference notes a failed raylet poll, broadcast or
death listener on its debug plane (``swallow.noted``), this GCS logs it
and counts it in ``stats``.

No GCS lock is held across a call into a raylet: the managers copy what
they iterate under their locks and call out after releasing them.
"""

from __future__ import annotations

import collections
import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.event_loop import EventLoop
from ray_tpu_torch._private.ids import JobID, NodeID, WorkerID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch._private.thread_registry import loop_only
from ray_tpu_torch.gcs import pubsub as pubsub_mod
from ray_tpu_torch.gcs.pubsub import Publisher
from ray_tpu_torch.gcs.storage import (FileStoreClient, GcsTableStorage,
                                       InMemoryStoreClient)
from ray_tpu_torch.scheduler.resources import (ClusterResourceView,
                                               NodeResources)

logger = logging.getLogger(__name__)

#: Missed heartbeat checks made up after the check's thread waited: a
#: wait of up to this many periods (the interpreter lock under load) is
#: counted whole, a longer one (a pause of the process, which stops the
#: beats too: a collection, a long numpy call) as this many periods.
HEARTBEAT_CATCH_UP = 3

#: A node whose newest stamp is ``num_heartbeats_timeout`` periods old
#: by the clock is dead at a check that counts at least this many fewer
#: misses: the checks the grid's catch-up did not make up are not waited
#: for (ROADMAP C.33), while a pause of the whole process, which made up
#: none, still kills no node.
HEARTBEAT_LOST_CHECKS = 2


class GcsNodeManager:
    """The node registry and death publishing (gcs_node_manager.cc),
    with incarnation fencing: every registration of a node id mints a
    monotonic incarnation (kept in the node table), and a message
    stamped with a non-current ``(node_id, incarnation)`` is rejected."""

    def __init__(self, storage: GcsTableStorage, publisher: Publisher):
        self._storage = storage
        self._publisher = publisher
        self._lock = threading.RLock()
        self.alive_nodes: Dict[NodeID, dict] = {}
        self.dead_nodes: Dict[NodeID, dict] = {}
        #: node_id -> latest minted incarnation; survives the node's
        #: death, so a re-registration of the same id moves forward.
        self._incarnations: Dict[NodeID, int] = {}
        #: node_id -> {message class -> rejected count}.
        self.fence_rejections: Dict[NodeID, Dict[str, int]] = {}

    def register_node(self, node_id: NodeID, info: dict,
                      incarnation: Optional[int] = None) -> int:
        with self._lock:
            if incarnation is None:
                prev = self._incarnations.get(node_id)
                if prev is None:
                    stored = self._storage.node_table.get(node_id)
                    prev = int((stored or {}).get("incarnation", 0))
                incarnation = prev + 1
            incarnation = int(incarnation)
            self._incarnations[node_id] = incarnation
            info = dict(info, state="ALIVE", start_time=time.time(),
                        incarnation=incarnation)
            self.alive_nodes[node_id] = info
            self.dead_nodes.pop(node_id, None)
            self._storage.node_table.put(node_id, info)
        self._publisher.publish(pubsub_mod.NODE_CHANNEL, node_id.binary(),
                                {"state": "ALIVE", "info": info})
        return incarnation

    # ---- incarnation fencing -------------------------------------------
    def current_incarnation(self, node_id: NodeID) -> int:
        with self._lock:
            return self._incarnations.get(node_id, 0)

    def check_incarnation(self, node_id: NodeID, incarnation) -> bool:
        """Whether ``(node_id, incarnation)`` is the current, live
        registration."""
        with self._lock:
            if node_id not in self.alive_nodes:
                return False
            return int(incarnation) == self._incarnations.get(node_id, 0)

    def note_fenced(self, node_id: NodeID, verb: str) -> None:
        with self._lock:
            per = self.fence_rejections.setdefault(node_id, {})
            per[verb] = per.get(verb, 0) + 1
        record_internal("ray_tpu.fencing.rejected_total", 1.0,
                        mtype="counter", verb=verb,
                        node=node_id.hex()[:12])

    def fenced_count(self, node_id: NodeID) -> int:
        with self._lock:
            return sum(self.fence_rejections.get(node_id, {}).values())

    # ---- suspect (before death) ----------------------------------------
    def mark_suspect(self, node_id: NodeID):
        """Missed-beats grace: published so that schedulers stop new
        placements on the node; its objects and groups are untouched."""
        with self._lock:
            info = self.alive_nodes.get(node_id)
            if info is None or info.get("state") == "SUSPECT":
                return
            info["state"] = "SUSPECT"
            info["suspect_since"] = time.time()
            self._storage.node_table.put(node_id, dict(info))
        record_internal("ray_tpu.node.suspect", 1.0,
                        node=node_id.hex()[:12])
        self._publisher.publish(pubsub_mod.NODE_CHANNEL, node_id.binary(),
                                {"state": "SUSPECT", "info": info})

    def clear_suspect(self, node_id: NodeID):
        with self._lock:
            info = self.alive_nodes.get(node_id)
            if info is None or info.get("state") != "SUSPECT":
                return
            info["state"] = "ALIVE"
            info.pop("suspect_since", None)
            self._storage.node_table.put(node_id, dict(info))
        record_internal("ray_tpu.node.suspect", 0.0,
                        node=node_id.hex()[:12])
        self._publisher.publish(pubsub_mod.NODE_CHANNEL, node_id.binary(),
                                {"state": "ALIVE", "info": info})

    def drain_node(self, node_id: NodeID):
        with self._lock:
            info = self.alive_nodes.get(node_id)
            if info is not None:
                info["draining"] = True

    def on_node_death(self, node_id: NodeID,
                      reason: str = "heartbeat timeout"):
        with self._lock:
            info = self.alive_nodes.pop(node_id, None)
            if info is None:
                return
            was_suspect = info.get("state") == "SUSPECT"
            info = dict(info, state="DEAD", death_reason=reason,
                        end_time=time.time())
            self.dead_nodes[node_id] = info
            self._storage.node_table.put(node_id, info)
        if was_suspect:
            record_internal("ray_tpu.node.suspect", 0.0,
                            node=node_id.hex()[:12])
        self._publisher.publish(pubsub_mod.NODE_CHANNEL, node_id.binary(),
                                {"state": "DEAD", "info": info})

    def get_all_node_info(self) -> Dict[NodeID, dict]:
        with self._lock:
            out = {nid: dict(info) for nid, info in self.alive_nodes.items()}
            out.update((nid, dict(info))
                       for nid, info in self.dead_nodes.items())
            return out

    def record_death_from_storage(self, node_id: NodeID, info: dict,
                                  reason: str):
        """Mark dead a node that exists only as a durable record (after
        a GCS restart it was never registered again)."""
        with self._lock:
            info = dict(info, state="DEAD", death_reason=reason,
                        end_time=time.time())
            self.alive_nodes.pop(node_id, None)
            self.dead_nodes[node_id] = info
            self._storage.node_table.put(node_id, info)
        self._publisher.publish(pubsub_mod.NODE_CHANNEL, node_id.binary(),
                                {"state": "DEAD", "info": info})

    def is_alive(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self.alive_nodes


class GcsHeartbeatManager:
    """Suspect-before-dead failure detection over missed heartbeats
    (gcs_heartbeat_manager.h:31-60): SUSPECT at ``num_heartbeats_suspect``
    missed beats (schedulers mask the node for new placements), DEAD at
    ``num_heartbeats_timeout`` (the whole death cascade).  A partition
    that heals inside the gap costs a placement pause only."""

    def __init__(self, loop: EventLoop,
                 on_node_death: Callable[[NodeID], None],
                 on_node_suspect: Optional[Callable[[NodeID], None]] = None,
                 on_node_recovered: Optional[Callable[[NodeID], None]] = None):
        cfg = get_config()
        self._period_s = cfg.raylet_heartbeat_period_milliseconds / 1000.0
        self._timeout = cfg.num_heartbeats_timeout
        self._suspect_after = min(max(1, cfg.num_heartbeats_suspect),
                                  self._timeout)
        self._lock = threading.Lock()
        # Serializes the suspect/recovered callback pair: _tick fires
        # _on_suspect after releasing _lock, so a racing beat's
        # _on_recovered could otherwise run first and the late
        # _on_suspect would mask a healthy node for ever.
        self._transition_lock = threading.Lock()
        #: The registered nodes -> the newest stamp of their beats (their
        #: registration's time before the first).
        self._sent: Dict[NodeID, float] = {}
        #: The checks' times, the newest last: a node has missed the
        #: checks run since its stamp.
        self._checks: collections.deque = collections.deque(
            maxlen=self._timeout)
        self._suspect: set = set()
        self._on_death = on_node_death
        self._on_suspect = on_node_suspect
        self._on_recovered = on_node_recovered
        self._paused = False
        # On the period's grid: a loaded host must not stretch the death
        # timeout run by run (EventLoop's catch_up divergence).
        loop.schedule_every(self._period_s, self._tick,
                            "gcs.heartbeat_check",
                            catch_up=HEARTBEAT_CATCH_UP)

    def register(self, node_id: NodeID):
        with self._lock:
            self._sent[node_id] = time.monotonic()
            self._suspect.discard(node_id)

    def unregister(self, node_id: NodeID):
        with self._lock:
            self._sent.pop(node_id, None)
            self._suspect.discard(node_id)

    def _missed(self, node_id: NodeID) -> int:
        sent = self._sent[node_id]
        return sum(1 for t in self._checks if t > sent)

    def heartbeat(self, node_id: NodeID, sent_at: float) -> bool:
        """False for an unknown node (dead, or never registered).
        ``sent_at`` is the ``time.monotonic()`` at which the raylet sent
        the beat."""
        recovered = False
        with self._lock:
            if node_id not in self._sent:
                return False
            self._sent[node_id] = max(self._sent[node_id], sent_at)
            if node_id in self._suspect and \
                    self._missed(node_id) < self._suspect_after:
                self._suspect.discard(node_id)
                recovered = True
        if recovered and self._on_recovered is not None:
            with self._transition_lock:
                self._on_recovered(node_id)
        return True

    def is_suspect(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self._suspect

    def pause(self, paused: bool = True):
        self._paused = paused

    @loop_only("gcs")
    def _tick(self):
        if self._paused:
            return
        dead = []
        suspects = []
        with self._lock:
            now = time.monotonic()
            self._checks.append(now)
            silent_s = self._timeout * self._period_s
            for node_id in list(self._sent):
                missed = self._missed(node_id)
                if missed >= self._timeout or (
                        now - self._sent[node_id] >= silent_s and
                        missed >= self._timeout - HEARTBEAT_LOST_CHECKS):
                    dead.append(node_id)
                    del self._sent[node_id]
                    self._suspect.discard(node_id)
                elif missed >= self._suspect_after and \
                        node_id not in self._suspect:
                    self._suspect.add(node_id)
                    suspects.append(node_id)
        for node_id in suspects:
            if self._on_suspect is None:
                continue
            with self._transition_lock:
                # A beat may have cleared the suspicion (and run its
                # recovery) since the list was taken.
                with self._lock:
                    still_suspect = node_id in self._suspect
                if still_suspect:
                    self._on_suspect(node_id)
        for node_id in dead:
            self._on_death(node_id)


def _collect_resources(mgr: "GcsResourceManager") -> None:
    record_internal("ray_tpu.cluster.alive_nodes", len(mgr._raylets))
    for name, v in mgr.view.total_cluster_resources().items():
        record_internal("ray_tpu.cluster.total_resources", v, resource=name)
    for name, v in mgr.view.available_cluster_resources().items():
        record_internal("ray_tpu.cluster.available_resources", v,
                        resource=name)


class GcsResourceManager:
    """The GCS-side resource view and the usage broadcast (RaySyncer and
    gcs_resource_manager.cc): every
    ``gcs_resource_broadcast_period_milliseconds`` the GCS loop polls
    each raylet's report, folds its availability into ``view`` and sends
    the batch.  In-process raylets get the full batch every period;
    a raylet with ``is_remote_proxy`` gets the changed rows only, a full
    batch when it joins and on every 20th period.  Every batch carries
    the suspect nodes."""

    def __init__(self, loop: EventLoop, publisher: Publisher):
        self.view = ClusterResourceView()
        self._publisher = publisher
        self._loop = loop
        # Guards the membership and bookkeeping below; never held across
        # a raylet call.
        self._lock = threading.Lock()
        self._raylets: Dict[NodeID, object] = {}
        self._last_sent: Dict[NodeID, dict] = {}
        self._needs_full: set = set()
        self._removed_pending: set = set()
        # Receivers dirty their peer rows at spillback, and a row whose
        # value did not change would never correct them under deltas:
        # every _full_every-th period is a full resync.
        self._period = 0
        self._full_every = 20
        self._suspect: set = set()
        self._last_suspect_sent: set = set()
        self.stats = {"poll_errors": 0, "broadcast_errors": 0,
                      "rounds": 0}
        self._period_s = \
            get_config().gcs_resource_broadcast_period_milliseconds / 1000.0
        loop.schedule_after(self._period_s, self._sync_round,
                            "gcs.resource_sync")
        get_metrics_registry().register_collector(self, _collect_resources)

    def register_raylet(self, node_id: NodeID, raylet,
                        resources: NodeResources):
        # A copy, never the raylet's own ledger: the poll writes
        # availability snapshots into this view's row, and through an
        # alias a stale report would erase the ledger's allocations.
        self.view.add_node(node_id, resources.copy())
        with self._lock:
            self._raylets[node_id] = raylet
            self._needs_full.add(node_id)
            self._removed_pending.discard(node_id)

    def unregister_raylet(self, node_id: NodeID):
        with self._lock:
            self._raylets.pop(node_id, None)
            self._last_sent.pop(node_id, None)
            self._needs_full.discard(node_id)
            self._removed_pending.add(node_id)
        self.set_suspect(node_id, False)
        self.view.remove_node(node_id)

    def set_suspect(self, node_id: NodeID, flag: bool):
        with self._lock:
            if flag:
                self._suspect.add(node_id)
            else:
                self._suspect.discard(node_id)
            suspect = set(self._suspect)
        self.view.set_masked(suspect)

    def raylets(self) -> Dict[NodeID, object]:
        with self._lock:
            return dict(self._raylets)

    def live_available_resources(self) -> Dict[str, float]:
        """Exact cluster availability: in-process raylets read from their
        own ledgers (the view's copies lag one poll), remote ones from
        their last polled row."""
        out: Dict[str, float] = {}
        for node_id, raylet in self.raylets().items():
            if getattr(raylet, "is_remote_proxy", False):
                row = self.view.node_resources(node_id)
                av = row.to_float_dict("available") if row is not None \
                    else {}
            else:
                av = raylet.local_resources.to_float_dict("available")
            for k, v in av.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _sync_round(self):
        """One round, then the next ``_period_s`` after its end (a
        divergence: the reference's timer re-arms at the round's start,
        and a round longer than the period then runs back to back,
        holding the interpreter lock against every raylet)."""
        try:
            self._poll_and_broadcast()
        finally:
            self._loop.schedule_after(self._period_s, self._sync_round,
                                      "gcs.resource_sync")

    def _poll_and_broadcast(self):
        """Poll every raylet's report (RequestResourceReport), fold it
        into the view, then send the batch (UpdateResourceUsage)."""
        full = {}
        delta = {}
        raylets = self.raylets()
        for node_id, raylet in raylets.items():
            try:
                usage = raylet.get_resource_report()
            except Exception:
                # A node whose report keeps failing goes stale in the
                # view: count it.
                self.stats["poll_errors"] += 1
                logger.exception("resource poll of %s failed",
                                 node_id.hex()[:12])
                continue
            full[node_id] = usage
            self.view.update_available(node_id, usage["available"])
            if self._last_sent.get(node_id) != usage["available"]:
                delta[node_id] = usage
                self._last_sent[node_id] = dict(usage["available"])
        with self._lock:
            joiners, self._needs_full = self._needs_full, set()
            removed = list(self._removed_pending)
            self._removed_pending = set()
            self._period += 1
            resync = self._period % self._full_every == 0
            # A change of the suspect set forces a send even when no
            # row changed.
            suspect = list(self._suspect)
            suspect_changed = self._suspect != self._last_suspect_sent
            self._last_suspect_sent = set(self._suspect)
        self.stats["rounds"] += 1
        for node_id, raylet in raylets.items():
            # Deltas save the wire: in-process raylets cost nothing to
            # update and keep the full batch every period.
            if not getattr(raylet, "is_remote_proxy", False) or \
                    resync or node_id in joiners:
                batch = {"rows": full, "full": True, "removed": removed,
                         "suspect": suspect}
            elif delta or removed or suspect_changed:
                batch = {"rows": delta, "full": False,
                         "removed": removed, "suspect": suspect}
            else:
                continue
            try:
                raylet.update_resource_usage(batch)
            except Exception:
                self.stats["broadcast_errors"] += 1
                logger.exception("resource broadcast to %s failed",
                                 node_id.hex()[:12])


class GcsJobManager:
    def __init__(self, storage: GcsTableStorage, publisher: Publisher):
        self._storage = storage
        self._publisher = publisher
        self._lock = threading.Lock()
        self.jobs: Dict[JobID, dict] = {}

    def add_job(self, job_id: JobID, config: Optional[dict] = None) -> dict:
        with self._lock:
            info = {"job_id": job_id.hex(), "state": "RUNNING",
                    "start_time": time.time(), "config": config or {}}
            self.jobs[job_id] = info
            self._storage.job_table.put(job_id, info)
        self._publisher.publish(pubsub_mod.JOB_CHANNEL, job_id.binary(), info)
        return info

    def mark_job_finished(self, job_id: JobID):
        with self._lock:
            info = self.jobs.get(job_id)
            if info is None:
                return
            info["state"] = "FINISHED"
            info["end_time"] = time.time()
            self._storage.job_table.put(job_id, info)
        self._publisher.publish(pubsub_mod.JOB_CHANNEL, job_id.binary(), info)


class GcsInternalKV:
    """The internal KV with namespaces (the GCS KV manager: function
    exports, cluster metadata)."""

    def __init__(self, storage: GcsTableStorage):
        self._table = storage.kv_table

    @staticmethod
    def _ns_key(key: bytes, namespace: Optional[bytes]) -> bytes:
        return (namespace or b"") + b"@" + key

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace: Optional[bytes] = None) -> bool:
        k = self._ns_key(key, namespace)
        if not overwrite and self._table.get(k) is not None:
            return False
        self._table.put(k, value)
        return True

    def get(self, key: bytes, namespace: Optional[bytes] = None):
        return self._table.get(self._ns_key(key, namespace))

    def delete(self, key: bytes, namespace: Optional[bytes] = None) -> bool:
        return self._table.delete(self._ns_key(key, namespace))

    def exists(self, key: bytes, namespace: Optional[bytes] = None) -> bool:
        return self.get(key, namespace) is not None

    def keys(self, prefix: bytes = b"", namespace: Optional[bytes] = None):
        ns = (namespace or b"") + b"@"
        full = ns + prefix
        return [k[len(ns):] for k, _ in self._table.get_all()
                if k.startswith(full)]


class GcsWorkerManager:
    def __init__(self, publisher: Publisher):
        self._publisher = publisher
        self._lock = threading.Lock()
        self.workers: Dict[WorkerID, dict] = {}

    def register_worker(self, worker_id: WorkerID, info: dict):
        with self._lock:
            self.workers[worker_id] = info

    def report_worker_failure(self, worker_id: WorkerID, reason: str):
        with self._lock:
            info = self.workers.get(worker_id, {})
            info["state"] = "DEAD"
            info["reason"] = reason
        self._publisher.publish(pubsub_mod.WORKER_FAILURE_CHANNEL,
                                worker_id.binary(), info)


class GcsServer:
    """The assembled control plane (gcs_server.h:182-237).  A file store
    at ``storage_path`` (or ``<temp_dir>/gcs_store.bin`` when
    ``gcs_storage_backend`` is ``"file"``) survives a restart; the
    memory store dies with the server."""

    def __init__(self, storage_path: Optional[str] = None, device=None):
        cfg = get_config()
        if storage_path or cfg.gcs_storage_backend == "file":
            store = FileStoreClient(storage_path or os.path.join(
                cfg.temp_dir, "gcs_store.bin"))
        else:
            store = InMemoryStoreClient()
        self.device = device
        self.storage = GcsTableStorage(store)
        self.loop = EventLoop("gcs")
        # The heartbeat check has a loop of its own (a divergence): on the
        # GCS loop it waits behind the resource broadcast, which takes
        # tens of ms at 64 raylets, and the death timeout stretches.
        self.heartbeat_loop = EventLoop("gcs-heartbeat")
        self.publisher = Publisher()
        self.kv = GcsInternalKV(self.storage)
        self.node_manager = GcsNodeManager(self.storage, self.publisher)
        self.heartbeat_manager = GcsHeartbeatManager(
            self.heartbeat_loop, self._on_node_death,
            on_node_suspect=self._on_node_suspect,
            on_node_recovered=self._on_node_recovered)
        self.resource_manager = GcsResourceManager(self.loop, self.publisher)
        self.job_manager = GcsJobManager(self.storage, self.publisher)
        self.worker_manager = GcsWorkerManager(self.publisher)
        # The task-event pipeline: emitters drop lifecycle transitions
        # into the bounded buffer, whose batches reach the manager over
        # the publisher.
        from ray_tpu_torch.gcs.task_events import (TaskEventBuffer,
                                                   TaskEventManager)
        self.task_event_manager = TaskEventManager(self.publisher)
        self.task_events = TaskEventBuffer(self.publisher)
        from ray_tpu_torch.gcs.actor_manager import GcsActorManager
        self.actor_manager = GcsActorManager(
            self, random.Random(cfg.actor_scheduling_seed))
        from ray_tpu_torch.gcs.placement_group_manager import \
            GcsPlacementGroupManager
        self.placement_group_manager = GcsPlacementGroupManager(self)
        self._node_death_listeners: List[Callable[[NodeID], None]] = []
        self._lock = threading.Lock()
        self._raylets: Dict[NodeID, object] = {}
        self.stats = {"death_listener_errors": 0}

    # ---- raylet registration (NodeInfoGcsService) ----------------------
    def register_raylet(self, raylet) -> int:
        node_id = raylet.node_id
        with self._lock:
            self._raylets[node_id] = raylet
        # A raylet that carries an incarnation keeps it (a survivor of a
        # GCS restart is not a new incarnation); a fresh one mints the
        # next.
        incarnation = self.node_manager.register_node(
            node_id, raylet.node_info(),
            incarnation=getattr(raylet, "incarnation", None))
        raylet.incarnation = incarnation
        self.heartbeat_manager.register(node_id)
        self.resource_manager.register_raylet(node_id, raylet,
                                              raylet.local_resources)
        return incarnation

    def unregister_raylet(self, node_id: NodeID, intentional: bool = True):
        self.heartbeat_manager.unregister(node_id)
        self.resource_manager.unregister_raylet(node_id)
        with self._lock:
            self._raylets.pop(node_id, None)
        if intentional:
            self.node_manager.on_node_death(node_id, "intentional shutdown")
            self._notify_node_death(node_id)

    def raylet(self, node_id: NodeID):
        with self._lock:
            return self._raylets.get(node_id)

    def raylets(self) -> Dict[NodeID, object]:
        with self._lock:
            return dict(self._raylets)

    def reconcile(self, raylets):
        """After a restart over persistent storage: register the
        surviving raylets again, declare dead the nodes of the table that
        did not survive, and rebuild the actors and the placement groups
        from their tables (GcsInitData and ReleaseUnusedBundles).  The
        actor half's ms are kept in ``reconcile_ms["actors"]``."""
        survivors = set()
        for raylet in raylets:
            self.register_raylet(raylet)
            survivors.add(raylet.node_id)
        for key, info in self.storage.node_table.get_all():
            node_id = key if isinstance(key, NodeID) else NodeID(key)
            if info.get("state") == "ALIVE" and node_id not in survivors:
                self.node_manager.record_death_from_storage(
                    node_id, info, "did not survive GCS restart")
                self._notify_node_death(node_id)
        t0 = time.perf_counter()
        self.actor_manager.reconcile(raylets)
        self.reconcile_ms = {"actors": (time.perf_counter() - t0) * 1e3}
        self.placement_group_manager.reconcile(raylets)

    def _on_node_death(self, node_id: NodeID):
        """A death by missed beats, declared on the heartbeat loop; the
        rest of the cascade runs on the GCS loop, serialized with the
        placement-group manager's two-phase commits."""
        self.node_manager.on_node_death(node_id)
        self.loop.post(lambda: self._after_node_death(node_id),
                       "gcs.node_death")

    def _after_node_death(self, node_id: NodeID):
        self.resource_manager.unregister_raylet(node_id)
        with self._lock:
            self._raylets.pop(node_id, None)
        self._notify_node_death(node_id)

    def _on_node_suspect(self, node_id: NodeID):
        """Missed-beats grace: mask new placements, touch nothing else."""
        self.node_manager.mark_suspect(node_id)
        self.resource_manager.set_suspect(node_id, True)

    def _on_node_recovered(self, node_id: NodeID):
        self.node_manager.clear_suspect(node_id)
        self.resource_manager.set_suspect(node_id, False)

    def _notify_node_death(self, node_id: NodeID):
        self.actor_manager.on_node_death(node_id)
        self.placement_group_manager.on_node_death(node_id)
        for cb in list(self._node_death_listeners):
            try:
                cb(node_id)
            except Exception:
                # One listener's fault must not stop the fan-out, and a
                # dropped death notification must be visible.
                self.stats["death_listener_errors"] += 1
                logger.exception("node death listener failed for %s",
                                 node_id.hex()[:12])

    def subscribe_node_death(self, cb: Callable[[NodeID], None]):
        self._node_death_listeners.append(cb)

    def stop_loops(self):
        """Stop the GCS's loops: no check, broadcast or retry runs
        after this."""
        self.heartbeat_loop.stop()
        self.loop.stop()

    def shutdown(self):
        self.task_events.stop()
        self.stop_loops()
        close = getattr(self.storage.store, "close", None)
        if close is not None:
            close()
