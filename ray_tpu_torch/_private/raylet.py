"""The per-node daemon's scheduling plane.

A port of the scheduling half of ``ray_tpu._private.raylet.Raylet`` for
the PyTorch port: the node's resources and its dirty view of the
cluster, the event loop with the periodic scheduling tick, the worker
pool of executor threads, the local and cluster task managers, the
lease protocol (``request_worker_lease``, ``request_worker_lease_batch``,
``return_worker``), the resource broadcast's receiving end
(``update_resource_usage``) and ``core_worker``, the owner whose memory
store holds the objects its tasks pass (wired by ``LocalCluster``); and
the object plane in the reference's order: the node store
(``object_store``, ``object_store_memory`` bytes, spilling into
``<temp_dir>/spill/<node>``), its spill thread
(``local_object_manager``) and the pulls (``object_manager``) over the
cluster's object directory; and the placement-group bundle two-phase
commit (``prepare_bundle_resources``, ``commit_bundle_resources``,
``cancel_resource_reserve``, reference ``raylet.py:283-331``).

The reference raylet's heartbeat thread and its native shared-memory
segment (ROADMAP A.4b.2b; ``use_native_object_store=True`` raises here)
belong to items the port does not have yet; its resource report carries
no host statistics and no transfer load (the hint of cross-process
pulls, which come with process workers).  A raylet made without a
cluster (``Raylet(None, ...)``) keeps an object directory of its own.

Divergence (ROADMAP C.9): a broadcast row whose totals differ from the
view's, as a peer's do after it commits or cancels a bundle, replaces
that node's row, so the bundle's formatted resources reach every view.
The reference updates only the availability of a known node
(``ClusterResourceView.update_available``), so a node it knew before the
commit never shows the bundle's columns there, and a task for the
bundle submitted at another raylet stays infeasible.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from ray_tpu_torch._private.cluster_task_manager import ClusterTaskManager
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.event_loop import EventLoop
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.local_object_manager import LocalObjectManager
from ray_tpu_torch._private.local_task_manager import LocalTaskManager
from ray_tpu_torch._private.object_manager import (NodeObjectManager,
                                                   ObjectDirectory)
from ray_tpu_torch._private.object_store import NodeObjectStore
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch._private.worker_pool import WorkerPool
from ray_tpu_torch.scheduler.bundle_packing import bundle_resource_names
from ray_tpu_torch.scheduler.resources import (ClusterResourceView,
                                               NodeResources,
                                               ResourceRequest, _quantize)



class Raylet:
    """One node's scheduler.  ``device`` is where its batched tick runs:
    the card unless the caller passes ``"cpu"``; it is resolved here
    when ``scheduler_backend`` is ``"torch"``, so a raylet without a
    card raises at construction.  Its node store holds
    ``object_store_memory`` bytes (``Config.object_store_memory`` by
    default)."""

    def __init__(self, cluster, resources: Dict[str, float],
                 node_name: str = "", labels: Optional[Dict] = None,
                 device=None, object_store_memory: Optional[int] = None):
        cfg = get_config()
        if cfg.use_native_object_store:
            raise NotImplementedError(
                "use_native_object_store=True: the native shared-memory "
                "segment is not ported yet (ROADMAP A.4b.2b); the node "
                "store holds objects on the Python heap")
        self.device = resolve_device(device) \
            if cfg.scheduler_backend == "torch" else device
        self.cluster = cluster
        self.node_id = NodeID.from_random()
        self.node_name = node_name or f"node-{self.node_id.hex()[:8]}"
        self.local_resources = NodeResources(resources, labels=labels)
        self.cluster_view = ClusterResourceView()   # local (dirty) view
        self.loop = EventLoop(f"raylet-{self.node_id.hex()[:6]}")
        spill_dir = os.path.join(cfg.temp_dir, "spill",
                                 self.node_id.hex()[:8])
        self.object_store = NodeObjectStore(
            self.node_id, object_store_memory or cfg.object_store_memory,
            spill_dir=spill_dir,
            spill_threshold=cfg.object_spilling_threshold,
            on_spilled=self._record_spilled_url)
        # The spill thread moves spilling over the threshold off the put
        # path and feeds the create-request queue.
        self.local_object_manager = LocalObjectManager(
            self.object_store, spill_dir,
            node_label=self.node_id.hex()[:12])
        self.object_store.attach_spill_manager(self.local_object_manager)
        self.core_worker = None      # wired by the cluster/driver
        self.worker_pool = WorkerPool(self)
        self.local_task_manager = LocalTaskManager(self)
        # Lease-protocol round-trip counters, rendered by the tick
        # collector.
        self.lease_stats = {"lease_requests": 0,
                            "lease_batch_requests": 0,
                            "lease_batch_entries": 0}
        self.cluster_task_manager = ClusterTaskManager(self)
        self.object_manager = NodeObjectManager(
            self, ObjectDirectory() if cluster is None
            else cluster.object_directory)
        self._dead = False
        # The bundle two-phase commit's ledger: (pg_id, index) -> request.
        self._prepared_bundles: Dict[tuple, ResourceRequest] = {}
        self._committed_bundles: Dict[tuple, ResourceRequest] = {}
        # The last broadcast totals of each peer, to see them change.
        self._peer_totals: Dict = {}
        # Seed the view with this node's own row: the view's local row
        # is this node's authoritative ledger.
        self.cluster_view.add_node(self.node_id, self.local_resources)
        # Periodic scheduling tick (node_manager.cc:392-394).
        self.loop.schedule_every(
            cfg.event_loop_tick_ms / 1000.0,
            self.cluster_task_manager.schedule_and_dispatch,
            "raylet.schedule_tick")

    # ---- GCS-facing -----------------------------------------------------
    def node_info(self) -> dict:
        return {
            "node_id": self.node_id.hex(),
            "node_name": self.node_name,
            "alive": not self._dead,
            "resources": self.local_resources.to_float_dict("total"),
            "labels": dict(self.local_resources.labels),
        }

    def get_resource_report(self) -> dict:
        return {
            "available": self.local_resources.to_float_dict("available"),
            "total": self.local_resources.to_float_dict("total"),
            "load": {"queued": self.cluster_task_manager.num_queued(),
                     "dispatch": self.local_task_manager.num_queued()},
        }

    def update_resource_usage(self, batch: dict):
        """Apply a resource broadcast to the local (dirty) view.

        Batch format: ``{"rows": {node_id: usage}, "full": bool,
        "removed": [node_id], "suspect": [node_id] or absent}``.  A
        delta upserts its rows only; a full snapshot also prunes nodes
        absent from it; removals arrive in ``removed``; ``suspect``
        nodes (this one included) take no new placements until they
        leave the list."""
        if self._dead:
            return
        rows = batch.get("rows", batch)     # a plain dict is a full view
        is_full = batch.get("full", "rows" not in batch)
        removed = batch.get("removed", ())
        known = set(self.cluster_view.node_ids())
        for node_id, usage in rows.items():
            if node_id == self.node_id:
                continue
            if node_id in known and self._same_totals(node_id,
                                                      usage["total"]):
                self.cluster_view.update_available(node_id,
                                                   usage["available"])
                continue
            # A new node, or new totals (C.9): the whole row.
            nr = NodeResources(usage["total"])
            nr.available = {k: _quantize(v)
                            for k, v in usage["available"].items()}
            self.cluster_view.update_node(node_id, nr)
            self._peer_totals[node_id] = dict(usage["total"])
        gone = set(removed) & known
        if is_full:
            gone |= known - set(rows.keys()) - {self.node_id}
        for node_id in gone:
            self.cluster_view.remove_node(node_id)
            self._peer_totals.pop(node_id, None)
        suspect = batch.get("suspect")
        if suspect is not None:
            self.cluster_view.set_masked(set(suspect))
        self.cluster_task_manager.on_cluster_changed()

    def _same_totals(self, node_id, total: Dict[str, float]) -> bool:
        """Whether a broadcast row's totals are those the view holds for
        the known node ``node_id``: the last totals broadcast for it, or,
        for a row put in the view otherwise, the row's own."""
        last = self._peer_totals.get(node_id)
        if last is None:
            node = self.cluster_view.node_resources(node_id)
            held = {k: v for k, v in node.total.items() if v} \
                if node is not None else None
            if held != {k: _quantize(v) for k, v in total.items() if v}:
                return False
            last = self._peer_totals[node_id] = dict(total)
        return total == last

    def _record_spilled_url(self, object_id, url: str):
        """Spill callback: record the spilled_url with the owner's
        reference counter.  Posted to the loop, never run inline: the
        store calls this holding its lock, and the reference counter's
        delete path takes the store lock under its own (an ABBA
        deadlock between a spill and a last-ref drop)."""
        core = self.core_worker or self.cluster.core_worker
        if core is None:
            return
        self.loop.post(
            lambda: core.reference_counter.set_spilled_url(object_id, url),
            "raylet.record_spilled_url")

    # ---- lease protocol (NodeManagerService) ----------------------------
    def request_worker_lease(self, spec: TaskSpec, reply: Callable,
                             grant_or_reject: bool = False):
        """HandleRequestWorkerLease: ``reply`` fires once with a grant
        (``worker``/``raylet``), a spillback (``retry_at``) or a
        rejection.  A submitter that re-sends a lease to the raylet a
        spillback named passes ``grant_or_reject``: the lease is then
        granted here or rejected, never spilled again (a divergence
        from the reference, whose re-sent leases can be spilled back and
        forth between two raylets for ever: ``cluster_task_manager``)."""
        if self._dead:
            reply({"rejected": True, "reason": "node dead"})
            return
        self.lease_stats["lease_requests"] += 1
        self.cluster_task_manager.queue_and_schedule(spec, reply,
                                                     grant_or_reject)

    def request_worker_lease_batch(self, specs, reply: Callable):
        """Batched HandleRequestWorkerLease: ``reply`` fires once with
        ``{"results": [...]}`` ordered like ``specs``; each result is a
        grant, a spillback, a rejection or ``backlog`` (feasible but no
        capacity this tick; with ``infeasible: True`` when no node's
        totals fit)."""
        if self._dead:
            reply({"results": [{"rejected": True, "reason": "node dead"}
                               for _ in specs]})
            return
        self.lease_stats["lease_batch_requests"] += 1
        self.lease_stats["lease_batch_entries"] += len(specs)
        self.cluster_task_manager.queue_and_schedule_batch(specs, reply)

    def return_worker(self, worker, disconnect: bool = False):
        """HandleReturnWorker: release the lease and its resources."""
        self.local_task_manager.release_worker_resources(worker)
        if disconnect:
            worker.stop()
        else:
            self.worker_pool.push_worker(worker)
        # A freed worker slot may unblock the dispatch queue.
        self.loop.post(self.local_task_manager.dispatch, "local.dispatch")

    # ---- placement-group bundle 2PC (node_manager.proto:319-330) -------
    def prepare_bundle_resources(self, pg_id, idx: int,
                                 req: ResourceRequest) -> bool:
        """Phase 1: reserve the bundle's resources on this node, or
        refuse (False) when they are not available now or the node is
        dead.  Idempotent.  The reservation goes through the view's local
        row, under the view's lock, as the tick's own grants do."""
        if self._dead:
            return False
        key = (pg_id, idx)
        if key in self._prepared_bundles or key in self._committed_bundles:
            return True
        if not self.cluster_view.subtract(self.node_id, req):
            return False
        self._prepared_bundles[key] = req
        return True

    def commit_bundle_resources(self, pg_id, idx: int,
                                req: ResourceRequest) -> None:
        """Phase 2: add the bundle's formatted resources
        (``bundle_resource_names``) to this node, then retry the parked
        work: a task for the bundle may be waiting on them."""
        self._prepared_bundles.pop((pg_id, idx), None)
        self._committed_bundles[(pg_id, idx)] = req
        amounts = {name: _quantize(v) for name, v in
                   bundle_resource_names(pg_id, idx, req).items()}
        self._update_local(amounts, 1)
        self.cluster_task_manager.on_cluster_changed()

    def cancel_resource_reserve(self, pg_id, idx: int) -> None:
        """Roll back a prepared bundle, or return a committed one: its
        formatted resources leave the node and its base resources come
        back."""
        req = self._prepared_bundles.pop((pg_id, idx), None)
        if req is not None:
            self.cluster_view.add_back(self.node_id, req)
            return
        req = self._committed_bundles.pop((pg_id, idx), None)
        if req is None:
            return
        amounts = {name: _quantize(v) for name, v in
                   bundle_resource_names(pg_id, idx, req).items()}
        self._update_local(amounts, -1, release=req)
        self.cluster_task_manager.on_cluster_changed()

    def _update_local(self, amounts: Dict[str, int], sign: int,
                      release: Optional[ResourceRequest] = None) -> None:
        """Add (``sign`` 1) or take away (-1, never below 0; a name
        whose total reaches 0 leaves the node) ``amounts`` on this node's
        ledger, then ``release`` its request, and rebuild the view's
        local row.  The dictionaries are replaced, never resized in
        place: the broadcast thread reads them."""
        res = self.local_resources
        with self.cluster_view.lock:
            total, avail = dict(res.total), dict(res.available)
            for name, q in amounts.items():
                total[name] = max(0, total.get(name, 0) + sign * q)
                avail[name] = max(0, avail.get(name, 0) + sign * q)
                if total[name] == 0:
                    del total[name]
                    avail.pop(name, None)
            res.total, res.available = total, avail
            if release is not None:
                res.release(release)
            self.cluster_view.update_node(self.node_id, res)

    # ---- lifecycle ------------------------------------------------------
    def shutdown(self):
        if self._dead:
            return
        self._dead = True
        # The loop first: no tick may start a worker once the pool's
        # shutdown has taken its list of workers to stop and join.  The
        # pulls next, failing their waiters, so that no worker waits on
        # one; the spill thread before its store is emptied.
        self.loop.stop()
        self.object_manager.stop()
        self.worker_pool.shutdown()
        self.local_object_manager.stop()
        self.object_store.close()

    def debug_string(self) -> str:
        return (f"Raylet {self.node_name} ({self.node_id.hex()[:8]}): "
                f"res={self.local_resources.to_float_dict('available')} "
                f"queues={self.cluster_task_manager.debug_state()} "
                f"workers={self.worker_pool.num_total()} "
                f"objects={self.object_store.num_objects()}")
