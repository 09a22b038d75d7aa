"""The per-node daemon's scheduling plane.

A port of the scheduling half of ``ray_tpu._private.raylet.Raylet`` for
the PyTorch port: the node's resources and its dirty view of the
cluster, the event loop with the periodic scheduling tick, the worker
pool, the local and cluster task managers, the lease protocol
(``request_worker_lease``, ``request_worker_lease_batch``,
``return_worker``) and the resource broadcast's receiving end
(``update_resource_usage``).

The reference raylet's heartbeat thread, object store, spill manager
and placement-group bundle two-phase commit belong to planes the port
does not have yet; its resource report carries no host statistics and
no transfer load, which belong to the object plane.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ray_tpu_torch._private.cluster_task_manager import ClusterTaskManager
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.event_loop import EventLoop
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.local_task_manager import LocalTaskManager
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch._private.worker_pool import WorkerPool
from ray_tpu_torch.scheduler.resources import (ClusterResourceView,
                                               NodeResources, _quantize)


class Raylet:
    """One node's scheduler.  ``device`` is where its batched tick runs:
    the card unless the caller passes ``"cpu"``; it is resolved here
    when ``scheduler_backend`` is ``"torch"``, so a raylet without a
    card raises at construction."""

    def __init__(self, cluster, resources: Dict[str, float],
                 node_name: str = "", labels: Optional[Dict] = None,
                 device=None):
        cfg = get_config()
        self.device = resolve_device(device) \
            if cfg.scheduler_backend == "torch" else device
        self.cluster = cluster
        self.node_id = NodeID.from_random()
        self.node_name = node_name or f"node-{self.node_id.hex()[:8]}"
        self.local_resources = NodeResources(resources, labels=labels)
        self.cluster_view = ClusterResourceView()   # local (dirty) view
        self.loop = EventLoop(f"raylet-{self.node_id.hex()[:6]}")
        self.worker_pool = WorkerPool(self)
        self.local_task_manager = LocalTaskManager(self)
        # Lease-protocol round-trip counters, rendered by the tick
        # collector.
        self.lease_stats = {"lease_requests": 0,
                            "lease_batch_requests": 0,
                            "lease_batch_entries": 0}
        self.cluster_task_manager = ClusterTaskManager(self)
        self._dead = False
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
            if node_id not in known:
                nr = NodeResources(usage["total"])
                nr.available = {k: _quantize(v)
                                for k, v in usage["available"].items()}
                self.cluster_view.add_node(node_id, nr)
                self.cluster_task_manager.on_cluster_changed()
            else:
                self.cluster_view.update_available(node_id,
                                                   usage["available"])
        gone = set(removed) & known
        if is_full:
            gone |= known - set(rows.keys()) - {self.node_id}
        for node_id in gone:
            self.cluster_view.remove_node(node_id)
        suspect = batch.get("suspect")
        if suspect is not None:
            self.cluster_view.set_masked(set(suspect))
        self.cluster_task_manager.on_cluster_changed()

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

    # ---- lifecycle ------------------------------------------------------
    def shutdown(self):
        if self._dead:
            return
        self._dead = True
        self.worker_pool.shutdown()
        self.loop.stop()

    def debug_string(self) -> str:
        return (f"Raylet {self.node_name} ({self.node_id.hex()[:8]}): "
                f"res={self.local_resources.to_float_dict('available')} "
                f"queues={self.cluster_task_manager.debug_state()} "
                f"workers={self.worker_pool.num_total()}")
