"""GCS placement-group management: bundle packing and the two-phase
commit.

A port of ``ray_tpu.gcs.placement_group_manager`` (reference
``gcs_placement_group_manager.cc``: the pending queue and its retry,
``SchedulePendingPlacementGroups``; ``gcs_placement_group_scheduler.cc``:
PrepareResources, CommitResources and the rollback by
CancelResourceReserve), hung off the ``GcsServer``: the manager reads
the resource manager's view (``gcs.resource_manager.view``), retries on
the GCS loop (``gcs.loop``, every 50 ms), writes the placement-group
table of the GCS storage (``gcs.storage.placement_group_table``) and
reaches raylets through ``gcs.raylet(node_id)``.  ``reconcile`` rebuilds
the groups from that table after a GCS restart and releases the bundles
raylets hold for groups the table no longer has (ReleaseUnusedBundles).

The bundle-to-node solve is ``scheduler.bundle_packing.pack_bundles`` on
the cluster's device: the device bundle solve on a cluster of at least
``pg_kernel_min_nodes`` nodes, the greedy below.  A device failure is
counted in ``kernel_stats["kernel_errors"]`` and raised (ROADMAP C.2): it
fails the loop's handler, which logs and counts it
(``handler_stats["pg.tick"]["errors"]``), and the group stays pending.
The ``ray_tpu.pg.bundle_packing.*`` collector exports those counters.

Where the reference notes a dropped ready callback on its debug plane
(``swallow.noted``, ROADMAP A.4b.7), this manager logs it and counts it
in ``stats["ready_callback_errors"]``, and a failed release in
``reconcile`` in ``stats["reconcile_cancel_errors"]``.

Divergence: a group removed while its two-phase commit runs on the loop
returns the bundles it just committed (the reference would mark it
CREATED again and keep them).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch.scheduler import bundle_packing
from ray_tpu_torch.scheduler.resources import ResourceRequest

logger = logging.getLogger(__name__)


class PlacementStrategy:
    PACK = "PACK"
    SPREAD = "SPREAD"
    STRICT_PACK = "STRICT_PACK"
    STRICT_SPREAD = "STRICT_SPREAD"


class PlacementGroupState:
    PENDING = "PENDING"
    PREPARED = "PREPARED"
    CREATED = "CREATED"
    RESCHEDULING = "RESCHEDULING"
    REMOVED = "REMOVED"


class GcsPlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[ResourceRequest], strategy: str,
                 name: str = "", lifetime: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.lifetime = lifetime
        self.state = PlacementGroupState.PENDING
        # bundle index -> NodeID once placed.
        self.bundle_nodes: Dict[int, NodeID] = {}
        self.create_time = time.time()

    def info(self) -> dict:
        return {
            "placement_group_id": self.pg_id.hex(),
            "name": self.name,
            "strategy": self.strategy,
            "state": self.state,
            "bundles": [b.to_dict() for b in self.bundles],
            "bundle_nodes": {i: n.hex() for i, n in self.bundle_nodes.items()},
        }


def _collect(_manager) -> None:
    for k, v in bundle_packing.kernel_stats.items():
        record_internal(f"ray_tpu.pg.bundle_packing.{k}", v)


class GcsPlacementGroupManager:
    def __init__(self, gcs):
        self._gcs = gcs
        self._lock = threading.RLock()
        # State-change wakeups for wait_ready (no polling).
        self._state_cond = threading.Condition(self._lock)
        self._groups: Dict[PlacementGroupID, GcsPlacementGroup] = {}
        self._named: Dict[str, PlacementGroupID] = {}
        self._pending: List[PlacementGroupID] = []
        self._ready_callbacks: Dict[PlacementGroupID, list] = {}
        self.stats = {"ready_callback_errors": 0,
                      "reconcile_cancel_errors": 0}
        # Retry cadence for pending groups (SchedulePendingPlacementGroups).
        gcs.loop.schedule_every(0.05, self._schedule_pending, "pg.tick")
        get_metrics_registry().register_collector(self, _collect)

    # ---- API ------------------------------------------------------------
    def create_placement_group(self, pg: GcsPlacementGroup, ready_cb=None):
        with self._lock:
            if pg.name:
                if pg.name in self._named:
                    raise ValueError(f"Placement group name {pg.name!r} taken")
                self._named[pg.name] = pg.pg_id
            self._groups[pg.pg_id] = pg
            self._pending.append(pg.pg_id)
            if ready_cb:
                self._ready_callbacks.setdefault(pg.pg_id, []).append(ready_cb)
            self._gcs.storage.placement_group_table.put(pg.pg_id, pg.info())
        self._gcs.loop.post(self._schedule_pending, "pg.schedule")
        return pg

    def remove_placement_group(self, pg_id: PlacementGroupID):
        with self._lock:
            pg = self._groups.get(pg_id)
            if pg is None:
                return
            pg.state = PlacementGroupState.REMOVED
            self._state_cond.notify_all()
            if pg.name:
                self._named.pop(pg.name, None)
            if pg_id in self._pending:
                self._pending.remove(pg_id)
            placed = dict(pg.bundle_nodes)
            pg.bundle_nodes = {}
            self._gcs.storage.placement_group_table.put(pg_id, pg.info())
        self._cancel(pg_id, placed.items())

    def get(self, pg_id: PlacementGroupID) -> Optional[GcsPlacementGroup]:
        with self._lock:
            return self._groups.get(pg_id)

    def get_named(self, name: str) -> Optional[GcsPlacementGroup]:
        with self._lock:
            pg_id = self._named.get(name)
            return self._groups.get(pg_id) if pg_id else None

    def table(self) -> dict:
        with self._lock:
            return {pg_id.hex(): pg.info() for pg_id, pg in self._groups.items()}

    def pending_groups(self) -> List[GcsPlacementGroup]:
        """The groups waiting for placement, in queue order (the
        autoscaler's monitor reads them)."""
        with self._lock:
            return [self._groups[pg_id] for pg_id in self._pending
                    if pg_id in self._groups]

    def wait_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._state_cond:
            while True:
                pg = self._groups.get(pg_id)
                if pg is not None and pg.state == PlacementGroupState.CREATED:
                    return True
                if pg is None or pg.state == PlacementGroupState.REMOVED:
                    return False
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._state_cond.wait(timeout=remaining)

    # ---- scheduling (ScheduleUnplacedBundles) ---------------------------
    def _schedule_pending(self):
        with self._lock:
            pending = list(self._pending)
        for pg_id in pending:
            with self._lock:
                pg = self._groups.get(pg_id)
                if pg is None or pg.state not in (PlacementGroupState.PENDING,
                                                  PlacementGroupState.RESCHEDULING):
                    if pg_id in self._pending:
                        self._pending.remove(pg_id)
                    continue
            if self._try_place(pg):
                with self._lock:
                    if pg_id in self._pending:
                        self._pending.remove(pg_id)

    def _try_place(self, pg: GcsPlacementGroup) -> bool:
        view = self._gcs.resource_manager.view
        unplaced = [i for i in range(len(pg.bundles))
                    if i not in pg.bundle_nodes]
        if not unplaced:
            return True
        exclude = set(pg.bundle_nodes.values()) \
            if pg.strategy == PlacementStrategy.STRICT_SPREAD else set()
        assignment = bundle_packing.pack_bundles(
            view, [pg.bundles[i] for i in unplaced], pg.strategy,
            exclude_nodes=exclude, device=self._gcs.device)
        if assignment is None:
            return False
        placement = {unplaced[j]: node for j, node in enumerate(assignment)}
        # --- phase 1: prepare on all involved raylets ---
        prepared: List[tuple] = []
        for idx, node_id in placement.items():
            raylet = self._gcs.raylet(node_id)
            if raylet is None or not raylet.prepare_bundle_resources(
                    pg.pg_id, idx, pg.bundles[idx]):
                # The view lagged the raylet: roll back, retry next tick.
                self._cancel(pg.pg_id, prepared)
                return False
            prepared.append((idx, node_id))
        # --- phase 2: commit ---
        for idx, node_id in prepared:
            self._gcs.raylet(node_id).commit_bundle_resources(
                pg.pg_id, idx, pg.bundles[idx])
        with self._lock:
            if pg.state == PlacementGroupState.REMOVED:
                removed = True
            else:
                removed = False
                pg.bundle_nodes.update(placement)
                pg.state = PlacementGroupState.CREATED
                self._state_cond.notify_all()
                self._gcs.storage.placement_group_table.put(pg.pg_id, pg.info())
            callbacks = self._ready_callbacks.pop(pg.pg_id, [])
        if removed:
            self._cancel(pg.pg_id, prepared)
            return True
        for cb in callbacks:
            try:
                cb(pg)
            except Exception:
                # A dropped ready callback strands its waiter.
                self.stats["ready_callback_errors"] += 1
                logger.exception("placement group %s: ready callback "
                                 "failed", pg.pg_id.hex())
        return True

    def _cancel(self, pg_id: PlacementGroupID, bundles) -> None:
        """Return ``bundles`` ((index, node id) pairs) to their raylets."""
        for idx, node_id in bundles:
            raylet = self._gcs.raylet(node_id)
            if raylet is not None:
                raylet.cancel_resource_reserve(pg_id, idx)

    # ---- GCS-restart reconciliation (gcs_init_data.cc and
    # ReleaseUnusedBundles, node_manager.proto:312-355) ------------------
    def reconcile(self, raylets):
        """Rebuild the groups from the durable table after a GCS
        restart: a bundle still committed on a surviving raylet is
        adopted, a lost one is placed again, and a bundle a raylet holds
        for a group the table does not have (or has as removed) is
        released."""
        live_nodes = {r.node_id: r for r in raylets}
        for key, record in \
                self._gcs.storage.placement_group_table.get_all():
            pg_id = key if isinstance(key, PlacementGroupID) \
                else PlacementGroupID(key)
            if record.get("state") == PlacementGroupState.REMOVED:
                continue
            bundles = [ResourceRequest(b) for b in record.get("bundles", [])]
            pg = GcsPlacementGroup(pg_id, bundles,
                                   record.get("strategy",
                                              PlacementStrategy.PACK),
                                   name=record.get("name", ""))
            lost = False
            for idx_str, node_hex in record.get("bundle_nodes",
                                                {}).items():
                idx = int(idx_str)
                node_id = NodeID.from_hex(node_hex)
                raylet = live_nodes.get(node_id)
                if raylet is not None and \
                        (pg_id, idx) in raylet._committed_bundles:
                    pg.bundle_nodes[idx] = node_id
                else:
                    lost = True
            with self._lock:
                if len(pg.bundle_nodes) == len(pg.bundles) and not lost:
                    pg.state = PlacementGroupState.CREATED
                else:
                    pg.state = PlacementGroupState.RESCHEDULING
                    if pg_id not in self._pending:
                        self._pending.append(pg_id)
                self._groups[pg_id] = pg
                if pg.name:
                    self._named[pg.name] = pg_id
                self._state_cond.notify_all()
        # ReleaseUnusedBundles: bundles raylets hold for groups that no
        # longer exist leaked through the outage.
        for raylet in raylets:
            held = dict(raylet._committed_bundles)
            held.update(raylet._prepared_bundles)
            for (pg_id, idx) in held:
                with self._lock:
                    pg = self._groups.get(pg_id)
                    keep = pg is not None and \
                        pg.state != PlacementGroupState.REMOVED
                if keep:
                    continue
                try:
                    raylet.cancel_resource_reserve(pg_id, idx)
                except Exception:
                    # A leaked bundle shrinks its node for good.
                    self.stats["reconcile_cancel_errors"] += 1
                    logger.exception("placement group %s: release of "
                                     "bundle %d failed", pg_id.hex(), idx)
        self._gcs.loop.post(self._schedule_pending, "pg.reconcile")

    # ---- failure handling ----------------------------------------------
    def on_node_death(self, node_id: NodeID):
        with self._lock:
            affected = []
            for pg in self._groups.values():
                lost = [i for i, n in pg.bundle_nodes.items() if n == node_id]
                if lost and pg.state != PlacementGroupState.REMOVED:
                    for i in lost:
                        del pg.bundle_nodes[i]
                    pg.state = PlacementGroupState.RESCHEDULING
                    self._state_cond.notify_all()
                    affected.append(pg.pg_id)
            for pg_id in affected:
                if pg_id not in self._pending:
                    self._pending.append(pg_id)
        if affected:
            self._gcs.loop.post(self._schedule_pending, "pg.reschedule")
