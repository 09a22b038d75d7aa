"""An in-process cluster of the port's raylets.

``LocalCluster`` stands in for the GCS until the GCS is ported: it holds
the raylets of one process and does the resource broadcast that the
reference GCS does for in-process raylets (``GcsServer._poll_and_broadcast``
in ``ray_tpu/gcs/server.py``): a thread polls every raylet's
``get_resource_report()`` every
``gcs_resource_broadcast_period_milliseconds`` and sends each raylet the
full batch of rows, with the nodes removed since the last round.  It
also holds what the driver's runtime reads from the GCS: the function
table (the GCS KV's ``fn:`` rows, ``function_table``), the node table
(``nodes``, ``cluster_resources``, ``available_resources``) and the
object directory every raylet's pulls read (``object_directory``,
reference ``cluster.py:31``), and wires the driver's core worker into
every raylet (``attach_core_worker``).  ``remove_node`` delivers the
node's death as the reference's GCS does on an intentional shutdown: the
directory forgets the node's copies, the core worker reconstructs the
objects that lost their last one and the placement-group manager
reschedules the bundles the node held.

It also holds the GCS side of placement groups: a GCS-side resource view
(``resource_view``, the reference ``GcsResourceManager.view``) fed from
each broadcast round's rows as the reference's poll feeds it (a node's
row when it joins, its availability after that), the GCS event loop
(``loop``, thread ``ray_tpu_torch::gcs``) that the manager retries on,
the ``placement_group_table`` and the manager itself
(``placement_group_manager``, ``ray_tpu_torch.gcs``).

    cluster = LocalCluster(device="cpu")          # "cuda" by default
    head = cluster.add_node({"CPU": 4})
    cluster.add_node({"CPU": 8, "memory": 32})
    head.request_worker_lease_batch(specs, reply)
    ...
    cluster.shutdown()

The device is where the raylets' batched ticks and the placement-group
bundle solve run.

There is no heartbeat, so no node is ever suspect, and a node dies only
by ``remove_node`` (node death by missed heartbeats is ROADMAP A.4b.6).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.event_loop import EventLoop
from ray_tpu_torch._private.object_manager import ObjectDirectory
from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch.gcs.placement_group_manager import \
    GcsPlacementGroupManager
from ray_tpu_torch.scheduler.resources import (ClusterResourceView,
                                               NodeResources, _quantize)

logger = logging.getLogger(__name__)


class LocalCluster:
    def __init__(self, device=None):
        self.device = device
        self._lock = threading.Lock()
        # One broadcast round at a time, so that a stale round never
        # lands after a newer one.
        self._round_lock = threading.Lock()
        self._raylets: Dict = {}            # node_id -> Raylet, in join order
        self._removed_pending: List = []
        self._stop = threading.Event()
        self.core_worker = None
        self.function_table = FunctionTable()
        self.object_directory = ObjectDirectory()
        self.resource_view = ClusterResourceView()
        self.placement_group_table = Table()
        self.loop = EventLoop("gcs")
        self.placement_group_manager = GcsPlacementGroupManager(self)
        period = get_config().gcs_resource_broadcast_period_milliseconds
        self._thread = threading.Thread(
            target=self._broadcast_loop, args=(period / 1000.0,),
            daemon=True, name="ray_tpu_torch::resource_broadcast")
        self._thread.start()

    @property
    def head_node(self) -> Optional[Raylet]:
        with self._lock:
            return next(iter(self._raylets.values()), None)

    def raylets(self) -> List[Raylet]:
        with self._lock:
            return list(self._raylets.values())

    def raylet(self, node_id) -> Optional[Raylet]:
        with self._lock:
            return self._raylets.get(node_id)

    def add_node(self, resources: Dict[str, float], node_name: str = "",
                 labels: Optional[Dict] = None,
                 object_store_memory: Optional[int] = None) -> Raylet:
        """Start a raylet on this cluster's device, with a node store of
        ``object_store_memory`` bytes (the config's by default), and
        broadcast, so that every view holds the new node when this
        returns."""
        raylet = Raylet(self, resources, node_name=node_name, labels=labels,
                        device=self.device,
                        object_store_memory=object_store_memory)
        with self._lock:
            raylet.core_worker = self.core_worker
            self._raylets[raylet.node_id] = raylet
        self.broadcast_now()
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        """Stop the raylet, broadcast its removal, then deliver its
        death: the directory drops its copies and the core worker
        reconstructs the objects still referenced that lost their last
        copy (reference ``Cluster._on_node_death``)."""
        with self._lock:
            if self._raylets.pop(raylet.node_id, None) is None:
                return
            self._removed_pending.append(raylet.node_id)
            core = self.core_worker
        raylet.shutdown()
        self.broadcast_now()
        lost = self.object_directory.on_node_death(raylet.node_id)
        if core is not None:
            core.on_node_death(raylet.node_id, lost)
        self.placement_group_manager.on_node_death(raylet.node_id)

    def wait_for_nodes(self, count: int, timeout: float = 10.0) -> bool:
        """Whether ``count`` raylets are up within ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while len(self.raylets()) < count:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def attach_core_worker(self, core_worker) -> None:
        """Make ``core_worker`` the owner every raylet's tasks report to
        and read their object arguments from."""
        with self._lock:
            self.core_worker = core_worker
            for raylet in self._raylets.values():
                raylet.core_worker = core_worker

    # ---- the node table (the GCS's node and resource managers) ---------
    def nodes(self) -> List[dict]:
        return [raylet.node_info() for raylet in self.raylets()]

    def cluster_resources(self) -> Dict[str, float]:
        return _sum_rows(r.local_resources.to_float_dict("total")
                         for r in self.raylets())

    def available_resources(self) -> Dict[str, float]:
        """Read from each raylet's own ledger, as the reference reads
        in-process raylets (``live_available_resources``)."""
        return _sum_rows(r.local_resources.to_float_dict("available")
                         for r in self.raylets())

    def broadcast_now(self) -> None:
        """One synchronous poll-and-broadcast round."""
        with self._round_lock:
            with self._lock:
                raylets = list(self._raylets.items())
                removed, self._removed_pending = self._removed_pending, []
            rows = {node_id: raylet.get_resource_report()
                    for node_id, raylet in raylets}
            self._update_gcs_view(rows, removed)
            batch = {"rows": rows, "full": True, "removed": removed}
            for _node_id, raylet in raylets:
                raylet.update_resource_usage(batch)

    def _update_gcs_view(self, rows: Dict, removed: List) -> None:
        """The GCS-side view, as the reference's poll keeps it: a
        joining node's whole row, then its availability only."""
        view = self.resource_view
        for node_id in removed:
            view.remove_node(node_id)
        for node_id, usage in rows.items():
            if view.node_resources(node_id) is None:
                node = NodeResources(usage["total"])
                node.available = {k: _quantize(v)
                                  for k, v in usage["available"].items()}
                view.add_node(node_id, node)
            else:
                view.update_available(node_id, usage["available"])

    def _broadcast_loop(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            try:
                self.broadcast_now()
            except Exception:
                # The broadcaster must outlive one bad round; the next
                # round sends full rows again.
                logger.exception("resource broadcast round failed")

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.loop.stop()
        with self._lock:
            raylets = list(self._raylets.values())
            self._raylets.clear()
        for raylet in raylets:
            raylet.shutdown()


def _sum_rows(rows) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            out[k] = out.get(k, 0.0) + v
    return out


class Table:
    """A locked table of records by key (the GCS table storage's part
    the placement-group manager writes; the storage is ROADMAP A.4b.4)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict = {}

    def put(self, key, value) -> None:
        with self._lock:
            self._rows[key] = value

    def get(self, key):
        with self._lock:
            return self._rows.get(key)

    def get_all(self) -> List[tuple]:
        with self._lock:
            return list(self._rows.items())


class FunctionTable:
    """The function table: ``put``/``get`` of exported function blobs
    by key, the GCS KV's part that ``FunctionManager`` uses."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._rows:
                return False
            self._rows[key] = value
            return True

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._rows.get(key)
