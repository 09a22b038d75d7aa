"""An in-process cluster of the port's raylets.

``LocalCluster`` stands in for the GCS until the GCS is ported: it holds
the raylets of one process and does the resource broadcast that the
reference GCS does for in-process raylets (``GcsServer._poll_and_broadcast``
in ``ray_tpu/gcs/server.py``): a thread polls every raylet's
``get_resource_report()`` every
``gcs_resource_broadcast_period_milliseconds`` and sends each raylet the
full batch of rows, with the nodes removed since the last round.

    cluster = LocalCluster(device="cpu")          # "cuda" by default
    head = cluster.add_node({"CPU": 4})
    cluster.add_node({"CPU": 8, "memory": 32})
    head.request_worker_lease_batch(specs, reply)
    ...
    cluster.shutdown()

There is no heartbeat, so no node is ever suspect.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.raylet import Raylet

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
                 labels: Optional[Dict] = None) -> Raylet:
        """Start a raylet on this cluster's device and broadcast, so
        that every view holds the new node when this returns."""
        raylet = Raylet(self, resources, node_name=node_name, labels=labels,
                        device=self.device)
        with self._lock:
            self._raylets[raylet.node_id] = raylet
        self.broadcast_now()
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        with self._lock:
            if self._raylets.pop(raylet.node_id, None) is None:
                return
            self._removed_pending.append(raylet.node_id)
        raylet.shutdown()
        self.broadcast_now()

    def broadcast_now(self) -> None:
        """One synchronous poll-and-broadcast round."""
        with self._round_lock:
            with self._lock:
                raylets = list(self._raylets.items())
                removed, self._removed_pending = self._removed_pending, []
            rows = {node_id: raylet.get_resource_report()
                    for node_id, raylet in raylets}
            batch = {"rows": rows, "full": True, "removed": removed}
            for _node_id, raylet in raylets:
                raylet.update_resource_usage(batch)

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
        with self._lock:
            raylets = list(self._raylets.values())
            self._raylets.clear()
        for raylet in raylets:
            raylet.shutdown()
