"""Monitor: the bridge from the live cluster to the autoscaler.

A port of ``ray_tpu.autoscaler.monitor`` (reference
``python/ray/autoscaler/_private/monitor.py``): each round reads every
raylet's resource report and pending demand
(``cluster_task_manager.resource_load()``) and the placement-group
manager's pending groups into ``LoadMetrics`` (``update_load_metrics``),
then runs ``StandardAutoscaler.update`` (``update_all``).  It attaches to
a ``LocalCluster``; ``start(interval_s)`` runs the rounds on a thread of
its own (``ray_tpu_torch::autoscaler_monitor``), which ``stop()`` joins;
tests tick it by hand.  ``device`` is where the autoscaler's pack-mode
solves run: the card unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from ray_tpu_torch.autoscaler import sdk
from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics
from ray_tpu_torch.autoscaler.node_provider import FakeMultiNodeProvider

logger = logging.getLogger(__name__)


class Monitor:
    def __init__(self, cluster, node_types: Dict[str, dict],
                 max_workers: int = 10,
                 idle_timeout_minutes: float = 5.0,
                 upscaling_speed: float = 1.0,
                 provider=None, device=None):
        self.cluster = cluster
        self.load_metrics = LoadMetrics()
        self.provider = provider or FakeMultiNodeProvider(cluster, node_types)
        self.autoscaler = StandardAutoscaler(
            self.provider, self.load_metrics, node_types,
            max_workers=max_workers,
            idle_timeout_minutes=idle_timeout_minutes,
            upscaling_speed=upscaling_speed, device=device)
        self.rounds = 0
        self.round_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        sdk._set_active_monitor(self)

    # ------------------------------------------------------------------
    def update_load_metrics(self):
        """Pull resource reports and pending demand from every raylet and
        the pending groups from the placement-group manager (reference
        ``Monitor.update_load_metrics``)."""
        demands = []
        raylets = self.cluster.raylets()
        for raylet in raylets:
            report = raylet.get_resource_report()
            ip = raylet.node_id.hex()[:12]
            demands.extend(raylet.cluster_task_manager.resource_load())
            self.load_metrics.update(ip, report["total"], report["available"])
        pending_pgs = [
            {"strategy": pg.strategy,
             "bundles": [b.to_dict() for b in pg.bundles]}
            for pg in self.cluster.placement_group_manager.pending_groups()]
        with self.load_metrics.lock:
            self.load_metrics.pending_demands = demands
            self.load_metrics.pending_placement_groups = pending_pgs
        self.load_metrics.prune_active_ips(
            [r.node_id.hex()[:12] for r in raylets])

    def update_all(self):
        """One full monitor round: refresh the metrics, run the
        autoscaler; returns what it launched."""
        self.update_load_metrics()
        self.rounds += 1
        return self.autoscaler.update()

    # ------------------------------------------------------------------
    def start(self, interval_s: float = 5.0):
        """Run a round every ``interval_s`` seconds until ``stop``.  A
        failed round is logged and counted (``round_errors``) and the
        next one runs."""
        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.update_all()
                except Exception:
                    self.round_errors += 1
                    logger.exception("autoscaler monitor round failed")

        self._stop.clear()
        self._thread = threading.Thread(
            target=run, daemon=True,
            name="ray_tpu_torch::autoscaler_monitor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=30)
        self._thread = None
        sdk._clear_active_monitor(self)
