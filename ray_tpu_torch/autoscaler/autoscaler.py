"""StandardAutoscaler: the update loop that launches and terminates
nodes.

A port of ``ray_tpu.autoscaler.autoscaler`` (reference
``python/ray/autoscaler/_private/autoscaler.py``, ``update``): each round
(1) lists the provider's non-terminated worker nodes, (2) terminates the
workers past ``max_workers`` and those idle longer than
``idle_timeout_minutes`` (down to each type's ``min_workers``), (3) asks
the ``ResourceDemandScheduler`` what to launch (``nodes_to_launch``) and
(4) launches it through the provider, synchronously.  The scheduler's
pack-mode solves run on ``device``: the card unless the caller passes
``"cpu"``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics
from ray_tpu_torch.autoscaler.node_provider import (
    NODE_KIND_WORKER, NodeProvider, STATUS_UP_TO_DATE, TAG_NODE_KIND,
    TAG_NODE_STATUS, TAG_NODE_TYPE)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import \
    ResourceDemandScheduler

logger = logging.getLogger(__name__)


class StandardAutoscaler:
    def __init__(self, provider: NodeProvider,
                 load_metrics: LoadMetrics,
                 node_types: Dict[str, dict],
                 max_workers: int = 10,
                 head_node_type: str = "head",
                 idle_timeout_minutes: float = 5.0,
                 upscaling_speed: float = 1.0,
                 device=None):
        self.provider = provider
        self.load_metrics = load_metrics
        self.node_types = node_types
        self.max_workers = max_workers
        self.head_node_type = head_node_type
        self.idle_timeout_s = idle_timeout_minutes * 60.0
        self.resource_demand_scheduler = ResourceDemandScheduler(
            node_types, max_workers, head_node_type, upscaling_speed,
            device=device)
        # node_id -> time it was last seen busy.
        self.last_used_time_by_node: Dict[str, float] = {}
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------------
    def workers(self) -> List[str]:
        return self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: NODE_KIND_WORKER})

    def _node_type_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for nid in self.provider.non_terminated_nodes({}):
            t = self.provider.node_tags(nid).get(TAG_NODE_TYPE)
            if t:
                counts[t] = counts.get(t, 0) + 1
        return counts

    def _is_idle(self, node_id: str, now: float) -> bool:
        ip = self.provider.internal_ip(node_id)
        static = self.load_metrics.static_resources_by_ip.get(ip)
        avail = self.load_metrics.dynamic_resources_by_ip.get(ip)
        if static is None or avail is None:
            return False  # no data yet: don't kill it
        busy = any(avail.get(k, 0) < v for k, v in static.items())
        if busy:
            self.last_used_time_by_node[node_id] = now
            return False
        last_used = self.last_used_time_by_node.setdefault(node_id, now)
        return (now - last_used) > self.idle_timeout_s

    # ------------------------------------------------------------------
    def update(self) -> Dict[str, int]:
        """One round; returns what it launched, {node type: count}."""
        self._terminate(time.time())
        to_launch = self.nodes_to_launch()
        for node_type, count in to_launch.items():
            logger.info("Launching %d x %s", count, node_type)
            self.provider.create_node(
                self.node_types[node_type],
                {TAG_NODE_KIND: NODE_KIND_WORKER,
                 TAG_NODE_TYPE: node_type,
                 TAG_NODE_STATUS: STATUS_UP_TO_DATE},
                count)
            self.num_launches += count
        return to_launch

    def _terminate(self, now: float) -> None:
        workers = self.workers()
        # Over-the-cap workers (newest first).
        if len(workers) > self.max_workers:
            for nid in workers[self.max_workers:]:
                logger.info("Terminating %s: max_workers exceeded", nid)
                self.provider.terminate_node(nid)
                self.num_terminations += 1
            workers = self.workers()
        # Idle workers, respecting each type's min_workers.
        counts = self._node_type_counts()
        for nid in workers:
            node_type = self.provider.node_tags(nid).get(TAG_NODE_TYPE)
            min_w = self.node_types.get(node_type, {}).get("min_workers", 0)
            if counts.get(node_type, 0) <= min_w:
                continue
            if self._is_idle(nid, now):
                logger.info("Terminating %s: idle", nid)
                ip = self.provider.internal_ip(nid)
                self.provider.terminate_node(nid)
                counts[node_type] -= 1
                self.num_terminations += 1
                # Drop the dead node's resources at once, so that this
                # round's bin-pack places no demand on it.
                with self.load_metrics.lock:
                    self.load_metrics.static_resources_by_ip.pop(ip, None)
                    self.load_metrics.dynamic_resources_by_ip.pop(ip, None)

    def nodes_to_launch(self) -> Dict[str, int]:
        """What the demand solve would launch now, from the provider's
        nodes and the load metrics (step 3; it changes nothing)."""
        counts = self._node_type_counts()
        to_launch, _ = self.resource_demand_scheduler.get_nodes_to_launch(
            counts, self._pending_launches(counts),
            self.load_metrics.get_resource_demand_vector(),
            dict(self.load_metrics.dynamic_resources_by_ip),
            self.load_metrics.get_pending_placement_groups(),
            ensure_min_cluster_size=self.load_metrics.get_resource_requests())
        return to_launch

    def _pending_launches(self, counts: Dict[str, int]) -> Dict[str, int]:
        # Synchronous providers have no in-flight launches; subclasses /
        # async providers can override.
        return {}

    def summary(self) -> dict:
        return {
            "workers": len(self.workers()),
            "node_type_counts": self._node_type_counts(),
            "launches": self.num_launches,
            "terminations": self.num_terminations,
            "resources": self.load_metrics.resources_avail_summary(),
        }
