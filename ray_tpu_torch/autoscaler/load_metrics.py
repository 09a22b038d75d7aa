"""LoadMetrics: the autoscaler's eventually-consistent view of cluster load.

A copy of ``ray_tpu.autoscaler.load_metrics`` for the PyTorch port, with
a plain ``threading.RLock`` in place of the lock-order witness.

Parity: reference ``python/ray/autoscaler/_private/load_metrics.py`` —
per-node static/available resource dicts keyed by ip, pending resource
demands from the scheduler, pending placement groups, explicit
``request_resources`` asks, and activity pruning for dead ips.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class LoadMetrics:
    def __init__(self):
        self.lock = threading.RLock()
        self.last_heartbeat_by_ip: Dict[str, float] = {}
        self.static_resources_by_ip: Dict[str, Dict[str, float]] = {}
        self.dynamic_resources_by_ip: Dict[str, Dict[str, float]] = {}
        self.pending_demands: List[Dict[str, float]] = []
        self.pending_placement_groups: List[dict] = []
        self.resource_requests: List[Dict[str, float]] = []

    def update(self, ip: str, static_resources: Dict[str, float],
               dynamic_resources: Dict[str, float],
               pending_demands: Optional[List[Dict[str, float]]] = None,
               pending_placement_groups: Optional[List[dict]] = None):
        with self.lock:
            self.static_resources_by_ip[ip] = dict(static_resources)
            self.dynamic_resources_by_ip[ip] = dict(dynamic_resources)
            self.last_heartbeat_by_ip[ip] = time.time()
            if pending_demands is not None:
                self.pending_demands = list(pending_demands)
            if pending_placement_groups is not None:
                self.pending_placement_groups = list(pending_placement_groups)

    def mark_active(self, ip: str):
        with self.lock:
            self.last_heartbeat_by_ip[ip] = time.time()

    def is_active(self, ip: str) -> bool:
        with self.lock:
            return ip in self.last_heartbeat_by_ip

    def prune_active_ips(self, active_ips: List[str]):
        """Drop state for ips no longer in the cluster (reference
        ``LoadMetrics.prune_active_ips``)."""
        active = set(active_ips)
        with self.lock:
            for mapping in (self.last_heartbeat_by_ip,
                            self.static_resources_by_ip,
                            self.dynamic_resources_by_ip):
                for ip in list(mapping):
                    if ip not in active:
                        del mapping[ip]

    def get_node_resources(self) -> List[Dict[str, float]]:
        with self.lock:
            return list(self.static_resources_by_ip.values())

    def get_static_node_resources_by_ip(self) -> Dict[str, Dict[str, float]]:
        with self.lock:
            return dict(self.static_resources_by_ip)

    def get_resource_demand_vector(self, clip: bool = True,
                                   max_len: int = 1000):
        with self.lock:
            demands = list(self.pending_demands)
        return demands[:max_len] if clip else demands

    def get_pending_placement_groups(self) -> List[dict]:
        with self.lock:
            return list(self.pending_placement_groups)

    def set_resource_requests(self, requested: List[Dict[str, float]]):
        with self.lock:
            self.resource_requests = [dict(r) for r in requested if r]

    def get_resource_requests(self) -> List[Dict[str, float]]:
        with self.lock:
            return [dict(r) for r in self.resource_requests]

    def resources_avail_summary(self) -> str:
        with self.lock:
            total: Dict[str, float] = {}
            avail: Dict[str, float] = {}
            for res in self.static_resources_by_ip.values():
                for k, v in res.items():
                    total[k] = total.get(k, 0) + v
            for res in self.dynamic_resources_by_ip.values():
                for k, v in res.items():
                    avail[k] = avail.get(k, 0) + v
        return ", ".join(f"{avail.get(k, 0):g}/{total[k]:g} {k}"
                         for k in sorted(total))
