"""Autoscaler SDK: programmatic resource requests.

A port of ``ray_tpu.autoscaler.sdk`` (reference
``python/ray/autoscaler/sdk.py``): ``request_resources(num_cpus=...,
bundles=[...])`` asks the autoscaler to keep the cluster able to fit the
given shapes whatever the current demand (``ensure_min_cluster_size``);
an empty request withdraws the last one.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# The live monitor registers itself here when it is made (in-process
# cluster) and leaves when it stops.
_active_monitor = None


def _set_active_monitor(monitor):
    global _active_monitor
    _active_monitor = monitor


def _clear_active_monitor(monitor):
    global _active_monitor
    if _active_monitor is monitor:
        _active_monitor = None


def request_resources(num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None):
    demands: List[Dict[str, float]] = []
    if num_cpus:
        demands.extend([{"CPU": 1}] * int(num_cpus))
    if bundles:
        demands.extend(dict(b) for b in bundles)
    if _active_monitor is None:
        raise RuntimeError(
            "No autoscaler monitor is running; start one via "
            "ray_tpu_torch.autoscaler.Monitor(cluster, node_types)")
    _active_monitor.load_metrics.set_resource_requests(demands)
