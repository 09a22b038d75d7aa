"""User-facing scheduling strategies.

A copy of ``ray_tpu.util.scheduling_strategies`` for the PyTorch port.

Parity: reference ``python/ray/util/scheduling_strategies.py`` —
"DEFAULT"/"SPREAD" strings, PlacementGroupSchedulingStrategy,
NodeAffinitySchedulingStrategy.
"""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: Optional[bool] = None):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = \
            placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        # Accept hex string or NodeID.
        self.node_id = node_id
        self.soft = soft


SchedulingStrategyT = object  # "DEFAULT" | "SPREAD" | strategy instance
