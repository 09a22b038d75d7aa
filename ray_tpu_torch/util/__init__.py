"""Utilities of the port: placement groups and the scheduling strategies
users pass (reference ``ray_tpu.util``; its other utilities come with
the libraries, ROADMAP A.6)."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup, get_current_placement_group, get_placement_group,
    placement_group, placement_group_table, remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = [
    "placement_group", "remove_placement_group", "get_placement_group",
    "placement_group_table", "get_current_placement_group", "PlacementGroup",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
]
