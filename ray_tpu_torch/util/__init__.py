"""Utilities of the port on top of its public API (reference
``ray_tpu.util``): placement groups and the scheduling strategies users
pass, and, loaded on first access, ``ActorPool``, ``Queue``,
``collective``, ``metrics``, ``iter``, ``queue``, ``multiprocessing`` and
``joblib`` (``dask`` is imported as ``ray_tpu_torch.util.dask``, as in
the reference); ``tracing`` belongs to the debug planes."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup, get_current_placement_group, get_placement_group,
    placement_group, placement_group_table, remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = [
    "placement_group", "remove_placement_group", "get_placement_group",
    "placement_group_table", "get_current_placement_group", "PlacementGroup",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "ActorPool",
]


def __getattr__(name):
    # Lazy submodule access for the heavier utilities.
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool
        return ActorPool
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue
        return Queue
    if name in ("collective", "metrics", "iter", "queue", "multiprocessing",
                "joblib"):
        import importlib
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
