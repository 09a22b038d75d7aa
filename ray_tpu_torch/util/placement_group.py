"""The public placement-group API.

A port of ``ray_tpu.util.placement_group`` (reference
``python/ray/util/placement_group.py``): ``placement_group(bundles,
strategy)``, ``PlacementGroup.ready()``/``wait()``,
``remove_placement_group``, ``get_placement_group`` (by name),
``placement_group_table`` and ``get_current_placement_group``, over the
placement-group manager of the driver's ``Cluster``.

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")
    pg.wait(10)
    f.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)).remote()
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.scheduler.resources import ResourceRequest


def _manager():
    return worker_mod.global_worker().cluster.gcs.placement_group_manager


def _ready_probe():
    return True


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        pg = _manager().get(self.id)
        return [b.to_dict() for b in pg.bundles] if pg else []

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """An ``ObjectRef`` sealed once the group is placed: a zero-CPU
        probe task in bundle 0."""
        from ray_tpu_torch.remote_function import RemoteFunction
        from ray_tpu_torch.util.scheduling_strategies import \
            PlacementGroupSchedulingStrategy
        rf = RemoteFunction(_ready_probe, dict(num_cpus=0, num_returns=1))
        return rf.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=self, placement_group_bundle_index=0)).remote()

    def wait(self, timeout_seconds: Optional[float] = 30.0) -> bool:
        return _manager().wait_ready(self.id, timeout_seconds)

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    w = worker_mod.global_worker()
    if not w.connected:
        worker_mod.init()
    if not bundles:
        raise ValueError("placement_group requires at least one bundle")
    for b in bundles:
        if not b or all(v == 0 for v in b.values()):
            raise ValueError(f"Invalid (empty) bundle: {b}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"Negative resources in bundle: {b}")
    from ray_tpu_torch.gcs.placement_group_manager import GcsPlacementGroup
    pg_id = PlacementGroupID.from_random()
    gcs_pg = GcsPlacementGroup(
        pg_id, [ResourceRequest(b) for b in bundles], strategy,
        name=name, lifetime=lifetime or "")
    w.cluster.gcs.placement_group_manager.create_placement_group(gcs_pg)
    return PlacementGroup(pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    _manager().remove_placement_group(pg.id)


def get_placement_group(name: str) -> PlacementGroup:
    gcs_pg = _manager().get_named(name)
    if gcs_pg is None:
        raise ValueError(f"Placement group {name!r} not found")
    return PlacementGroup(gcs_pg.pg_id)


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    table = _manager().table()
    if pg is not None:
        return table.get(pg.id.hex(), {})
    return table


def get_current_placement_group() -> Optional[PlacementGroup]:
    spec = worker_context.current_task_spec()
    if spec is None or spec.placement_group_id is None:
        return None
    return PlacementGroup(spec.placement_group_id)
