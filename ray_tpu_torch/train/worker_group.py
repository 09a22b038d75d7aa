"""WorkerGroup: a gang of actors that execute functions in lockstep.

A copy of ``ray_tpu.train.worker_group`` for the PyTorch port (reference
``python/ray/train/worker_group.py``): ``WorkerGroup`` creates
``num_workers`` actors, by default in a PACK placement group (gang
scheduling), and offers ``execute``/``execute_async`` (all workers) and
``execute_single`` (one worker).  A worker's device share is
``num_gpus_per_worker`` of the ``"GPU"`` resource, where the reference
takes ``num_tpus_per_worker`` of ``"TPU"`` (ROADMAP C.24); a fraction
puts several workers on one card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy


class _ExecutableActor:
    """Generic actor that runs arbitrary callables (BaseWorkerMixin)."""

    def __init__(self):
        self._state: Dict[str, Any] = {}

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)


class WorkerGroup:
    def __init__(self, num_workers: int = 1,
                 num_cpus_per_worker: float = 1,
                 num_gpus_per_worker: float = 0,
                 additional_resources_per_worker: Optional[Dict] = None,
                 use_placement_group: bool = True):
        if num_workers <= 0:
            raise ValueError("num_workers must be positive")
        self.num_workers = num_workers
        resources = dict(additional_resources_per_worker or {})
        self._pg = None
        options: Dict[str, Any] = dict(
            num_cpus=num_cpus_per_worker, resources=resources or None)
        if num_gpus_per_worker:
            options["num_gpus"] = num_gpus_per_worker
        if use_placement_group:
            bundle = {"CPU": num_cpus_per_worker}
            if num_gpus_per_worker:
                bundle["GPU"] = num_gpus_per_worker
            bundle.update(resources)
            self._pg = placement_group([dict(bundle)] * num_workers,
                                       strategy="PACK")
            ray_tpu_torch.get(self._pg.ready())
            options["scheduling_strategy"] = \
                PlacementGroupSchedulingStrategy(self._pg)
        cls = ray_tpu_torch.remote(**{k: v for k, v in options.items()
                                      if v is not None})(_ExecutableActor)
        self.workers = []
        for i in range(num_workers):
            if self._pg is not None:
                cls_i = cls.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        self._pg, placement_group_bundle_index=i))
                self.workers.append(cls_i.remote())
            else:
                self.workers.append(cls.remote())

    def __len__(self):
        return len(self.workers)

    def execute_async(self, fn: Callable, *args, **kwargs) -> List:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single_async(self, rank: int, fn: Callable, *args, **kwargs):
        return self.workers[rank].execute.remote(fn, *args, **kwargs)

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(self.execute_single_async(rank, fn, *args,
                                                           **kwargs))

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — the actor may be gone
                pass
        self.workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001 — the group may be gone
                pass
            self._pg = None
