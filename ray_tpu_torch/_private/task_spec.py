"""TaskSpecification + SchedulingClass interning.

A copy of ``ray_tpu._private.task_spec`` for the PyTorch port, over the
port's own policy and resource types, with a plain ``threading.Lock`` in
place of the lock-order witness.  The interning table is the port's own:
its integers differ from the reference's for the same shapes, while the
order in which classes first appear is what the batched solve keys on.

Parity: reference ``src/ray/common/task/task_spec.h:197`` (TaskSpecification)
and ``:297`` (SchedulingClass interning — tasks with identical resource shape
and scheduling options share an interned integer id, which is the queueing
key of ``ClusterTaskManager`` and the dedup key that turns 1M pending tasks
into ~100s of distinct rows for the batched TPU solve, SURVEY.md §3.4).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (
    ActorID, FunctionID, JobID, ObjectID, PlacementGroupID, TaskID, WorkerID,
)
from ray_tpu_torch.scheduler.policy import SchedulingOptions, SchedulingType
from ray_tpu_torch.scheduler.resources import ResourceRequest

# ---------------------------------------------------------------------------
# SchedulingClass interning (task_spec.h:297).
# ---------------------------------------------------------------------------

_sched_class_lock = threading.Lock()
_sched_class_table: Dict[Tuple, int] = {}
_sched_class_rev: Dict[int, Tuple["ResourceRequest", "SchedulingOptions"]] = {}
_sched_class_counter = itertools.count(1)


def scheduling_class_of(resources: ResourceRequest,
                        options: SchedulingOptions) -> int:
    key = (resources.key, options.scheduling_type.value,
           options.spread_threshold,
           str(options.node_affinity_node_id),
           options.node_affinity_soft)
    with _sched_class_lock:
        cls = _sched_class_table.get(key)
        if cls is None:
            cls = next(_sched_class_counter)
            _sched_class_table[key] = cls
            _sched_class_rev[cls] = (resources, options)
        return cls


def scheduling_class_descriptor(cls: int):
    with _sched_class_lock:
        return _sched_class_rev[cls]


class TaskType:
    NORMAL_TASK = "NORMAL_TASK"
    ACTOR_CREATION_TASK = "ACTOR_CREATION_TASK"
    ACTOR_TASK = "ACTOR_TASK"
    DRIVER_TASK = "DRIVER_TASK"


@dataclass
class TaskArg:
    """One task argument: either an inlined serialized value or a reference.

    Reference: args <=100KB are inlined into the spec, larger ones are put
    in plasma and passed by reference (``_raylet.pyx:1487``).
    """

    is_inline: bool
    value: Any = None              # SerializedObject when inline
    object_id: Optional[ObjectID] = None
    owner_id: Optional[WorkerID] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: str
    function_id: FunctionID
    function_name: str
    args: List[TaskArg]
    num_returns: int
    resources: ResourceRequest
    scheduling_options: SchedulingOptions
    scheduling_class: int
    owner_id: WorkerID
    parent_task_id: Optional[TaskID] = None
    depth: int = 0
    max_retries: int = 0
    retry_exceptions: bool = False
    name: str = ""
    # Actor-related
    actor_id: Optional[ActorID] = None
    actor_creation: bool = False
    actor_method_name: str = ""
    max_restarts: int = 0
    max_concurrency: int = 1
    max_task_retries: int = 0
    concurrency_group: str = ""
    # Actor creation only: {group_name: max_concurrency} — methods
    # tagged with a group execute in that group's own pool
    # (concurrency_group_manager.cc parity).
    concurrency_groups: Optional[dict] = None
    # Placement group
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    capture_child_tasks: bool = False
    # Runtime env (dict: {"env_vars": ..., "pip": ..., "working_dir": ...})
    runtime_env: Optional[dict] = None
    # Refs nested inside inlined args: borrowed for the task's lifetime
    # (reference: borrower registration, reference_count.h:61).
    borrowed_ids: List[ObjectID] = field(default_factory=list)
    # Tracing context propagated submit -> execute (the reference
    # injects a ``_ray_trace_ctx`` kwarg, tracing_helper.py:157,314).
    trace_ctx: Optional[dict] = None
    # Dynamic/streaming returns
    returns_dynamic: bool = False
    # Actor creation only: resources held while the actor is alive.  The
    # reference schedules actor placement with num_cpus (default 1) but
    # releases the CPU once the actor is up unless the user set resources
    # explicitly, so idle actors don't starve the node (task_spec.h
    # GetRequiredResources vs GetRequiredPlacementResources).
    lifetime_resources: Optional[ResourceRequest] = None

    @property
    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.from_index(self.task_id, i + 1)
                for i in range(self.num_returns)]

    def arg_object_ids(self) -> List[ObjectID]:
        return [a.object_id for a in self.args if not a.is_inline]

    def is_actor_task(self) -> bool:
        return self.task_type == TaskType.ACTOR_TASK

    def is_actor_creation(self) -> bool:
        return self.task_type == TaskType.ACTOR_CREATION_TASK

    def debug_string(self) -> str:
        return (f"{self.task_type} {self.function_name} id={self.task_id} "
                f"class={self.scheduling_class} res={self.resources.to_dict()}")


def make_spec(*, job_id: JobID, owner_id: WorkerID, function_id: FunctionID,
              function_name: str, args: List[TaskArg], num_returns: int,
              resources: Dict[str, float], scheduling_strategy=None,
              parent_task_id=None, depth=0, task_type=TaskType.NORMAL_TASK,
              **kwargs) -> TaskSpec:
    req = ResourceRequest(resources)
    lifetime = kwargs.pop("lifetime_resources", None)
    if lifetime is not None and not isinstance(lifetime, ResourceRequest):
        lifetime = ResourceRequest(lifetime)
    if lifetime is not None:
        kwargs["lifetime_resources"] = lifetime
    options = options_from_strategy(scheduling_strategy)
    spec = TaskSpec(
        task_id=TaskID.from_random(),
        job_id=job_id,
        task_type=task_type,
        function_id=function_id,
        function_name=function_name,
        args=args,
        num_returns=num_returns,
        resources=req,
        scheduling_options=options,
        scheduling_class=scheduling_class_of(req, options),
        owner_id=owner_id,
        parent_task_id=parent_task_id,
        depth=depth,
        **kwargs,
    )
    return spec


def options_from_strategy(strategy) -> SchedulingOptions:
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)
    if strategy is None or strategy == "DEFAULT":
        return SchedulingOptions.hybrid()
    if strategy == "SPREAD":
        return SchedulingOptions.spread()
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        from ray_tpu_torch._private.ids import NodeID
        nid = strategy.node_id
        if isinstance(nid, str):
            nid = NodeID.from_hex(nid)
        return SchedulingOptions.affinity(nid, soft=strategy.soft)
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        # PG scheduling resolves to node affinity on the bundle's node at
        # submission time (handled in core_worker before spec build).
        return SchedulingOptions.hybrid()
    raise ValueError(f"Unknown scheduling strategy: {strategy!r}")
