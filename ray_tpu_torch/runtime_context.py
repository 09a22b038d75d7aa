"""Runtime context introspection.

A port of the task half of ``ray_tpu.runtime_context`` for the PyTorch
port (reference ``python/ray/runtime_context.py``): job, node and task
ids, the assigned resources and the placement group, from the driver or
inside a task.  The actor accessors come with actors (ROADMAP A.4b.5).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private import worker_context


class RuntimeContext:
    @property
    def job_id(self):
        return worker_mod.global_worker().job_id

    def get_job_id(self) -> str:
        return self.job_id.hex()

    @property
    def node_id(self):
        ctx = worker_context.get_context()
        if ctx.node is not None:
            return ctx.node.node_id
        w = worker_mod.global_worker()
        return w.cluster.head_node.node_id if w.cluster else None

    def get_node_id(self) -> str:
        nid = self.node_id
        return nid.hex() if nid else ""

    @property
    def task_id(self):
        spec = worker_context.current_task_spec()
        return spec.task_id if spec else None

    def get_task_id(self) -> Optional[str]:
        t = self.task_id
        return t.hex() if t else None

    def get_assigned_resources(self) -> dict:
        spec = worker_context.current_task_spec()
        if spec is None:
            return {}
        return spec.resources.to_dict()

    def get_placement_group_id(self) -> Optional[str]:
        spec = worker_context.current_task_spec()
        if spec is None or spec.placement_group_id is None:
            return None
        return spec.placement_group_id.hex()


_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _context
