"""Runtime context introspection.

A port of ``ray_tpu.runtime_context`` for the PyTorch port (reference
``python/ray/runtime_context.py``): job, node, task and actor ids, the
current actor's handle and whether it was restarted, the namespace, the
assigned resources (an actor's creation task reports what the actor
holds for its life, none for a default actor) and the placement group,
from the driver or inside a task or an actor.
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

    @property
    def actor_id(self):
        spec = worker_context.current_task_spec()
        return spec.actor_id if spec and spec.actor_id else None

    def get_actor_id(self) -> Optional[str]:
        a = self.actor_id
        return a.hex() if a else None

    @property
    def current_actor(self):
        """The handle of the current actor (inside one of its methods)."""
        aid = self.actor_id
        if aid is None:
            raise RuntimeError("Not inside an actor method")
        from ray_tpu_torch.actor import ActorHandle
        return ActorHandle(aid)

    @property
    def namespace(self) -> str:
        return worker_mod.global_worker().namespace

    @property
    def was_current_actor_reconstructed(self) -> bool:
        aid = self.actor_id
        if aid is None:
            return False
        w = worker_mod.global_worker()
        actor = w.cluster.gcs.actor_manager.get_actor(aid)
        return bool(actor and actor.num_restarts > 0)

    def get_assigned_resources(self) -> dict:
        spec = worker_context.current_task_spec()
        if spec is None:
            return {}
        # An actor holds its lifetime resources (none for a default
        # actor), not the CPU that placed its creation task.
        if spec.is_actor_creation() and spec.lifetime_resources is not None:
            return spec.lifetime_resources.to_dict()
        return spec.resources.to_dict()

    def get_placement_group_id(self) -> Optional[str]:
        spec = worker_context.current_task_spec()
        if spec is None or spec.placement_group_id is None:
            return None
        return spec.placement_group_id.hex()


_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _context
