"""Actor API: ``ActorClass``, ``ActorHandle`` and ``ActorMethod``.

A port of ``ray_tpu.actor`` (reference ``python/ray/actor.py``):
``@remote`` on a class gives an ``ActorClass``; its ``.remote(...)``
builds the creation task and registers the actor with the GCS, whose
actor manager places it; ``handle.method.remote(...)`` submits an
ordered actor task to the actor's worker; a handle pickles by its actor
id, so it can be passed into tasks and other actors; a named actor is
found by ``get_actor``.

A default actor takes ``{"CPU": 1}`` to be placed and holds nothing
once it is alive; an actor given resources (an explicit ``num_cpus=0``
included) holds them for its life (``lifetime_resources``,
task_spec.h's placement resources against its required ones).  Options:
``num_cpus``, ``num_gpus``, ``memory``, ``resources``, ``max_restarts``,
``max_task_retries``, ``max_concurrency``, ``concurrency_groups``,
``name``, ``namespace``, ``lifetime``, ``scheduling_strategy`` (a
placement-group strategy rewrites the resources to the bundle's) and
``runtime_env`` (applied around the constructor on a thread worker, the
whole process's on a process worker, as in the reference).
The reference's ``num_tpus`` has no counterpart here.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.executor import pack_args
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.task_spec import TaskType, make_spec
from ray_tpu_torch.remote_function import (_resource_dict, normalized_env,
                                           resolve_pg_strategy)

_DEFAULT_ACTOR_OPTIONS = dict(
    num_cpus=None, num_gpus=0, memory=0, resources=None,
    max_restarts=0, max_task_retries=0, max_concurrency=1,
    concurrency_groups=None,
    name=None, namespace=None, lifetime=None, scheduling_strategy=None,
    runtime_env=None,
)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs,
            num_returns=self._num_returns,
            concurrency_group=self._concurrency_group)

    def options(self, num_returns: int = 1,
                concurrency_group: str = "", **_):
        return ActorMethod(self._handle, self._method_name,
                           num_returns=num_returns,
                           concurrency_group=concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .remote().")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name

    @classmethod
    def _from_gcs_actor(cls, gcs_actor):
        return cls(gcs_actor.actor_id,
                   class_name=gcs_actor.info().get("class_name", ""))

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _submit_method(self, method_name: str, args, kwargs,
                       num_returns: int = 1, concurrency_group: str = ""):
        w = worker_mod.global_worker()
        core = w.core_worker
        gcs_actor = w.cluster.gcs.actor_manager.get_actor(self._actor_id)
        creation = gcs_actor.creation_spec if gcs_actor else None
        task_args, _, holders, borrowed = core.build_args(
            pack_args(args, kwargs))
        parent = worker_context.current_task_spec()
        spec = make_spec(
            job_id=w.job_id,
            owner_id=core.worker_id,
            function_id=creation.function_id if creation else None,
            function_name=f"{self._class_name}.{method_name}",
            args=task_args,
            num_returns=num_returns,
            resources={},   # methods run on the actor's held resources
            scheduling_strategy=None,
            parent_task_id=parent.task_id if parent else core.driver_task_id,
            task_type=TaskType.ACTOR_TASK,
            actor_id=self._actor_id,
            actor_method_name=method_name,
            concurrency_group=concurrency_group,
            max_retries=(creation.max_task_retries if creation else 0),
            borrowed_ids=borrowed,
        )
        refs = core.submit_actor_task(spec, holders=holders)
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._class_name))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"


def _rebuild_handle(actor_id, class_name):
    return ActorHandle(actor_id, class_name)


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._class_name = cls.__name__
        self._options = dict(_DEFAULT_ACTOR_OPTIONS)
        self._options.update(options or {})
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *a, **k):
        raise TypeError(f"Actors must be created with "
                        f"{self._class_name}.remote()")

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        o = self._options
        w = worker_mod.global_worker()
        if not w.connected:
            # Auto-init only from the main thread (as RemoteFunction).
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    "ray_tpu_torch.init() has not been called yet (or the "
                    "cluster was shut down).")
            worker_mod.init()
        core = w.core_worker
        function_id = core.function_manager.export(self._cls)
        # A default actor needs one CPU to be placed and holds nothing
        # alive; resources asked for (an explicit num_cpus=0 included)
        # are held for the actor's life.
        explicit_any = (o.get("num_cpus") is not None or o.get("num_gpus")
                        or o.get("memory") or o.get("resources"))
        resources = _resource_dict(o) if explicit_any else {"CPU": 1.0}
        resources, strategy, pg_id, bundle_idx = resolve_pg_strategy(
            o, resources)
        lifetime_resources = resources if explicit_any else {}
        task_args, _, holders, borrowed = core.build_args(
            pack_args(args, kwargs))
        actor_id = ActorID.from_random()
        parent = worker_context.current_task_spec()
        spec = make_spec(
            job_id=w.job_id,
            owner_id=core.worker_id,
            function_id=function_id,
            function_name=f"{self._class_name}.__init__",
            args=task_args,
            num_returns=0,
            resources=resources,
            scheduling_strategy=strategy,
            parent_task_id=parent.task_id if parent else core.driver_task_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            actor_id=actor_id,
            actor_creation=True,
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            max_concurrency=o.get("max_concurrency", 1),
            concurrency_groups=o.get("concurrency_groups"),
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            lifetime_resources=lifetime_resources,
            runtime_env=normalized_env(o.get("runtime_env"), w),
            borrowed_ids=borrowed,
        )
        namespace = o.get("namespace")
        core.create_actor(
            spec,
            name=o.get("name") or "",
            namespace=namespace if namespace is not None else w.namespace,
            detached=(o.get("lifetime") == "detached"))
        del holders  # the pinned creation arguments hold them now
        return ActorHandle(actor_id, class_name=self._class_name)


def make_actor_class(cls, options) -> ActorClass:
    return ActorClass(cls, options)
