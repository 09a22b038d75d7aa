"""@remote functions.

A port of ``ray_tpu.remote_function`` for the PyTorch port (reference
``python/ray/remote_function.py``): ``RemoteFunction`` wraps the user
function; ``_remote`` (:246) exports the function, builds the task spec
(inlining the arguments) and submits it through the core worker (:421);
``.options(...)`` (:129) returns a shallow override wrapper.

Options: ``num_cpus``, ``num_gpus``, ``memory``, ``resources``,
``num_returns``, ``max_retries``, ``retry_exceptions``,
``scheduling_strategy``, ``runtime_env`` and ``name``.  A
placement-group strategy rewrites the task's resources to the bundle's
formatted ones (``resolve_pg_strategy``); a runtime env is validated,
its local paths packaged into the GCS KV and its hash stamped at submit
(``normalized_env``).
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.executor import pack_args
from ray_tpu_torch._private.task_spec import TaskType, make_spec

_DEFAULT_OPTIONS = dict(
    num_cpus=1, num_gpus=0, memory=0, resources=None, num_returns=1,
    max_retries=None, retry_exceptions=False, scheduling_strategy=None,
    runtime_env=None, name=None,
)


def _resource_dict(o: Dict[str, Any]) -> Dict[str, float]:
    res = dict(o.get("resources") or {})
    if o.get("num_cpus"):
        res["CPU"] = o["num_cpus"]
    if o.get("num_gpus"):
        res["GPU"] = o["num_gpus"]
    if o.get("memory"):
        res["memory"] = o["memory"]
    return res


def resolve_pg_strategy(options: Dict[str, Any], resources: Dict[str, float]):
    """Rewrite resources for placement-group scheduling (bundle_spec.h
    formatted resources).  Returns (resources, strategy, placement group
    id or None, bundle index)."""
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy
    strategy = options.get("scheduling_strategy")
    if not isinstance(strategy, PlacementGroupSchedulingStrategy):
        return resources, strategy, None, -1
    from ray_tpu_torch.scheduler.bundle_packing import \
        rewrite_resources_for_bundle
    pg = strategy.placement_group
    idx = strategy.placement_group_bundle_index
    rewritten = rewrite_resources_for_bundle(resources, pg.id, idx)
    return rewritten, "DEFAULT", pg.id, idx


def normalized_env(runtime_env, w):
    """The runtime env packaged and hashed for the spec (packaging.py:
    once per content, deduplicated in the GCS KV), or None."""
    if not runtime_env:
        return None
    from ray_tpu_torch._private import runtime_env as runtime_env_mod
    return runtime_env_mod.normalize(runtime_env, w.cluster.gcs.kv)


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._name = f"{fn.__module__}.{fn.__qualname__}"
        self._options = dict(_DEFAULT_OPTIONS)
        self._options.update(options or {})
        self._function_id = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name} cannot be called directly; use "
            f"{getattr(self._function, '__name__', 'f')}.remote().")

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        rf = RemoteFunction(self._function, merged)
        rf._function_id = self._function_id
        return rf

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, options):
        w = worker_mod.global_worker()
        if not w.connected:
            # Auto-init only from the main thread: a background thread
            # touching the API after shutdown() must not silently boot a
            # fresh cluster.
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    "ray_tpu_torch.init() has not been called yet (or the "
                    "cluster was shut down).")
            worker_mod.init()
        core = w.core_worker
        resources, strategy, pg_id, bundle_idx = resolve_pg_strategy(
            options, _resource_dict(options))
        # Export every call: the FunctionManager dedupes per cluster, and a
        # RemoteFunction defined at module scope outlives init/shutdown
        # cycles (a cached id would dangle into the new cluster's table).
        self._function_id = core.function_manager.export(self._function)
        task_args, _, holders, borrowed = core.build_args(
            pack_args(args, kwargs))
        parent = worker_context.current_task_spec()
        cfg_retries = options.get("max_retries")
        spec = make_spec(
            job_id=w.job_id,
            owner_id=core.worker_id,
            function_id=self._function_id,
            function_name=options.get("name") or self._name,
            args=task_args,
            num_returns=options.get("num_returns", 1),
            resources=resources,
            scheduling_strategy=strategy,
            parent_task_id=parent.task_id if parent else core.driver_task_id,
            depth=(parent.depth + 1) if parent else 0,
            task_type=TaskType.NORMAL_TASK,
            max_retries=(cfg_retries if cfg_retries is not None
                         else get_config().task_max_retries),
            retry_exceptions=bool(options.get("retry_exceptions")),
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_idx,
            runtime_env=normalized_env(options.get("runtime_env"), w),
            borrowed_ids=borrowed,
        )
        refs = core.submit_task(spec, holders)
        if spec.num_returns == 0:
            return None
        if spec.num_returns == 1:
            return refs[0]
        return refs
