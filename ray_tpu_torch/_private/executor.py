"""Task execution on a worker thread.

A port of ``ray_tpu._private.executor`` for the PyTorch port (reference
``CoreWorker::ExecuteTask``, core_worker.cc:2255 -> ``execute_task``,
_raylet.pyx:481): materialize the arguments (an object argument through
``CoreWorker.get_for_executor``: the node store, a pull, or the owner's
memory store), then run the task by its type: a normal task loads the
function from the cluster's function table, runs it and stores the
returns (in the owner's memory store, or above 100 KiB in the node's
store); an actor's creation task loads the class and returns the
instance to its worker, which keeps it; an actor task calls the method
on the instance it is given (``actor_instance``) and stores the returns.

The RUNNING task event is emitted as the task starts (reference
``executor.py:77``).  Divergence: a task whose node was killed while it
ran stores no return and reports a ``NodeDiedError``, so its owner
retries it on a live node, an actor's caller after the actor's restart
(ROADMAP C.11, C.15); the reference's executor thread stores the late
returns on the dead node.

A task's runtime env (env vars, import paths) is applied around its
body, under ``runtime_env``'s lock, each env materialized once and
cached by its hash (``uri_cache.py`` parity); a process worker gets its
env at spawn instead.  Left out until the debug planes (A.4b.7): the
``util.tracing`` span.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import deserialize
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType
from ray_tpu_torch.gcs import task_events


def resolve_args(spec: TaskSpec, node, core_worker):
    """Materialize task arguments (GetAndPinArgsForExecutor parity)."""
    out = []
    for arg in spec.args:
        if arg.is_inline:
            out.append(deserialize(arg.value))
        else:
            out.append(core_worker.get_for_executor(arg.object_id, node))
    return out


def store_returns(spec: TaskSpec, values, node, core_worker):
    """Store return values; returns list of (object_id, size)."""
    num = spec.num_returns
    if num == 1:
        values = [values]
    elif num == 0:
        return []
    else:
        values = list(values)
        if len(values) != num:
            raise ValueError(
                f"Task {spec.function_name} returned {len(values)} values, "
                f"expected num_returns={num}")
    results = []
    for i, value in enumerate(values):
        oid = ObjectID.from_index(spec.task_id, i + 1)
        results.append((oid, core_worker.put_return_value(oid, value, node)))
    return results


def execute_task(spec: TaskSpec, node, core_worker, actor_instance=None):
    """Run one task on the current thread; returns (ok, error), or
    (True, instance) for an actor's creation task.

    On success return values are already stored.  On failure the caller
    (TaskManager) decides between retry and storing error objects.
    """
    ctx = worker_context.ExecutionContext(
        task_spec=spec, node=node,
        worker=worker_context.get_context().worker,
        actor_instance=actor_instance)
    prev = worker_context.get_context()
    worker_context.set_context(ctx)
    wid = getattr(ctx.worker, "worker_id", None)
    task_events.emit(node.cluster, spec.task_id, task_events.RUNNING,
                     node_id=node.node_id.hex(),
                     worker_id=wid.hex() if wid is not None else "")
    t0 = time.monotonic()
    try:
        args, kwargs = _split_args(resolve_args(spec, node, core_worker))
        with _applied_runtime_env(spec, node):
            if spec.task_type == TaskType.ACTOR_TASK:
                result = getattr(actor_instance,
                                 spec.actor_method_name)(*args, **kwargs)
            else:
                fn = core_worker.function_manager.load(spec.function_id)
                result = fn(*args, **kwargs)
        if node._dead:
            # The node was killed under the task: its result never
            # reaches the owner, which retries the task elsewhere.
            return False, exceptions.NodeDiedError(node.node_id)
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            return True, result
        store_returns(spec, result, node, core_worker)
        return True, None
    except Exception as e:  # noqa: BLE001 — user exceptions cross the boundary
        return False, exceptions.TaskError(
            e, task_desc=f"{spec.function_name}[{spec.task_id.hex()[:8]}]")
    finally:
        worker_context.set_context(prev)
        core_worker.record_task_metric(spec, time.monotonic() - t0)


_env_ctx_cache: dict = {}
_env_ctx_lock = threading.Lock()


def _applied_runtime_env(spec: TaskSpec, node):
    """The thread worker's application of the task's runtime env; the
    materialized contexts are cached by the env's hash."""
    from ray_tpu_torch._private import runtime_env as runtime_env_mod
    renv = spec.runtime_env
    if not renv:
        return contextlib.nullcontext()
    h = renv.get("_hash") or runtime_env_mod.env_hash(renv)
    with _env_ctx_lock:
        env_ctx = _env_ctx_cache.get(h)
    if env_ctx is None:
        env_ctx = runtime_env_mod.materialize(renv, node.cluster.gcs.kv)
        with _env_ctx_lock:
            _env_ctx_cache[h] = env_ctx
    return runtime_env_mod.applied(env_ctx)


class _KwMark:
    """Marker separating positional args from flattened kwargs."""

    def __reduce__(self):
        return (_KwMark, ())


def pack_args(args, kwargs):
    """Flatten (args, kwargs) into one positional list for the spec.

    Each kwarg value stays a *top-level* arg so ObjectRefs passed by
    keyword are resolved to values on the executor side, matching the
    reference's signature flattening (python/ray/_private/signature.py).
    """
    packed = list(args)
    if kwargs:
        packed.append(_KwMark())
        packed.append(tuple(kwargs.keys()))
        packed.extend(kwargs.values())
    return packed


def _split_args(flat):
    for i, v in enumerate(flat):
        if isinstance(v, _KwMark):
            keys = flat[i + 1]
            values = flat[i + 2:]
            return list(flat[:i]), dict(zip(keys, values))
    return list(flat), {}
