"""Task execution on a worker thread.

A port of ``ray_tpu._private.executor`` for the PyTorch port, normal
tasks only (reference ``CoreWorker::ExecuteTask``, core_worker.cc:2255
-> ``execute_task``, _raylet.pyx:481): materialize the arguments (an
object argument through ``CoreWorker.get_for_executor``: the node store,
a pull, or the owner's memory store), load the function from the
cluster's function table, run it, store the returns (in the owner's
memory store, or above 100 KiB in the node's store).

Left out, each with the item that brings it: the runtime env applied
around the task body (``submit_task`` raises for a non-empty one), the
task events (the GCS, ROADMAP A.4b.4), the ``util.tracing`` span (the
debug planes, A.4b.7), and the actor paths (the actors item, A.4b.5).
"""

from __future__ import annotations

import time

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import deserialize
from ray_tpu_torch._private.task_spec import TaskSpec


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


def execute_task(spec: TaskSpec, node, core_worker):
    """Run one task on the current thread; returns (ok, error).

    On success return values are already stored.  On failure the caller
    (TaskManager) decides between retry and storing error objects.
    """
    ctx = worker_context.ExecutionContext(
        task_spec=spec, node=node,
        worker=worker_context.get_context().worker)
    prev = worker_context.get_context()
    worker_context.set_context(ctx)
    t0 = time.monotonic()
    try:
        args, kwargs = _split_args(resolve_args(spec, node, core_worker))
        fn = core_worker.function_manager.load(spec.function_id)
        result = fn(*args, **kwargs)
        store_returns(spec, result, node, core_worker)
        return True, None
    except Exception as e:  # noqa: BLE001 — user exceptions cross the boundary
        return False, exceptions.TaskError(
            e, task_desc=f"{spec.function_name}[{spec.task_id.hex()[:8]}]")
    finally:
        worker_context.set_context(prev)
        core_worker.record_task_metric(spec, time.monotonic() - t0)


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
