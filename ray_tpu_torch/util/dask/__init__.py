"""Dask-on-ray_tpu_torch: execute dask task graphs on the port's runtime.

A copy of ``ray_tpu.util.dask`` for the PyTorch port, with the
reference's names (``ray_tpu_dask_get``, ``enable_dask_on_ray_tpu``,
``disable_dask_on_ray_tpu``); dask is imported only inside the calls
that need it.

Parity: reference ``python/ray/util/dask/scheduler.py`` —
``ray_dask_get`` walks a dask graph bottom-up, submits one runtime task
per graph task with upstream results passed as object refs (so the
object store, not the driver, holds intermediates), and gathers only
the requested keys; ``enable_dask_on_ray`` flips dask's default
scheduler.

Design difference: the reference leans on ``dask.core`` for graph
utilities.  A dask graph is plain data — a dict of
``key -> task | literal | key-alias`` where a task is a tuple whose
head is callable — so the walker here implements that spec directly
(``istask``/``toposort`` below) and works without dask installed;
``enable_dask_on_ray_tpu`` and the ``dask.compute`` integration
activate only when dask itself is importable.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence

import ray_tpu_torch

__all__ = ["ray_tpu_dask_get", "enable_dask_on_ray_tpu",
           "disable_dask_on_ray_tpu"]


def _ishashable(x: Any) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def istask(x: Any) -> bool:
    """A dask-spec task: a tuple whose first element is callable."""
    return isinstance(x, tuple) and bool(x) and callable(x[0])


def _dependencies(expr: Any, dsk: Dict) -> set:
    """Keys of ``dsk`` referenced (recursively) by ``expr``."""
    deps = set()
    stack = [expr]
    while stack:
        e = stack.pop()
        if istask(e):
            stack.extend(e[1:])
        elif isinstance(e, list):
            stack.extend(e)
        elif _ishashable(e) and e in dsk:
            # Includes non-task tuples: per the dask spec a hashable
            # non-task argument matching a graph key IS a reference.
            deps.add(e)
    return deps


def _execute_expr(expr: Any, results: Dict[Hashable, Any]) -> Any:
    """Evaluate a dask-spec expression given materialized upstreams.

    Runs INSIDE a runtime task: ``results`` maps the expression's
    dependency keys to their (already ray_tpu_torch.get-resolved) values.
    """
    if istask(expr):
        fn = expr[0]
        args = [_execute_expr(a, results) for a in expr[1:]]
        return fn(*args)
    if isinstance(expr, list):
        return [_execute_expr(e, results) for e in expr]
    if _ishashable(expr) and expr in results:
        # Includes non-task tuple keys, e.g. ("x", 0) chunk keys.
        return results[expr]
    return expr


def _run_dask_task(expr: Any, dep_keys: List[Hashable], *dep_values: Any):
    """One graph task: upstream values arrive as resolved task args
    (object refs at submit time — the scheduler's arg-locality and the
    object store do the data movement, reference scheduler.py
    _rayify_task)."""
    return _execute_expr(expr, dict(zip(dep_keys, dep_values)))


_dask_task = ray_tpu_torch.remote(_run_dask_task)


def _toposort(dsk: Dict, targets: Sequence[Hashable]) -> List[Hashable]:
    order: List[Hashable] = []
    seen: Dict[Hashable, int] = {}   # 0 = visiting, 1 = done
    stack = [(k, False) for k in targets]
    while stack:
        key, processed = stack.pop()
        if processed:
            seen[key] = 1
            order.append(key)
            continue
        state = seen.get(key)
        if state == 1:
            continue
        if state == 0:
            raise ValueError(f"cycle in dask graph at key {key!r}")
        seen[key] = 0
        stack.append((key, True))
        for dep in _dependencies(dsk[key], dsk):
            if seen.get(dep) != 1:
                stack.append((dep, False))
    return order


def ray_tpu_dask_get(dsk: Dict, keys, ray_remote_args: Optional[dict] = None,
                     **_kwargs):
    """Dask scheduler entry point (reference ``ray_dask_get``): submit
    the graph as runtime tasks and block on the requested ``keys``.

    ``keys`` may be a single key, a list of keys, or arbitrarily nested
    lists (dask passes nested key lists for collections)."""
    remote = _dask_task
    if ray_remote_args:
        remote = _dask_task.options(**ray_remote_args)
    refs: Dict[Hashable, Any] = {}

    flat: List[Hashable] = []

    def _flatten(ks):
        if isinstance(ks, list):
            for k in ks:
                _flatten(k)
        else:
            flat.append(ks)

    _flatten(keys)
    for key in _toposort(dsk, flat):
        expr = dsk[key]
        deps = sorted(_dependencies(expr, dsk), key=str)
        refs[key] = remote.remote(expr, deps, *[refs[d] for d in deps])

    # One batched get over every requested ref, then re-nest — not a
    # blocking round-trip per key.
    values = dict(zip(flat, ray_tpu_torch.get([refs[k] for k in flat])))

    def _gather(ks):
        if isinstance(ks, list):
            return [_gather(k) for k in ks]
        return values[ks]

    return _gather(keys)


# Alias matching the reference's public name style.
ray_dask_get = ray_tpu_dask_get

_dask_config_ctx = None


def enable_dask_on_ray_tpu(shuffle: Optional[str] = "tasks"):
    """Make ``ray_tpu_dask_get`` dask's default scheduler (reference
    ``enable_dask_on_ray``).  Requires dask; returns the dask config
    context (usable as a context manager to scope the setting)."""
    try:
        import dask
    except ImportError as e:
        raise ImportError(
            "enable_dask_on_ray_tpu requires dask; the graph executor "
            "ray_tpu_dask_get(dsk, keys) works without it") from e
    return dask.config.set(scheduler=ray_tpu_dask_get, shuffle=shuffle)


def disable_dask_on_ray_tpu():
    import dask
    return dask.config.set(scheduler=None, shuffle=None)
