"""ray_tpu_torch.workflow — durable DAG execution on the port's
task/actor core, a port of ``ray_tpu.workflow``.

Parity: reference ``python/ray/workflow/`` — ``@workflow.step``
functions composed into DAGs, every step's inputs/outputs checkpointed
(``workflow_storage.py``), crash recovery that resumes from the durable
log instead of re-running finished work (``recovery.py``), and virtual
actors whose state survives process death
(``virtual_actor_class.py``).

    import ray_tpu_torch
    from ray_tpu_torch import workflow

    @workflow.step
    def fetch(url): ...

    @workflow.step
    def combine(a, b): ...

    result = combine.step(fetch.step(u1), fetch.step(u2)).run("my-wf")
    # ...crash anywhere; later:
    result = ray_tpu_torch.get(workflow.resume("my-wf"))

Events: ``wait_for_event`` with an ``EventListener`` (``TimerListener``
built in); ``sleep`` is not implemented, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.workflow.execution import (
    StepNode, VirtualActor, VirtualActorClass, resume_workflow)
from ray_tpu_torch.workflow.storage import (
    WorkflowStatus, WorkflowStorage, list_workflows, set_base)

__all__ = [
    "init", "step", "virtual_actor", "get_actor", "resume", "resume_all",
    "get_output", "get_status", "list_all", "cancel", "delete",
    "WorkflowStatus", "EventListener", "TimerListener", "wait_for_event",
]


def __getattr__(name):
    # Late-bound: event_listener imports `step` from this module.
    if name in ("EventListener", "TimerListener", "wait_for_event"):
        from ray_tpu_torch.workflow import event_listener
        return getattr(event_listener, name)
    raise AttributeError(name)


def init(storage: Optional[str] = None):
    """Point workflow storage at a directory (default:
    ``<temp_dir>/workflows``).  Reference: ``workflow.init(storage)``."""
    set_base(storage)


class _StepFunction:
    """What ``@workflow.step`` produces: call ``.step(*args)`` to build a
    DAG node, ``.options(...)`` to override per-step settings."""

    def __init__(self, fn, max_retries: int = 0, name: str = ""):
        self._fn = fn
        self._max_retries = max_retries
        self._name = name or getattr(fn, "__name__", "step")
        functools.update_wrapper(self, fn)

    def step(self, *args, **kwargs) -> StepNode:
        return StepNode(self._fn, args, kwargs, name=self._name,
                        max_retries=self._max_retries)

    def options(self, *, max_retries: Optional[int] = None,
                name: Optional[str] = None) -> "_StepFunction":
        return _StepFunction(
            self._fn,
            self._max_retries if max_retries is None else max_retries,
            self._name if name is None else name)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "workflow steps cannot be called directly; use "
            "`.step(*args)` to build the DAG, then `.run()`")


def step(*args, **kwargs):
    """``@workflow.step`` or ``@workflow.step(max_retries=3)``."""
    if len(args) == 1 and callable(args[0]) and not kwargs:
        return _StepFunction(args[0])

    def wrap(fn):
        return _StepFunction(fn, **kwargs)

    return wrap


class _VirtualActorDecorator:
    """``@workflow.virtual_actor`` + ``@workflow.virtual_actor.readonly``
    (readonly methods skip the state checkpoint)."""

    def __call__(self, cls: type) -> VirtualActorClass:
        return VirtualActorClass(cls)

    @staticmethod
    def readonly(method):
        method._workflow_readonly = True
        return method


virtual_actor = _VirtualActorDecorator()


def get_actor(actor_id: str) -> VirtualActor:
    storage = WorkflowStorage(actor_id)
    if not storage.has_actor(actor_id):
        raise ValueError(f"No virtual actor {actor_id!r} in storage")
    return VirtualActor(actor_id, storage)


def resume(workflow_id: str):
    """Resume a crashed/failed workflow; returns a ref on the result."""
    return resume_workflow(workflow_id)


def resume_all(include_failed: bool = True) -> Dict[str, Any]:
    """Resume every resumable workflow in storage; id -> result ref.
    Virtual-actor records (no step DAG) are skipped."""
    out = {}
    for wid, status in list_workflows().items():
        if status in (WorkflowStatus.RESUMABLE, WorkflowStatus.RUNNING) or \
                (include_failed and status == WorkflowStatus.FAILED):
            try:
                out[wid] = resume_workflow(wid)
            except ValueError:
                pass
    return out


def _await_verdict(base: str, workflow_id: str):
    """Wait for a live run to reach a verdict, then read the checkpoint
    — never re-launches steps (a second launch would re-run in-flight
    side effects concurrently with the first)."""
    import time as _time

    storage = WorkflowStorage(workflow_id, base)
    while True:
        meta = storage.load_workflow() or {}
        status = meta.get("status")
        if status == WorkflowStatus.SUCCESSFUL:
            return storage.load_output(meta["entry_step"])
        if status in (WorkflowStatus.RESUMABLE, WorkflowStatus.FAILED,
                      WorkflowStatus.CANCELED):
            raise RuntimeError(
                f"workflow {workflow_id!r} ended as {status}; "
                "use workflow.resume() to re-run it")
        _time.sleep(0.1)


_await_result = ray_tpu_torch.remote(_await_verdict)


def get_output(workflow_id: str):
    """Ref on a workflow's final output.  Finished: served from the
    checkpoint.  Still running: a waiter tracks the live run (reference
    semantics — get_output never starts a second execution)."""
    storage = WorkflowStorage(workflow_id)
    meta = storage.load_workflow()
    if meta is None:
        raise ValueError(f"No workflow record for {workflow_id!r}")
    if not meta.get("entry_step"):
        raise ValueError(f"{workflow_id!r} is a virtual actor, not a "
                         "workflow")
    if meta.get("status") == WorkflowStatus.SUCCESSFUL and \
            storage.has_output(meta["entry_step"]):
        return ray_tpu_torch.put(storage.load_output(meta["entry_step"]))
    if meta.get("status") in (WorkflowStatus.RESUMABLE,
                              WorkflowStatus.FAILED):
        return resume_workflow(workflow_id)
    return _await_result.remote(storage.base, workflow_id)


def get_status(workflow_id: str) -> Optional[str]:
    return WorkflowStorage(workflow_id).status()


def list_all(status_filter: Optional[str] = None) -> Dict[str, str]:
    all_wfs = list_workflows()
    if status_filter is None:
        return all_wfs
    return {k: v for k, v in all_wfs.items() if v == status_filter}


def cancel(workflow_id: str):
    """Best-effort cancel: mark CANCELED.  Steps not yet started observe
    the mark and refuse to run; resume() on a canceled workflow raises
    (running step bodies cannot be preempted)."""
    WorkflowStorage(workflow_id).set_status(WorkflowStatus.CANCELED)


def delete(workflow_id: str):
    WorkflowStorage(workflow_id).delete()
