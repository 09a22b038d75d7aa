"""Workflow execution: DAG build, checkpointed step tasks, recovery.

A port of ``ray_tpu.workflow.execution`` on the port's tasks: each step
is a task leased through the raylets, ordered by its upstream steps'
refs.

Parity: reference ``python/ray/workflow/step_executor.py`` (steps run as
tasks, outputs checkpointed before downstream consumption, continuation
steps — a step returning another step — recorded so recovery never
re-runs a finished step) and ``recovery.py`` (resume walks the durable
step log instead of user code).

Design: every step is persisted (function, args with ``StepRef``
placeholders, dep list) BEFORE execution, so the durable log alone can
finish the workflow after a crash.  Step execution itself is idempotent:
if the output checkpoint exists the step is skipped — which is the whole
recovery story.  Top-level DAG fan-out runs as parallel ``ray_tpu_torch``
tasks ordered by upstream refs; continuations execute inline in the
parent step's task.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import cloudpickle as pickle  # locals-safe: steps/args may close over test-local classes
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.workflow.storage import (
    WorkflowStatus, WorkflowStorage, default_base)


class StepRef:
    """Placeholder for an upstream step's output inside persisted args."""

    __slots__ = ("step_id",)

    def __init__(self, step_id: str):
        self.step_id = step_id

    def __repr__(self):
        return f"StepRef({self.step_id})"


class StepNode:
    """One node of a workflow DAG (unexecuted).  Nodes are not mutated by
    execution, so one DAG object can be run under many workflow ids."""

    def __init__(self, fn, args: tuple, kwargs: dict, name: str = "",
                 max_retries: int = 0):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "step")
        self.max_retries = max_retries

    # ---- public (reference Workflow.run / run_async) --------------------
    def run(self, workflow_id: Optional[str] = None) -> Any:
        return ray_tpu_torch.get(self.run_async(workflow_id))

    def run_async(self, workflow_id: Optional[str] = None):
        workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
        storage = WorkflowStorage(workflow_id)
        entry_id = _persist_dag(storage, self)
        storage.save_workflow(entry_id, WorkflowStatus.RUNNING)
        return _launch(storage, entry_id, final=True)


def _collect_deps(obj, deps: List[str], ids: Dict[int, str]):
    """Recursively swap StepNodes for StepRefs in an args structure,
    collecting the dependency step ids (top-level containers only — a
    node hidden inside an arbitrary object is not discoverable)."""
    if isinstance(obj, StepNode):
        step_id = ids[id(obj)]
        deps.append(step_id)
        return StepRef(step_id)
    if isinstance(obj, list):
        return [_collect_deps(x, deps, ids) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_collect_deps(x, deps, ids) for x in obj)
    if isinstance(obj, dict):
        return {k: _collect_deps(v, deps, ids) for k, v in obj.items()}
    return obj


def _persist_dag(storage: WorkflowStorage, entry: StepNode,
                 id_prefix: str = "") -> str:
    """Assign per-run step ids (postorder, name + counter) and write
    every step's function/args/deps to storage; returns the entry id.
    Ids live in a per-call map — nodes stay immutable so a DAG can be
    re-run under a different workflow id."""
    counter = itertools.count()
    ordered: List[StepNode] = []
    ids: Dict[int, str] = {}

    def visit(node: StepNode):
        if id(node) in ids:
            return
        ids[id(node)] = f"{id_prefix}{next(counter):04d}-{node.name}"
        for a in _iter_nodes(node.args) + _iter_nodes(node.kwargs):
            visit(a)
        ordered.append(node)

    visit(entry)
    for node in ordered:
        deps: List[str] = []
        swapped_args = _collect_deps(node.args, deps, ids)
        swapped_kwargs = _collect_deps(node.kwargs, deps, ids)
        blob = pickle.dumps((swapped_args, swapped_kwargs), protocol=5)
        storage.save_step(ids[id(node)], node.fn, blob, node.name,
                          sorted(set(deps)),
                          max_retries=node.max_retries)
    return ids[id(entry)]


def _iter_nodes(obj) -> List[StepNode]:
    out: List[StepNode] = []

    def walk(x):
        if isinstance(x, StepNode):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(obj)
    return out


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

class WorkflowCanceledError(RuntimeError):
    pass


def _run_step_task(base: str, workflow_id: str, step_id: str, final: bool,
                   *_ordering_deps):
    """One checkpointed step as a framework task.  ``_ordering_deps`` are
    upstream step-task refs — consumed only for scheduling order; the
    actual values come from the durable output checkpoints."""
    storage = WorkflowStorage(workflow_id, base)
    if storage.status() == WorkflowStatus.CANCELED:
        raise WorkflowCanceledError(f"workflow {workflow_id!r} canceled")
    try:
        value = _run_step(storage, step_id)
    except Exception:
        if storage.status() != WorkflowStatus.CANCELED:
            storage.set_status(WorkflowStatus.RESUMABLE)
        raise
    if final:
        storage.set_status(WorkflowStatus.SUCCESSFUL)
    return value


_step_task = ray_tpu_torch.remote(_run_step_task)


def _launch(storage: WorkflowStorage, entry_step: str, final: bool):
    """Submit the DAG rooted at ``entry_step`` as parallel tasks in
    dependency order; returns the entry step's ref."""
    refs: Dict[str, Any] = {}

    def submit(step_id: str):
        if step_id in refs:
            return refs[step_id]
        meta = storage.step_meta(step_id) or {}
        dep_refs = [submit(d) for d in meta.get("deps", [])]
        refs[step_id] = _step_task.remote(
            storage.base, storage.workflow_id, step_id,
            final and step_id == entry_step, *dep_refs)
        return refs[step_id]

    return submit(entry_step)


def _resolve(storage: WorkflowStorage, obj):
    if isinstance(obj, StepRef):
        return _run_step(storage, obj.step_id)
    if isinstance(obj, list):
        return [_resolve(storage, x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve(storage, x) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve(storage, v) for k, v in obj.items()}
    return obj


def _run_step(storage: WorkflowStorage, step_id: str) -> Any:
    """Idempotent recursive step execution from the durable log — THE
    recovery primitive.  Output checkpoint present -> done.  A recorded
    continuation is resumed instead of re-running the parent's body."""
    if storage.has_output(step_id):
        return storage.load_output(step_id)
    meta = storage.step_meta(step_id) or {}
    cont = meta.get("continuation")
    if cont is not None:
        value = _run_step(storage, cont)
        storage.save_output(step_id, value)
        return value
    fn = storage.load_step_fn(step_id)
    args, kwargs = pickle.loads(storage.load_step_args(step_id))
    args = _resolve(storage, args)
    kwargs = _resolve(storage, kwargs)
    storage.update_step_meta(step_id, state="RUNNING")
    retries = int(meta.get("max_retries", 0))
    attempt = 0
    while True:
        try:
            value = fn(*args, **kwargs)
            break
        except Exception:
            attempt += 1
            if attempt > retries:
                storage.update_step_meta(step_id, state="FAILED")
                raise
    if isinstance(value, StepNode):
        # Continuation: persist its sub-DAG under this step's namespace,
        # record the pointer BEFORE running it (so recovery resumes the
        # continuation instead of re-running this step's body), then
        # execute it inline.
        cont_id = _persist_dag(storage, value, id_prefix=f"{step_id}.")
        storage.update_step_meta(step_id, continuation=cont_id)
        value = _run_step(storage, cont_id)
    storage.save_output(step_id, value)
    return value


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

def resume_workflow(workflow_id: str, base: Optional[str] = None):
    """Resume a crashed/failed workflow from its durable log; returns a
    ref on the final result.  Finished steps are served from their
    checkpoints — only the missing suffix of the DAG re-executes."""
    storage = WorkflowStorage(workflow_id, base or default_base())
    meta = storage.load_workflow()
    if meta is None:
        raise ValueError(f"No workflow record for {workflow_id!r}")
    if not meta.get("entry_step"):
        raise ValueError(
            f"{workflow_id!r} is not a resumable workflow "
            "(virtual-actor records have no step DAG)")
    if meta.get("status") == WorkflowStatus.CANCELED:
        raise ValueError(f"workflow {workflow_id!r} was canceled")
    storage.set_status(WorkflowStatus.RUNNING)
    return _launch(storage, meta["entry_step"], final=True)


# ---------------------------------------------------------------------------
# Virtual actors (durable actors)
# ---------------------------------------------------------------------------

class VirtualActorClass:
    """Parity: reference ``virtual_actor_class.py`` — a class whose
    instances live in workflow storage: state is checkpointed after every
    non-readonly method, so the actor survives any process death."""

    def __init__(self, cls):
        self._cls = cls

    def get_or_create(self, actor_id: str, *args, **kwargs) -> "VirtualActor":
        storage = WorkflowStorage(actor_id)
        if not storage.has_actor(actor_id):
            instance = self._cls(*args, **kwargs)
            storage.save_actor_class(actor_id, self._cls)
            storage.save_actor_state(actor_id, _actor_state(instance), 0)
            storage.save_workflow("", "VIRTUAL_ACTOR")
        return VirtualActor(actor_id, storage)


class VirtualActor:
    """Handle on a durable actor; method calls run through
    ``handle.<method>.run(...)`` / ``.run_async(...)``."""

    def __init__(self, actor_id: str, storage: WorkflowStorage):
        self._actor_id = actor_id
        self._storage = storage
        self._cls = storage.load_actor_class(actor_id)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if not callable(getattr(self._cls, name, None)):
            raise AttributeError(
                f"virtual actor {self._actor_id!r} has no method {name!r}")
        return _VirtualMethod(self, name)

    @contextlib.contextmanager
    def _state_lock(self):
        """Cross-PROCESS mutual exclusion via flock: concurrent method
        calls may execute in different worker processes (process-mode
        pool), where an in-memory lock cannot serialize the
        read-modify-write on state.pkl."""
        import fcntl
        path = self._storage._actor_dir(self._actor_id)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ".lock"), "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)

    def _call(self, method: str, args, kwargs, readonly: bool) -> Any:
        with self._state_lock():
            state, seq = self._storage.load_actor_state(self._actor_id)
            instance = object.__new__(self._cls)
            _restore_state(instance, state)
            result = getattr(instance, method)(*args, **kwargs)
            if not readonly:
                self._storage.save_actor_state(
                    self._actor_id, _actor_state(instance), seq + 1)
            return result


class _VirtualMethod:
    def __init__(self, actor: VirtualActor, name: str):
        self._actor = actor
        self._name = name
        self._readonly = getattr(
            getattr(actor._cls, name), "_workflow_readonly", False)

    def run(self, *args, **kwargs) -> Any:
        return self._actor._call(self._name, args, kwargs, self._readonly)

    def run_async(self, *args, **kwargs):
        return _invoke.remote(self._actor._actor_id, self._name, args,
                              kwargs, self._readonly,
                              self._actor._storage.base)


def _invoke_method(actor_id, name, a, kw, ro, base):
    storage = WorkflowStorage(actor_id, base)
    return VirtualActor(actor_id, storage)._call(name, a, kw, ro)


_invoke = ray_tpu_torch.remote(_invoke_method)


def _actor_state(instance) -> Any:
    if hasattr(instance, "__getstate__"):
        return instance.__getstate__()
    return dict(instance.__dict__)


def _restore_state(instance, state):
    if hasattr(instance, "__setstate__"):
        instance.__setstate__(state)
    else:
        instance.__dict__.update(state)
