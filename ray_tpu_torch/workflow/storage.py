"""Durable workflow storage: every step's function, inputs, and output
checkpointed to the filesystem.

A copy of ``ray_tpu.workflow.storage`` for the PyTorch port, with the
reference's on-disk layout (below) and atomic writes (a temporary file,
then a rename), so either package reads the other's records.  The base
directory is ``<temp_dir>/workflows`` of the port's config unless
``workflow.init(storage)`` names one.

Parity: reference ``python/ray/workflow/workflow_storage.py`` (step
input/output checkpoints keyed by workflow_id/step_id, workflow status
records, atomic writes) and ``workflow/storage/filesystem.py`` (the fs
backend: write-to-temp + rename for atomicity).

Layout::

    <base>/<workflow_id>/
        workflow.json                 # {entry_step, status}
        steps/<step_id>/
            fn.pkl                    # cloudpickled step function
            args.pkl                  # args with StepRef placeholders
            meta.json                 # {name, deps, state}
            output.pkl                # present iff the step finished
        actors/<actor_id>/
            class.pkl
            state.pkl                 # latest durable actor state
            seq                       # method-log sequence number
"""

from __future__ import annotations

import json
import os
import cloudpickle as pickle  # locals-safe: steps/args may close over test-local classes
import tempfile
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.serialization import dumps_function, loads_function


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"
    CANCELED = "CANCELED"


def _atomic_write(path: str, data: bytes):
    """Write-then-rename so a crash never leaves a torn checkpoint
    (reference filesystem storage does exactly this)."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class WorkflowStorage:
    """One workflow's durable record."""

    def __init__(self, workflow_id: str, base: Optional[str] = None):
        self.workflow_id = workflow_id
        self.base = base or default_base()
        self.root = os.path.join(self.base, workflow_id)
        self._lock = threading.Lock()

    # ---- workflow-level record -----------------------------------------
    def save_workflow(self, entry_step: str, status: str):
        _atomic_write(
            os.path.join(self.root, "workflow.json"),
            json.dumps({"entry_step": entry_step,
                        "status": status}).encode())

    def load_workflow(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, "workflow.json"), "rb") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None

    def set_status(self, status: str):
        meta = self.load_workflow() or {"entry_step": ""}
        self.save_workflow(meta["entry_step"], status)

    def status(self) -> Optional[str]:
        meta = self.load_workflow()
        return None if meta is None else meta.get("status")

    # ---- step records ---------------------------------------------------
    def _step_dir(self, step_id: str) -> str:
        return os.path.join(self.root, "steps", step_id)

    def save_step(self, step_id: str, fn, args_blob: bytes, name: str,
                  deps: List[str], max_retries: int = 0):
        d = self._step_dir(step_id)
        _atomic_write(os.path.join(d, "fn.pkl"), dumps_function(fn))
        _atomic_write(os.path.join(d, "args.pkl"), args_blob)
        _atomic_write(os.path.join(d, "meta.json"), json.dumps({
            "name": name, "deps": deps, "state": "PENDING",
            "max_retries": max_retries}).encode())

    def step_meta(self, step_id: str) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_dir(step_id),
                                   "meta.json"), "rb") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None

    def update_step_meta(self, step_id: str, **updates):
        with self._lock:
            meta = self.step_meta(step_id) or {}
            meta.update(updates)
            _atomic_write(os.path.join(self._step_dir(step_id), "meta.json"),
                          json.dumps(meta).encode())

    def load_step_fn(self, step_id: str):
        with open(os.path.join(self._step_dir(step_id), "fn.pkl"), "rb") as f:
            return loads_function(f.read())

    def load_step_args(self, step_id: str) -> bytes:
        with open(os.path.join(self._step_dir(step_id), "args.pkl"),
                  "rb") as f:
            return f.read()

    def save_output(self, step_id: str, value: Any):
        _atomic_write(os.path.join(self._step_dir(step_id), "output.pkl"),
                      pickle.dumps(value, protocol=5))
        self.update_step_meta(step_id, state="DONE")

    def has_output(self, step_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._step_dir(step_id), "output.pkl"))

    def load_output(self, step_id: str) -> Any:
        with open(os.path.join(self._step_dir(step_id), "output.pkl"),
                  "rb") as f:
            return pickle.loads(f.read())

    def list_steps(self) -> List[str]:
        d = os.path.join(self.root, "steps")
        try:
            return sorted(os.listdir(d))
        except OSError:
            return []

    # ---- virtual-actor records -----------------------------------------
    def _actor_dir(self, actor_id: str) -> str:
        return os.path.join(self.root, "actors", actor_id)

    def save_actor_class(self, actor_id: str, cls):
        _atomic_write(os.path.join(self._actor_dir(actor_id), "class.pkl"),
                      dumps_function(cls))

    def load_actor_class(self, actor_id: str):
        with open(os.path.join(self._actor_dir(actor_id), "class.pkl"),
                  "rb") as f:
            return loads_function(f.read())

    def save_actor_state(self, actor_id: str, state: Any, seq: int):
        d = self._actor_dir(actor_id)
        _atomic_write(os.path.join(d, "state.pkl"),
                      pickle.dumps(state, protocol=5))
        _atomic_write(os.path.join(d, "seq"), str(seq).encode())

    def load_actor_state(self, actor_id: str):
        d = self._actor_dir(actor_id)
        with open(os.path.join(d, "state.pkl"), "rb") as f:
            state = pickle.loads(f.read())
        try:
            with open(os.path.join(d, "seq"), "rb") as f:
                seq = int(f.read())
        except (OSError, ValueError):
            seq = 0
        return state, seq

    def has_actor(self, actor_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._actor_dir(actor_id), "state.pkl"))

    def delete(self):
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)


_base_override: Optional[str] = None


def set_base(path: Optional[str]):
    global _base_override
    _base_override = path


def default_base() -> str:
    return _base_override or os.path.join(get_config().temp_dir, "workflows")


def list_workflows(base: Optional[str] = None) -> Dict[str, str]:
    """workflow_id -> status for every workflow in storage."""
    b = base or default_base()
    out: Dict[str, str] = {}
    try:
        ids = os.listdir(b)
    except OSError:
        return out
    for wid in ids:
        st = WorkflowStorage(wid, b).status()
        if st is not None:
            out[wid] = st
    return out
