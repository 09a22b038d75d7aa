"""Per-worker training session.

A copy of ``ray_tpu.train.session`` for the PyTorch port (reference
``python/ray/train/session.py``): a ``Session`` for each run of the
training function, in a thread of its own with a ``threading.local``
session; ``train.report`` hands metrics to the driver between
iterations, ``save_checkpoint``/``load_checkpoint`` round-trip state,
``world_rank``/``local_rank``/``world_size`` expose topology.  The
session feeds an ordered event queue that the driver drains via actor
calls.  A checkpoint is kept as host forms: a CUDA tensor in it is
copied to the CPU on the worker, when it is saved (ROADMAP C.27).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional


class TrainingResult:
    __slots__ = ("type", "data")

    def __init__(self, type: str, data):  # noqa: A002
        self.type = type  # "report" | "checkpoint" | "done" | "error"
        self.data = data

    def __repr__(self):
        return f"TrainingResult({self.type}, {self.data!r})"


class Session:
    def __init__(self, training_fn, world_rank: int, local_rank: int,
                 world_size: int, checkpoint: Optional[Dict] = None):
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.loaded_checkpoint = checkpoint
        self._queue: "queue.Queue[TrainingResult]" = queue.Queue()
        self._fn = training_fn
        self._thread: Optional[threading.Thread] = None
        self._final: Optional[TrainingResult] = None

    # ---- worker side -----------------------------------------------------
    def start(self):
        # Propagate the actor's execution context into the training
        # thread: collective groups and runtime_context are keyed by the
        # (thread-local) worker context of the actor task that set them up.
        from ray_tpu_torch._private import worker_context
        parent_ctx = worker_context.get_context()

        def run():
            worker_context.set_context(parent_ctx)
            _session_local.session = self
            try:
                result = self._fn()
                self._final = TrainingResult("done", result)
            except BaseException as e:  # noqa: BLE001
                self._final = TrainingResult("error", e)
            finally:
                self._queue.put(self._final)
                _session_local.session = None
        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"train-{self.world_rank}")
        self._thread.start()

    def report(self, **metrics):
        self._queue.put(TrainingResult("report", dict(metrics)))

    def save_checkpoint(self, **checkpoint):
        from ray_tpu_torch.train.checkpoint import host_forms
        self._queue.put(TrainingResult("checkpoint",
                                       host_forms(dict(checkpoint))))

    # ---- driver side (via actor RPC) ------------------------------------
    def get_next(self, timeout: float = 300.0) -> TrainingResult:
        """Next event; once finished, keeps returning the final result so
        a driver polling mixed-progress workers never blocks on a
        completed rank."""
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._final is not None:
            return self._final
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return TrainingResult("timeout", None)


_session_local = threading.local()


def get_session() -> Session:
    s = getattr(_session_local, "session", None)
    if s is None:
        raise RuntimeError(
            "No training session active: train.report()/world_rank() are "
            "only valid inside a function passed to Trainer.run().")
    return s


# ---- public API used inside train functions ------------------------------

def report(**metrics):
    get_session().report(**metrics)


def save_checkpoint(**checkpoint):
    get_session().save_checkpoint(**checkpoint)


def load_checkpoint() -> Optional[Dict]:
    return get_session().loaded_checkpoint


def world_rank() -> int:
    return get_session().world_rank


def local_rank() -> int:
    return get_session().local_rank


def world_size() -> int:
    return get_session().world_size
