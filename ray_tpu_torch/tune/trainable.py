"""Function trainable execution.

A copy of ``ray_tpu.tune.trainable`` for the PyTorch port.

Parity: reference ``python/ray/tune/function_runner.py`` — the user
function runs in a background thread inside a trial actor;
``tune.report(**metrics)`` enqueues intermediate results the runner
drains; ``tune.checkpoint_dir``-style checkpointing is expressed here as
``tune.save_checkpoint(**state)`` / ``tune.load_checkpoint()`` (dict
checkpoints, consistent with ray_tpu_torch.train). Class trainables subclass
:class:`Trainable` (reference ``trainable.py``: setup/step/
save_checkpoint/load_checkpoint).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

_tune_session = threading.local()


class _Event:
    __slots__ = ("type", "data")

    def __init__(self, type, data):  # noqa: A002
        self.type = type  # report | checkpoint | done | error
        self.data = data


def report(**metrics):
    s = getattr(_tune_session, "session", None)
    if s is None:
        raise RuntimeError("tune.report() called outside a tune run")
    s.put(_Event("report", dict(metrics)))


def save_checkpoint(**state):
    s = getattr(_tune_session, "session", None)
    if s is None:
        raise RuntimeError("tune.save_checkpoint() outside a tune run")
    s.put(_Event("checkpoint", dict(state)))


def load_checkpoint() -> Optional[Dict]:
    s = getattr(_tune_session, "session", None)
    return s.loaded_checkpoint if s else None


def get_trial_id() -> Optional[str]:
    s = getattr(_tune_session, "session", None)
    return s.trial_id if s else None


class Trainable:
    """Class API (reference trainable.py): override setup/step/
    save_checkpoint/load_checkpoint."""

    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Dict[str, Any]:
        return {}

    def load_checkpoint(self, checkpoint: Dict[str, Any]):
        pass

    def cleanup(self):
        pass


class _Session:
    def __init__(self, trial_id: str, checkpoint: Optional[Dict]):
        self.trial_id = trial_id
        self.loaded_checkpoint = checkpoint
        self._q: "queue.Queue[_Event]" = queue.Queue()
        self._final: Optional[_Event] = None

    def put(self, ev: _Event):
        self._q.put(ev)

    def get_next(self, timeout: float = 300.0) -> _Event:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            pass
        if self._final is not None:
            return self._final
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return _Event("timeout", None)


class TrialRunnerActor:
    """The per-trial actor (reference: wrapped trainable actor inside
    RayTrialExecutor). Runs either a function or a Trainable subclass."""

    def __init__(self):
        self._session: Optional[_Session] = None
        self._stop = threading.Event()

    def start(self, trainable, config: Dict, trial_id: str,
              checkpoint: Optional[Dict] = None):
        from ray_tpu_torch._private import worker_context
        session = _Session(trial_id, checkpoint)
        self._session = session
        self._stop.clear()
        parent_ctx = worker_context.get_context()
        stop = self._stop

        def run():
            worker_context.set_context(parent_ctx)
            _tune_session.session = session
            try:
                if isinstance(trainable, type) and \
                        issubclass(trainable, Trainable):
                    obj = trainable()
                    obj.setup(dict(config))
                    if checkpoint:
                        obj.load_checkpoint(checkpoint)
                    while not stop.is_set():
                        result = obj.step()
                        session.put(_Event("checkpoint",
                                           obj.save_checkpoint()))
                        session.put(_Event("report", result))
                        if result.get("done"):
                            break
                    obj.cleanup()
                    final = _Event("done", None)
                else:
                    out = trainable(dict(config))
                    final = _Event("done", out)
                session._final = final
                session.put(final)
            except BaseException as e:  # noqa: BLE001
                session._final = _Event("error", e)
                session.put(session._final)
            finally:
                _tune_session.session = None
        threading.Thread(target=run, daemon=True,
                         name=f"tune-{trial_id}").start()
        return True

    def get_next(self, timeout: float = 300.0):
        if self._session is None:
            return _Event("error", RuntimeError("trial not started"))
        return self._session.get_next(timeout)

    def request_stop(self):
        self._stop.set()
        return True
