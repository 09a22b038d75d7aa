"""User-facing exception hierarchy.

A copy of ``ray_tpu.exceptions`` for the PyTorch port, whole: the
reference's ``python/ray/exceptions.py`` (RayError, RayTaskError wrapping
the remote traceback, RayActorError, ObjectLostError, TaskCancelledError,
GetTimeoutError, ...).  ``TaskError.as_instanceof_cause`` gives an
instance of the cause's own class, so ``except ValueError`` works across
the task boundary.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


# Alias matching the reference naming so library code reads the same.
RayError = RayTpuError


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Wraps the remote exception plus its traceback string; re-raised at
    ``get`` on the caller side (reference: exceptions.py RayTaskError).
    """

    def __init__(self, cause: BaseException, task_desc: str = "",
                 tb: str | None = None):
        self.cause = cause
        self.task_desc = task_desc
        self.traceback_str = tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__))
        # The formatted string above is the durable record; drop the frame
        # chain — stored error objects otherwise pin the executor's and the
        # user function's locals (including deserialized arg refs) for as
        # long as the error is retrievable (reference: RayTaskError ships
        # text, never traceback objects).
        cause.__traceback__ = None
        super().__init__(
            f"Task {task_desc} failed:\n{self.traceback_str}")

    def __reduce__(self):
        # Default Exception pickling would re-run __init__ with the
        # formatted message as ``cause``; preserve the real fields so the
        # error survives the process-worker / multi-host wire.
        return (TaskError, (self.cause, self.task_desc, self.traceback_str))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the cause's class so
        ``except UserError`` works across the task boundary."""
        cause_cls = type(self.cause)
        if cause_cls is TaskError:
            return self.cause
        try:
            err = cause_cls(*getattr(self.cause, "args", ()))
            err.__cause__ = self
            return err
        except Exception:
            return self


RayTaskError = TaskError


class ActorError(RayTpuError):
    """Actor died before/while executing a method (reference: RayActorError)."""

    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        super().__init__(f"Actor {actor_id} unavailable: {reason}")


RayActorError = ActorError


class ActorDiedError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object's value was lost (all copies gone, lineage exhausted)."""

    def __init__(self, object_id=None, reason: str = "object lost"):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost: {reason}")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_id=None):
        super().__init__(object_id, "owner died")


class ObjectStoreFullError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    def __init__(self, node_id=None):
        self.node_id = node_id
        super().__init__(f"Node {node_id} died")


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass
