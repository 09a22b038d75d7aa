"""Thread-local execution context for worker threads.

A copy of ``ray_tpu._private.worker_context`` for the PyTorch port.

Parity: reference ``WorkerContext`` (src/ray/core_worker/context.cc) — which
task/actor a thread is currently executing, for runtime_context, nested task
ownership (parent_task_id, depth) and PG capture.
"""

from __future__ import annotations

import threading

_tls = threading.local()


class ExecutionContext:
    __slots__ = ("task_spec", "worker", "node", "actor_instance")

    def __init__(self, task_spec=None, worker=None, node=None,
                 actor_instance=None):
        self.task_spec = task_spec
        self.worker = worker
        self.node = node
        self.actor_instance = actor_instance


def set_context(ctx):
    _tls.ctx = ctx


def get_context() -> ExecutionContext:
    return getattr(_tls, "ctx", None) or ExecutionContext()


def clear_context():
    _tls.ctx = None


def current_task_spec():
    return get_context().task_spec


def in_task() -> bool:
    return get_context().task_spec is not None
