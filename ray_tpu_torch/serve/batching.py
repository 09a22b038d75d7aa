"""@serve.batch: transparent, latency-aware request batching inside a
replica.

A copy of ``ray_tpu.serve.batching`` for the PyTorch port.  Where the
reference takes ``diag_lock`` (its lock-order witness, ROADMAP A.4b.7b)
the port takes a plain ``threading.Lock``, and a failed metrics
observation is logged and counted (``handle.noted``).

Parity: reference ``python/ray/serve/batching.py`` — concurrent calls
to the decorated method are queued; a flusher invokes the underlying
function ONCE with the list of requests when ``max_batch_size`` is
reached or the flush deadline elapses; each caller gets its own
element of the returned list.  Callers are concurrent actor-thread
requests here (the reference's are asyncio tasks).

Adaptive flush (the serving-under-load lever): instead of a fixed
``batch_wait_timeout_s``, the queue tracks an EWMA of the batch
function's own execution latency and schedules each batch's flush so
the OLDEST pending request completes within the latency budget —
``wait = budget - exec_ewma``.  Under light load batches flush almost
immediately (small batches, low latency); under heavy load the queue
fills to ``max_batch_size`` before the timer fires (large batches, max
throughput) — batch size adapts to offered load with a hard latency
ceiling.  Per-queue batch-size and fill-ratio histograms are exported
at /metrics labelled by deployment (see :func:`set_batch_context`).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Optional


# Thread-local batching context: the replica stamps the deployment name
# before invoking user code so flush metrics are labelled per
# deployment (a bare function queue outside a replica reads "driver").
_batch_ctx = threading.local()


def set_batch_context(deployment: Optional[str]) -> None:
    _batch_ctx.deployment = deployment


def _current_deployment() -> str:
    return getattr(_batch_ctx, "deployment", None) or "driver"


class _Pending:
    __slots__ = ("arg", "event", "result", "error", "enqueued_ts",
                 "deployment")

    def __init__(self, arg):
        self.arg = arg
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued_ts = time.monotonic()
        self.deployment = _current_deployment()


class _BatchQueue:
    """One queue per decorated function (per instance for methods).

    ``latency_budget_s`` arms the adaptive flush; when ``None`` the
    fixed ``batch_wait_timeout_s`` is the deadline (reference
    behavior).  Flush scheduling is generation-counted: a timer armed
    for batch generation G flushes ONLY generation G — a full-batch
    flush that races the timer can never early-drain the next batch.
    """

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float,
                 latency_budget_s: Optional[float] = None):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._budget = latency_budget_s
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._generation = 0        # bumped every time the queue drains
        self._timer: Optional[threading.Timer] = None
        self._closed = False
        # EWMA of the batch fn's execution latency (seconds); seeds at
        # zero so the first flush waits the full budget.
        self._exec_ewma = 0.0
        self._ewma_alpha = 0.3
        self.stats = {"flushes": 0, "full_flushes": 0, "timer_flushes": 0,
                      "requests": 0, "errors": 0}

    # -- flush-delay policy ---------------------------------------------
    def _flush_delay(self) -> float:
        if self._budget is None:
            return self._timeout
        # Leave room for the batch's own execution so the oldest
        # request's end-to-end latency stays inside the budget.
        return max(0.0005, self._budget - self._exec_ewma)

    def submit(self, self_obj, arg) -> Any:
        p = _Pending(arg)
        flush_now = False
        with self._lock:
            if self._closed:
                raise RuntimeError("@serve.batch queue is shut down")
            self._queue.append(p)
            self.stats["requests"] += 1
            if len(self._queue) >= self._max:
                flush_now = True
            elif self._timer is None:
                gen = self._generation
                t = threading.Timer(self._flush_delay(), self._timer_flush,
                                    (self_obj, gen))
                t.daemon = True
                self._timer = t
                t.start()
        if flush_now:
            self._flush(self_obj, full=True)
        p.event.wait(timeout=60.0)
        if p.error is not None:
            raise p.error
        return p.result

    def _timer_flush(self, self_obj, gen: int):
        with self._lock:
            if gen != self._generation:
                return          # that batch already flushed full
        self._flush(self_obj, full=False)

    def _take_batch(self) -> List[_Pending]:
        """Drain the queue under the lock; bumps the generation so any
        armed timer for the drained batch becomes a no-op."""
        with self._lock:
            batch, self._queue = self._queue, []
            self._generation += 1
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            return batch

    def _flush(self, self_obj, full: bool):
        batch = self._take_batch()
        if not batch:
            return
        self.stats["flushes"] += 1
        self.stats["full_flushes" if full else "timer_flushes"] += 1
        self._observe_batch(batch)
        started = time.monotonic()
        try:
            args = [p.arg for p in batch]
            results = self._fn(self_obj, args) if self_obj is not None \
                else self._fn(args)
            if len(results) != len(batch):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results "
                    f"for a batch of {len(batch)}")
            for p, r in zip(batch, results):
                # An Exception element fails ONLY that caller — one bad
                # request in a batch must not poison its neighbors.
                if isinstance(r, BaseException):
                    p.error = r
                    self.stats["errors"] += 1
                else:
                    p.result = r
                p.event.set()
        except BaseException as e:  # noqa: BLE001
            self.stats["errors"] += len(batch)
            for p in batch:
                p.error = e
                p.event.set()
        finally:
            took = time.monotonic() - started
            with self._lock:
                self._exec_ewma = (took if self._exec_ewma == 0.0 else
                                   self._ewma_alpha * took +
                                   (1 - self._ewma_alpha) * self._exec_ewma)

    def _observe_batch(self, batch: List[_Pending]):
        try:
            from ray_tpu_torch._private.metrics_agent import observe_internal
            deployment = batch[0].deployment
            observe_internal(
                "ray_tpu_serve_batch_size", float(len(batch)),
                buckets=(1, 2, 4, 8, 16, 32, 64, 128),
                deployment=deployment)
            observe_internal(
                "ray_tpu_serve_batch_fill_ratio",
                len(batch) / max(1, self._max),
                buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
                deployment=deployment)
            oldest_wait = time.monotonic() - batch[0].enqueued_ts
            observe_internal(
                "ray_tpu_serve_batch_wait_seconds", oldest_wait,
                deployment=deployment)
        except Exception as e:   # metrics must never fail a batch
            from ray_tpu_torch.serve.handle import noted
            noted("serve.batching.metrics", e)

    def close(self):
        """Teardown: fail every pending request loudly instead of
        leaving callers parked on their events for the 60s cap."""
        with self._lock:
            self._closed = True
            pending, self._queue = self._queue, []
            self._generation += 1
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        err = RuntimeError("@serve.batch queue shut down with pending "
                           "requests (replica stopping)")
        for p in pending:
            p.error = err
            p.event.set()


# Queues are created lazily in the replica process (a queue holds
# threading primitives, which must not be pickled with the deployment
# definition).  Bound methods store their queue in the owning instance's
# __dict__ so it dies with the replica; bare functions use a module-level
# registry bounded by the number of decorated functions.  The wrapper
# reaches them only through _get_queue — an importable module-level
# function that cloudpickle serializes by reference, keeping the
# lock/registry out of the pickle.
_FN_QUEUES: dict = {}
_QUEUES_LOCK = threading.Lock()
_INSTANCE_ATTR = "_serve_batch_queues"


def _get_queue(self_obj, fn, max_batch_size, batch_wait_timeout_s,
               latency_budget_s=None):
    with _QUEUES_LOCK:
        if self_obj is not None:
            registry = self_obj.__dict__.setdefault(_INSTANCE_ATTR, {})
            key = fn.__qualname__
        else:
            # Keyed by (module, qualname): two same-named functions in
            # different modules must not share one queue (or the second
            # function's requests would be executed by the first).
            registry, key = _FN_QUEUES, (fn.__module__, fn.__qualname__)
        queue = registry.get(key)
        if queue is None:
            queue = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s,
                                latency_budget_s)
            registry[key] = queue
        return queue


def close_instance_queues(self_obj) -> None:
    """Close every batch queue owned by ``self_obj`` (replica
    teardown)."""
    queues = self_obj.__dict__.get(_INSTANCE_ATTR) or {}
    for q in list(queues.values()):
        q.close()


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01,
          latency_budget_s: Optional[float] = None):
    """Decorator: ``@serve.batch`` or ``@serve.batch(max_batch_size=...,
    batch_wait_timeout_s=..., latency_budget_s=...)``.

    ``latency_budget_s`` switches the flush deadline from the fixed
    ``batch_wait_timeout_s`` to the adaptive policy: each batch waits
    ``budget - EWMA(exec latency)`` so end-to-end latency of the oldest
    request tracks the budget while batch size grows with load."""

    def wrap(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:   # bound method: (self, request)
                self_obj, arg = args
            else:
                self_obj, arg = None, args[0]
            queue = _get_queue(self_obj, fn, max_batch_size,
                               batch_wait_timeout_s, latency_budget_s)
            return queue.submit(self_obj, arg)
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
