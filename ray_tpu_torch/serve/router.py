"""Router: picks a replica for each request.

A copy of ``ray_tpu.serve.router`` for the PyTorch port: a plain
``threading.Condition`` where the reference takes ``diag_condition``,
and ``handle.noted`` where it calls ``swallow.noted``.  The
``serve.request`` fault point at the dispatch site is left out: it comes
with the fault points (ROADMAP A.4b.7b).

Parity: reference ``python/ray/serve/router.py:170`` —
``Router.assign_request``: round-robin over the replica set with
backpressure (skip replicas at ``max_concurrent_queries``; block when
all are saturated), replica set refreshed via the controller long-poll
(``long_poll.py`` ``LongPollClient``).

Load signals: the router counts callers parked in ``assign_request``
(the true request queue — replicas only ever see ``max_concurrent``
of them) and ships that depth to the controller on a small reporter
thread; together with the replicas' in-flight counts it is the
autoscaler's queue-depth signal.

Failure handling: :meth:`call` (the blocking path used by the HTTP
proxy and ``DeploymentHandle.call``) re-assigns a request whose replica
died mid-flight — the dead replica is evicted from the local set
immediately (no waiting for the controller's health check), the
request retries on a survivor up to ``serve_request_retries`` times,
and the client sees exactly one response or an error that names the
deployment, the attempts, and the underlying death.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Dict, List, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.serve.handle import noted


class ReplicaDiedError(exceptions.RayTpuError):
    """A serve request ran out of replica-death retries; carries the
    attribution the client needs (deployment, attempts, last error)."""

    def __init__(self, deployment: str, attempts: int,
                 cause: BaseException):
        self.deployment = deployment
        self.attempts = attempts
        self.cause = cause
        super().__init__(
            f"deployment {deployment!r}: replica died mid-request "
            f"({attempts} attempt(s)); last error: "
            f"{type(cause).__name__}: {cause}")


#: Failures that mean "the replica is gone", not "the request is bad" —
#: the only ones the router may transparently re-assign.
_DEATH_ERRORS = (exceptions.ActorError, exceptions.WorkerCrashedError,
                 exceptions.NodeDiedError, exceptions.OwnerDiedError)


def controller_alive() -> bool:
    """Whether the serve controller actor is still registered."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    try:
        ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return True
    except Exception:
        return False


class Router:
    def __init__(self, controller, deployment_name: str,
                 max_concurrent_queries: int = 100):
        self._controller = controller
        self._name = deployment_name
        self._router_id = uuid.uuid4().hex[:12]
        self._max_q = max_concurrent_queries
        self._replicas: List = []
        self._inflight: Dict[int, int] = {}  # replica idx -> inflight
        self._rr = itertools.count()
        self._lock = threading.Condition()
        self._version = -1
        self._queued = 0          # callers parked in assign_request
        self._stopped = threading.Event()
        self.stats = {"requests": 0, "death_retries": 0,
                      "evicted_replicas": 0}
        self._refresh(block=True)
        self._poll_thread = threading.Thread(
            target=self._long_poll_loop, daemon=True,
            name=f"serve-router-{deployment_name}")
        self._poll_thread.start()
        self._report_thread = threading.Thread(
            target=self._report_loop, daemon=True,
            name=f"serve-router-report-{deployment_name}")
        self._report_thread.start()

    # ---- replica set maintenance ---------------------------------------
    def _refresh(self, block: bool = False):
        deadline = time.monotonic() + 10.0
        while True:
            handles = ray_tpu_torch.get(
                self._controller.get_replica_handles.remote(self._name))
            if handles or not block:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for deployment {self._name!r}")
            time.sleep(0.05)
        with self._lock:
            self._replicas = handles
            self._inflight = {i: 0 for i in range(len(handles))}
            self._lock.notify_all()

    def _evict_replica(self, replica) -> None:
        """Drop a dead replica from the local set NOW — re-assignment
        must not wait for the controller's next health-check pass."""
        with self._lock:
            if replica not in self._replicas:
                return
            self._replicas = [r for r in self._replicas if r is not replica]
            self._inflight = {i: 0 for i in range(len(self._replicas))}
            self.stats["evicted_replicas"] += 1
            self._lock.notify_all()

    def stop(self):
        """Stop the long-poll + reporter threads (router unusable)."""
        self._stopped.set()

    def _long_poll_loop(self):
        # A transient listen_for_change failure must not pin a stale
        # replica set forever: retry with backoff and exit only when the
        # router is stopped or the controller is confirmed gone.
        backoff = 0.05
        while not self._stopped.is_set():
            try:
                version = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._version, 5.0))
                backoff = 0.05
                if self._stopped.is_set():
                    return
                if version != self._version:
                    self._version = version
                    self._refresh()
            except Exception as e:
                if self._stopped.is_set() or not controller_alive():
                    return
                noted("serve.router.long_poll", e)
                self._stopped.wait(backoff)
                backoff = min(backoff * 2, 2.0)

    def _report_loop(self):
        """Ship this router's parked-caller depth to the controller —
        the autoscaler's queue-depth sample.  Idle routers go silent
        after one zero report (no steady-state chatter)."""
        interval = get_config().serve_router_report_interval_s
        last = -1
        while not self._stopped.is_set():
            with self._lock:
                queued = self._queued
            if queued != 0 or last != 0:
                try:
                    self._controller.report_router_queue.remote(
                        self._name, self._router_id, queued)
                except Exception as e:
                    if self._stopped.is_set() or not controller_alive():
                        return
                    noted("serve.router.report", e)
                try:
                    from ray_tpu_torch._private.metrics_agent import (
                        get_metrics_registry)
                    reg = get_metrics_registry()
                    reg.register("ray_tpu_serve_router_queued", "gauge")
                    reg.set("ray_tpu_serve_router_queued", float(queued),
                            (("deployment", self._name),))
                except Exception as e:
                    noted("serve.router.report_metrics", e)
            last = queued
            self._stopped.wait(interval)

    # ---- request path ---------------------------------------------------
    def _assign(self, method_name: str, args, kwargs) -> Tuple:
        """Pick a replica (round-robin + backpressure) and submit.
        Returns ``(ref, replica_handle)``."""
        deadline = time.monotonic() + 30.0
        with self._lock:
            self._queued += 1
        try:
            while True:
                with self._lock:
                    n = len(self._replicas)
                    if n:
                        for _ in range(n):
                            i = next(self._rr) % n
                            if self._inflight.get(i, 0) < self._max_q:
                                self._inflight[i] = \
                                    self._inflight.get(i, 0) + 1
                                replica = self._replicas[i]
                                break
                        else:
                            replica = None
                    else:
                        replica = None
                    if replica is None:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"deployment {self._name!r}: all replicas "
                                "saturated for 30s")
                        self._lock.wait(timeout=0.1)
                        continue
                ref = replica.handle_request.remote(
                    method_name, args, kwargs)
                self._track(ref, i)
                self.stats["requests"] += 1
                return ref, replica
        finally:
            with self._lock:
                self._queued -= 1

    def assign_request(self, method_name: str, args, kwargs):
        """Round-robin with backpressure; returns an ObjectRef."""
        ref, _replica = self._assign(method_name, args, kwargs)
        return ref

    def call(self, method_name: str, args, kwargs,
             timeout: float = 60.0):
        """Blocking request with replica-death re-assignment: the path
        the HTTP proxy rides.  Retries ONLY on replica death (never on
        user exceptions), evicting the dead replica locally so the
        retry lands on a survivor; after ``serve_request_retries``
        deaths the client gets a :class:`ReplicaDiedError` naming the
        deployment and attempts."""
        retries = get_config().serve_request_retries
        attempt = 0
        while True:
            attempt += 1
            ref, replica = self._assign(method_name, args, kwargs)
            try:
                return ray_tpu_torch.get(ref, timeout=timeout)
            except _DEATH_ERRORS as e:
                self._evict_replica(replica)
                if attempt > retries:
                    raise ReplicaDiedError(self._name, attempt, e) from e
                self.stats["death_retries"] += 1

    def _track(self, ref, idx: int):
        def done(_fut):
            with self._lock:
                if idx in self._inflight:
                    self._inflight[idx] -= 1
                self._lock.notify_all()
        ref.future().add_done_callback(done)
