"""Cluster-level scheduling queues + the scheduling tick.

A port of ``ray_tpu._private.cluster_task_manager`` for the PyTorch port:
per-scheduling-class FIFO queues, the periodic and event-driven
``schedule_and_dispatch`` tick, spillback, and infeasible queues parked
and retried on cluster change.  With ``scheduler_backend="torch"`` (the
default) whole queues are solved in one ``DeviceRuntimeSolver`` call on
the raylet's device, and every grant and spillback is validated against
the exact fixed-point vectors before commit; with ``"native"`` each task
is placed by the greedy policy.

Divergence on a device failure: where ``solve`` returns None (invalid
output, nnz overflow, the class-row cap, no nodes) the work is requeued
and the same tick runs the greedy pass, counted in ``jnp_fallbacks``, as
in the reference.  Where ``solve`` raises (a device or kernel failure),
the popped work goes back to its queues, ``tick_stats["device_errors"]``
counts it and the exception propagates: the tick makes no greedy
placement.  The reference instead catches the exception and goes greedy,
which would hide a failing device behind a slower scheduler.

Divergence on a spilled lease: a lease re-sent to the raylet a spillback
named may carry ``grant_or_reject`` (Ray's ``RequestWorkerLease`` field
of that name).  Such a lease is granted on this node if it fits here now
and is otherwise rejected back to its submitter; it is never spilled
again.  The reference has no such flag: its submitter re-leases each
spillback as a fresh lease, and leases that reach a raylet together go
through the batched solve, whose fill order is rotated per class and
per view, so two raylets whose solves each rank the other first spill
the same leases back and forth for as long as neither view changes.
Without the flag the port behaves as the reference does.

The reference's flight recorder, tracing spans, fault-injection points
and task-lifecycle events are debug and GCS planes the port does not
have yet.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  observe_internal,
                                                  record_internal)
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch._private.thread_registry import loop_only
from ray_tpu_torch.scheduler import policy as policy_mod

logger = logging.getLogger(__name__)

# Consecutive pop->dispatch failures of one task before the lease is
# rejected back to the submitter: bounds the requeue loop under a
# deterministic fault.
_MAX_DISPATCH_REQUEUES = 20

# Tick-latency histogram bounds (seconds).
_TICK_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 1.0)


class _LeaseBatch:
    """Collector for one batched lease request: N entries, ONE reply,
    fired when the last entry resolves, with the ordered results."""

    __slots__ = ("results", "_remaining", "_reply", "_lock")

    def __init__(self, n: int, reply: Callable):
        self.results: list = [None] * n
        self._remaining = n
        self._reply = reply
        self._lock = threading.Lock()

    def resolve(self, idx: int, result: dict) -> None:
        with self._lock:
            if self.results[idx] is not None:
                return          # duplicate resolution: first wins
            self.results[idx] = result
            self._remaining -= 1
            done = self._remaining == 0
        if done:
            self._reply({"results": self.results})


class _BatchEntry:
    """Per-entry reply callable of a :class:`_LeaseBatch`; the backlog
    sweep recognizes batch entries by this type."""

    __slots__ = ("batch", "idx")

    def __init__(self, batch: _LeaseBatch, idx: int):
        self.batch = batch
        self.idx = idx

    def __call__(self, result: dict) -> None:
        self.batch.resolve(self.idx, result)


def _collect(mgr: "ClusterTaskManager") -> None:
    """Scrape-time collector of one manager's tick telemetry."""
    label = {"node": mgr._node_label}
    for k, v in mgr.tick_stats.items():
        record_internal(f"ray_tpu.scheduler.tick.{k}", v, **label)
    for k, v in mgr._raylet.lease_stats.items():
        record_internal(f"ray_tpu.scheduler.{k}", v, **label)
    record_internal("ray_tpu.scheduler.pending_queue_depth",
                    mgr.num_queued(), **label)
    # The latency histogram is observed on the tick path: claim its
    # series so that it dies with this manager.
    get_metrics_registry().claim_series(
        "ray_tpu.scheduler.tick_latency", **label)


class ClusterTaskManager:
    def __init__(self, raylet):
        self._raylet = raylet
        self._lock = threading.RLock()
        self._queues: Dict[int, deque] = defaultdict(deque)
        self._infeasible: Dict[int, deque] = defaultdict(deque)
        self._solver = None
        # True while a tick is scheduled but not started: further
        # wakeups inside the debounce window fold into it.
        self._wakeup_pending = False
        # Lease batches whose unresolved entries the next tick's sweep
        # may withdraw as backlog; a batch is swept only by a pass that
        # started after it was queued.
        self._pending_batches: list = []
        # Re-sent spillbacks: granted here or rejected on the next tick.
        self._grant_or_reject: deque = deque()
        self._node_label = self._raylet.node_id.hex()[:12]
        self.tick_stats = {"ticks": 0, "busy_ticks": 0,
                           "spillbacks": 0,
                           # Spillbacks by reason: no_capacity = the
                           # local node could not run the task now;
                           # locality_override = the cost-aware solve
                           # moved a locally runnable task elsewhere.
                           "spillbacks_no_capacity": 0,
                           "spillbacks_locality_override": 0,
                           # Ticks whose device solve returned None and
                           # went greedy (the reference's metric name).
                           "jnp_fallbacks": 0,
                           "last_batch_classes": 0, "last_batch_tasks": 0,
                           "dispatch_errors": 0,
                           # Ticks whose device solve raised.
                           "device_errors": 0,
                           # grant_or_reject leases this node could not
                           # run and rejected.
                           "spillback_rejections": 0}
        # Consecutive failed dispatch handoffs per task (cleared on
        # success): past _MAX_DISPATCH_REQUEUES the lease is rejected.
        self._dispatch_failures: Dict = {}
        get_metrics_registry().register_collector(self, _collect)

    # ---- entry (HandleRequestWorkerLease -> QueueAndScheduleTask) -------
    def queue_and_schedule(self, spec: TaskSpec, reply: Callable,
                           grant_or_reject: bool = False):
        with self._lock:
            if grant_or_reject:
                self._grant_or_reject.append((spec, reply))
            else:
                self._queues[spec.scheduling_class].append((spec, reply))
        self._maybe_prestart(1)
        self.request_tick()

    def queue_and_schedule_batch(self, specs, reply: Callable):
        """Batched lease entry: N lease requests in one call, ONE reply
        carrying the ordered grant/spillback/backlog vector.  Entries
        the first scheduling pass cannot serve are withdrawn as
        ``backlog`` (or ``infeasible``) by the sweep, so the reply comes
        one tick after the request."""
        batch = _LeaseBatch(len(specs), reply)
        with self._lock:
            for i, spec in enumerate(specs):
                self._queues[spec.scheduling_class].append(
                    (spec, _BatchEntry(batch, i)))
            self._pending_batches.append(batch)
        self._maybe_prestart(len(specs))
        self.request_tick()

    def on_resources_freed(self):
        self.request_tick()

    def on_cluster_changed(self):
        """Retry infeasible queues when nodes or resources change."""
        with self._lock:
            for cls, q in self._infeasible.items():
                self._queues[cls].extend(q)
                q.clear()
        self.request_tick()

    def request_tick(self):
        """Event-driven scheduling wakeup, coalesced: the first request
        schedules the tick ``scheduler_wakeup_debounce_ms`` out and every
        further request before it runs folds into it.  The periodic
        ``event_loop_tick_ms`` tick stays as the fallback."""
        with self._lock:
            if self._wakeup_pending:
                return
            self._wakeup_pending = True
        debounce = get_config().scheduler_wakeup_debounce_ms / 1000.0
        if debounce > 0:
            self._raylet.loop.schedule_after(
                debounce, self.schedule_and_dispatch, "cluster.schedule")
        else:
            self._raylet.loop.post(self.schedule_and_dispatch,
                                   "cluster.schedule")

    def _maybe_prestart(self, queued_now: int):
        cfg = get_config()
        if not cfg.num_prestart_workers or not cfg.prestart_on_submit:
            return
        self._raylet.worker_pool.prestart_for_backlog(
            self.num_queued() + queued_now, cfg.num_prestart_workers)

    # ---- the tick -------------------------------------------------------
    @loop_only("raylet")
    def schedule_and_dispatch(self):
        """The scheduling tick, run only on the raylet's loop thread:
        queue pops, the dirty cluster view and tick_stats are touched
        from one thread."""
        cfg = get_config()
        with self._lock:
            self._wakeup_pending = False
            # Sweep set: batches queued before this pass started.
            sweep, self._pending_batches = self._pending_batches, []
            held, self._grant_or_reject = self._grant_or_reject, deque()
        depth = self._total_queued()
        t0 = time.perf_counter()
        try:
            self._grant_here_or_reject(held)
            if cfg.scheduler_backend == "torch" and depth > 1:
                if self._schedule_batched():
                    return
                # The device solve gave no valid assignment this tick:
                # the work was requeued; the validated greedy policy
                # places it.
                self.tick_stats["jnp_fallbacks"] += 1
            self._schedule_greedy()
        finally:
            # Even when the pass raised: an unreplied batch entry left
            # queued would defer the whole batch reply.
            self._resolve_batch_backlog(sweep)
            dt = time.perf_counter() - t0
            self.tick_stats["ticks"] += 1
            if depth or held:
                # Working ticks only: idle ticks fire every
                # event_loop_tick_ms and would drown the signal.
                self.tick_stats["busy_ticks"] += 1
                observe_internal("ray_tpu.scheduler.tick_latency", dt,
                                 buckets=_TICK_BUCKETS,
                                 node=self._node_label)

    def _total_queued(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # A scheduled task is popped from its queue before its lease reply
    # fires, so every pop->reply edge below runs through a guard that
    # requeues the task on failure instead of losing the lease request.

    def _dispatch_local(self, spec: TaskSpec, reply: Callable) -> bool:
        """Hand a locally scheduled task to the dispatch path.  Returns
        False (never raises) when the handoff failed before the reply
        was registered; the caller requeues the task and returns its
        reservation."""
        try:
            self._raylet.local_task_manager.queue_and_schedule(spec, reply)
            self._dispatch_failures.pop(spec.task_id, None)
            return True
        except Exception:
            self.tick_stats["dispatch_errors"] += 1
            logger.exception("local dispatch of %s failed; requeueing",
                             spec.task_id)
            return False

    def _spillback_reason(self, spec: TaskSpec, cost_active: bool) -> str:
        """``locality_override`` when a cost-aware solve moved a HYBRID
        task the local node could run right now; ``no_capacity``
        otherwise."""
        if not cost_active or spec.scheduling_options.scheduling_type \
                is not policy_mod.SchedulingType.HYBRID:
            return "no_capacity"
        node = self._raylet.cluster_view.node_resources(
            self._raylet.node_id)
        if node is not None and node.is_available(spec.resources):
            return "locality_override"
        return "no_capacity"

    def _reply_spillback(self, spec: TaskSpec, reply: Callable,
                         target, reason: str = "no_capacity") -> None:
        """Deliver a spillback reply; an exception inside the reply chain
        is counted but not requeued (the submitter may already have
        acted on it)."""
        try:
            self.tick_stats["spillbacks"] += 1
            self.tick_stats[f"spillbacks_{reason}"] += 1
            reply({"retry_at": target})
        except Exception:
            self.tick_stats["dispatch_errors"] += 1
            logger.exception("spillback reply for %s failed",
                             spec.task_id)

    def _requeue(self, spec: TaskSpec, reply: Callable) -> None:
        # Capped: a dispatch path that fails deterministically escalates
        # to the submitter as a rejection instead of livelocking.
        n = self._dispatch_failures.get(spec.task_id, 0) + 1
        self._dispatch_failures[spec.task_id] = n
        if n > _MAX_DISPATCH_REQUEUES:
            self._dispatch_failures.pop(spec.task_id, None)
            try:
                reply({"rejected": True,
                       "reason": f"local dispatch failed {n} times"})
            except Exception:
                logger.exception("dispatch-failure reply for %s failed",
                                 spec.task_id)
            return
        with self._lock:
            self._queues[spec.scheduling_class].append((spec, reply))
        self.request_tick()

    def _grant_here_or_reject(self, held) -> None:
        """Grant each ``grant_or_reject`` lease on this node if it fits
        here now; reject the others back to their submitters."""
        view = self._raylet.cluster_view
        local_id = self._raylet.node_id
        for spec, reply in held:
            if view.subtract(local_id, spec.resources):
                if self._dispatch_local(spec, reply):
                    continue
                view.add_back(local_id, spec.resources)
            self.tick_stats["spillback_rejections"] += 1
            try:
                reply({"rejected": True, "grant_or_reject": True,
                       "reason": "the spillback target cannot run it now"})
            except Exception:
                self.tick_stats["dispatch_errors"] += 1
                logger.exception("grant-or-reject reply for %s failed",
                                 spec.task_id)

    def _resolve_batch_backlog(self, swept) -> None:
        """Withdraw swept batches' entries the pass left behind: still
        queued = feasible but no capacity this tick (``backlog``);
        parked in ``_infeasible`` = no node's totals fit
        (``infeasible``)."""
        if not swept:
            return
        swept_set = set(swept)
        withdrawn = []
        with self._lock:
            for queues, infeasible in ((self._queues, False),
                                       (self._infeasible, True)):
                for q in queues.values():
                    if not q:
                        continue
                    kept = [(spec, rep) for spec, rep in q
                            if not (isinstance(rep, _BatchEntry) and
                                    rep.batch in swept_set)]
                    if len(kept) != len(q):
                        withdrawn.extend(
                            (rep, infeasible) for _s, rep in q
                            if isinstance(rep, _BatchEntry) and
                            rep.batch in swept_set)
                        q.clear()
                        q.extend(kept)
        for rep, infeasible in withdrawn:
            result = {"backlog": True}
            if infeasible:
                result["infeasible"] = True
            try:
                rep(result)
            except Exception:
                self.tick_stats["dispatch_errors"] += 1
                logger.exception("batch backlog reply failed")

    def _schedule_greedy(self):
        """Reference-parity greedy loop: per class, per task, pick the
        best node, dispatch locally or spill back."""
        view = self._raylet.cluster_view
        local_id = self._raylet.node_id
        while True:
            progress = False
            with self._lock:
                classes = [c for c, q in self._queues.items() if q]
            for cls in classes:
                while True:
                    with self._lock:
                        q = self._queues[cls]
                        if not q:
                            break
                        spec, reply = q[0]
                    target = policy_mod.schedule(
                        view, spec.resources, spec.scheduling_options,
                        local_node_id=local_id)
                    if target is None:
                        with self._lock:
                            if self._queues[cls] and \
                                    self._queues[cls][0][0] is spec:
                                self._queues[cls].popleft()
                                self._infeasible[cls].append((spec, reply))
                        progress = True
                        continue
                    if target == local_id:
                        # Reserve local resources at decision time; they
                        # are released when the worker lease returns.
                        if not view.subtract(local_id, spec.resources):
                            # Feasible but not available now: freed
                            # resources re-run the tick.
                            break
                        with self._lock:
                            if not (self._queues[cls] and
                                    self._queues[cls][0][0] is spec):
                                view.add_back(local_id, spec.resources)
                                continue
                            self._queues[cls].popleft()
                        if not self._dispatch_local(spec, reply):
                            view.add_back(local_id, spec.resources)
                            self._requeue(spec, reply)
                        progress = True
                    else:
                        if not view.subtract(target, spec.resources):
                            break       # stale view: park and retry
                        with self._lock:
                            if not (self._queues[cls] and
                                    self._queues[cls][0][0] is spec):
                                view.add_back(target, spec.resources)
                                continue
                            self._queues[cls].popleft()
                        # The dirty subtract stops this tick from
                        # spilling everything to one node; the broadcast
                        # corrects it.
                        self._reply_spillback(spec, reply, target)
                        progress = True
            if not progress:
                return

    def _arg_locality_bytes(self, specs) -> Dict:
        """Per-node argument bytes for a class's queued specs, the
        arg-locality cost signal: sizes and locations from the object
        directory (the owner registers both when a big object lands in
        a node store).  Inline arguments have no directory row and give
        nothing: they copy anywhere for free.  The device solver calls
        this only for classes whose specs carry object arguments.  A
        raylet outside a cluster has no directory and gives nothing."""
        directory = getattr(self._raylet.cluster, "object_directory", None)
        if directory is None:
            return {}
        out: Dict = {}
        for spec in specs:
            for oid in spec.arg_object_ids():
                size = directory.size_hint(oid)
                if not size:
                    continue
                for nid in directory.get_locations(oid):
                    out[nid] = out.get(nid, 0) + size
        return out

    def _requeue_all(self, work) -> None:
        with self._lock:
            for spec, reply in work:
                self._queues[spec.scheduling_class].append((spec, reply))

    def _schedule_batched(self) -> bool:
        """Solve all queues in one device call
        (``scheduler_backend="torch"``).  Returns False when the solve
        gave no valid assignment (the work is requeued for the greedy
        pass); raises, with the work requeued, when the solve raised."""
        if self._solver is None:
            from ray_tpu_torch.scheduler.torch_backend import \
                DeviceRuntimeSolver
            self._solver = DeviceRuntimeSolver(
                node_label=self._node_label,
                locality_provider=self._arg_locality_bytes,
                device=self._raylet.device)
        view = self._raylet.cluster_view
        with self._lock:
            work: list = []
            for q in self._queues.values():
                work.extend(q)
                q.clear()
        if not work:
            return True
        self.tick_stats["last_batch_tasks"] = len(work)
        self.tick_stats["last_batch_classes"] = len(
            {spec.scheduling_class for spec, _ in work})
        try:
            assignments = self._solver.solve(
                view, [spec for spec, _ in work])
        except Exception:
            # No lease may go down with the device: put every popped
            # request back, count the failure and let it surface.
            self._requeue_all(work)
            self.tick_stats["device_errors"] += 1
            raise
        if assignments is None:
            self._requeue_all(work)
            return False
        local_id = self._raylet.node_id
        # Local grants commit first, so that _spillback_reason sees this
        # tick's local reservations.
        ordered = sorted(
            zip(work, assignments),
            key=lambda wa: 0 if wa[1] == local_id else 1)
        for (spec, reply), target in ordered:
            if target is None:
                # None conflates busy with infeasible: only a task no
                # node's totals fit may park in _infeasible (retried on
                # cluster changes only).
                feasible_somewhere = view.is_feasible_anywhere(
                    spec.resources)
                with self._lock:
                    if feasible_somewhere:
                        self._queues[spec.scheduling_class].append(
                            (spec, reply))
                    else:
                        self._infeasible[spec.scheduling_class].append(
                            (spec, reply))
            elif target == local_id:
                if not view.subtract(local_id, spec.resources):
                    with self._lock:
                        self._queues[spec.scheduling_class].append(
                            (spec, reply))
                    continue
                if not self._dispatch_local(spec, reply):
                    view.add_back(local_id, spec.resources)
                    self._requeue(spec, reply)
            else:
                # Validate against the exact vectors before committing
                # the spill.
                node = view.node_resources(target)
                if node is not None and node.is_feasible(spec.resources):
                    self._reply_spillback(
                        spec, reply, target,
                        self._spillback_reason(
                            spec, self._solver.last_cost_active))
                else:
                    with self._lock:
                        self._queues[spec.scheduling_class].append(
                            (spec, reply))
        return True

    # ---- introspection --------------------------------------------------
    def num_queued(self) -> int:
        with self._lock:
            return (sum(len(q) for q in self._queues.values()) +
                    sum(len(q) for q in self._infeasible.values()) +
                    len(self._grant_or_reject))

    def resource_load(self) -> list:
        """Pending per-task resource demands (queued + infeasible), the
        raylet's contribution to the autoscaler's demand vector."""
        with self._lock:
            out = []
            for q in (list(self._queues.values()) +
                      list(self._infeasible.values()) +
                      [self._grant_or_reject]):
                out.extend(spec.resources.to_dict() for spec, _ in q)
            return out

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "queued": {c: len(q) for c, q in self._queues.items() if q},
                "infeasible": {c: len(q) for c, q in self._infeasible.items()
                               if q},
            }
