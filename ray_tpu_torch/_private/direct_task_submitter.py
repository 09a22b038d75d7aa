"""Normal-task transport: leasing, pipelining, spillback handling.

A port of ``ray_tpu._private.direct_task_submitter`` for the PyTorch
port, whole but for two things.  The task events of the transport
(SCHEDULED, SUBMITTED_TO_WORKER) belong to the GCS (A.4b.4) and are left
out.  And C.4:

Divergence on a spilled lease (ROADMAP C.4): ``_on_lease_result``
re-sends a spillback to the raylet it names with ``grant_or_reject``,
so that raylet grants the lease or rejects it and never spills it again
(the port's raylet, ``cluster_task_manager``).  A reply ``{"rejected":
True, "grant_or_reject": True}`` re-leases the task at the local raylet:
no retry is charged, and ``submitter_stats["spillback_rejections"]``
counts it.  The reference re-sends a spillback as a fresh lease and
would treat that rejection as a failed lease (``_on_lease_failed``).
The drop of a lease past 10 hops is the reference's: the task goes
back to its class's queue for a fresh lease.

Parity: reference ``src/ray/core_worker/transport/direct_task_transport.cc``
— per-``SchedulingKey`` queues (direct_task_transport.h:53-57), worker lease
reuse (``OnWorkerIdle`` .cc:157), new lease requests capped per scheduling
class (``RequestNewWorkerIfNeeded`` .cc:308), spillback re-lease at
``retry_at_raylet_address`` (.cc:459), direct ``PushTask`` to the leased
worker (.cc:508) — the raylet is off the per-task data path after leasing.

Dispatch fast path (two levers on the submit->running hot path):

* **Batched leases** — ``_pump`` coalesces a same-class burst into ONE
  ``request_worker_lease_batch`` round-trip for up to ``lease_batch_size``
  workers; the reply's grant/spillback vector is handled entry-wise
  (spillbacks re-lease individually, exactly like the single path), and
  ``backlog`` entries stay client-side until a progress edge re-pumps.
* **Lease keepalive** — an idle leased worker is parked for
  ``worker_lease_keepalive_ms`` instead of returned, so the next
  same-class task is pushed directly with zero scheduling round-trips
  (lease pipelining across get()-separated bursts).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger(__name__)

# Re-lease cadence/window for leases bounced off a not-yet-declared-dead
# node: 0.2s x 150 = 30s, comfortably past any heartbeat-timeout
# declaration, after which the bounce becomes a real failure.
_LEASE_BOUNCE_DELAY_S = 0.2
_MAX_LEASE_BOUNCES = 150


def _worker_dead(worker) -> bool:
    return str(getattr(worker, "state", "")) == "DEAD"


class _SchedulingKeyState:
    __slots__ = ("queue", "idle_workers", "pending_leases",
                 "leased_task_ids", "backlog_retry_pending", "backoff",
                 "request_in_flight")

    def __init__(self):
        self.queue: deque = deque()
        # One NEW lease request (single or batch) outstanding per class
        # at a time: issuing one per queued task (the old pipelining)
        # leased a worker per SCHEDULED task of the burst — dozens of
        # workers started, granted and returned unused at drain end —
        # while the batch reply tells us within one round-trip how many
        # workers the cluster can actually give us.  Spillback/bounce
        # re-leases of already-accounted entries bypass the gate.
        self.request_in_flight = False
        # True after a backlog reply (raylet: feasible, no capacity):
        # stop issuing new lease requests for this class until a real
        # capacity edge — a grant, a lease return, the backlog-retry
        # probe — clears it.  Without this, every submit during a
        # saturated burst would re-issue a futile batch round-trip.
        self.backoff = False
        # Parked (worker, raylet) leases kept warm for direct push —
        # each parking arms a keepalive timer that returns the lease if
        # no task claims it inside the window.
        self.idle_workers: List[Tuple[object, object]] = []
        self.pending_leases = 0
        # Task ids with an in-flight lease request: each lease request must
        # carry a DISTINCT representative spec — the raylet dep-waits on the
        # representative's args, and two in-flight waits for one task id
        # would collide (reference: pending_lease_requests_ keyed by TaskID,
        # direct_task_transport.h).
        self.leased_task_ids: set = set()
        # One delayed re-pump armed per class while a pure-backlog batch
        # reply left the queue without any other progress edge.
        self.backlog_retry_pending = False


class DirectTaskSubmitter:
    def __init__(self, core_worker):
        self._core = core_worker
        self._lock = threading.RLock()
        self._keys: Dict[int, _SchedulingKeyState] = defaultdict(
            _SchedulingKeyState)
        self._lease_bounces: Dict = {}   # task_id -> transient rejects
        self._max_pending = get_config(
        ).max_pending_lease_requests_per_scheduling_category
        #: Re-sent spillbacks their target rejected (C.4, module
        #: docstring).
        self.submitter_stats = {"spillback_rejections": 0}

    # ---- entry ----------------------------------------------------------
    def submit(self, spec: TaskSpec):
        key = spec.scheduling_class
        with self._lock:
            state = self._keys[key]
            state.queue.append(spec)
            depth = len(state.queue)
        self._pump(key)
        bp = get_config().submit_backpressure_depth
        if bp and depth > bp:
            # Flow control: the submitting thread is outrunning the
            # pipeline — yield the GIL so workers drain the backlog it
            # just grew (queue_wait latency is bounded by ~depth x
            # per-task cost instead of the whole burst).
            time.sleep(0)

    def _pump(self, key: int):
        """Dispatch queued tasks onto idle leased workers; coalesce the
        unleased remainder into one batched lease request (bounded
        pipelining: in-flight lease entries are capped per class)."""
        cfg = get_config()
        while True:
            dead_entry = None
            push_pair = None
            batch: List[TaskSpec] = []
            with self._lock:
                state = self._keys[key]
                if not state.queue:
                    return
                if state.idle_workers:
                    worker, raylet = state.idle_workers.pop()[:2]
                    if _worker_dead(worker):
                        dead_entry = (worker, raylet)
                    else:
                        # Pop under the lock, push OUTSIDE it: the push
                        # (task events + worker queue) is the per-task
                        # hot path, and holding the class-wide lock
                        # through it serializes every worker's reuse
                        # cycle against every other's.
                        push_pair = (state.queue.popleft(), worker,
                                     raylet)
                else:
                    if state.backoff or state.request_in_flight:
                        return   # no capacity / a request already out
                    avail = self._max_pending - state.pending_leases
                    if avail <= 0:
                        return
                    cap = min(avail, max(1, cfg.lease_batch_size))
                    # Specs with ref args never join a batch: the
                    # raylet dep-waits on the representative's args,
                    # and the batch reply fires only when EVERY entry
                    # resolves — a consumer waiting on outputs of
                    # same-batch producers would withhold the
                    # producers' granted workers behind itself
                    # (deadlock when no prior lease exists to drain
                    # them by reuse).  They ride the single-lease path,
                    # whose reply is held per entry exactly as before.
                    fallback = None
                    for s in state.queue:
                        if s.task_id in state.leased_task_ids:
                            continue
                        if s.arg_object_ids():
                            if fallback is None:
                                fallback = s
                            continue
                        batch.append(s)
                        if len(batch) >= cap:
                            break
                    if not batch and fallback is not None:
                        batch = [fallback]
                    if not batch:
                        return  # every queued task has a lease in flight
                    state.request_in_flight = True
                    state.pending_leases += len(batch)
                    state.leased_task_ids.update(
                        s.task_id for s in batch)
            if dead_entry is not None:
                # Died while parked: the lease is useless, give it back
                # (outside our lock — return_worker walks raylet-side
                # locks) and keep pumping.
                try:
                    dead_entry[1].return_worker(dead_entry[0],
                                                disconnect=True)
                except Exception:
                    logger.exception("returning a dead parked lease failed")
                continue
            if push_pair is not None:
                self._push(push_pair[0], push_pair[1], push_pair[2], key)
                continue
            if len(batch) == 1:
                self._request_lease(batch[0], key, clears_gate=True)
            else:
                self._request_lease_batch(batch, key)
            return

    # ---- leasing --------------------------------------------------------
    def _pick_lease_raylet(self, spec: TaskSpec):
        """Locality-aware lease policy (lease_policy.h:54-60): the
        affinity node, else the raylet holding the largest argument by
        the object directory, else the local raylet.  The reference
        reads each holder's entry size from its store (which restores a
        spilled entry); the directory's size hint is the same number."""
        cluster = self._core.cluster
        if spec.scheduling_options.node_affinity_node_id is not None:
            affinity = cluster.raylet(
                spec.scheduling_options.node_affinity_node_id)
            if affinity is not None:
                return affinity
        best, best_bytes = None, -1
        for oid in spec.arg_object_ids():
            directory = cluster.object_directory
            size = directory.size_hint(oid)
            for node_id in directory.get_locations(oid):
                raylet = cluster.raylet(node_id)
                if raylet is not None and size > best_bytes:
                    best, best_bytes = raylet, size
        return best or self._core.local_raylet

    def _clear_request_gate(self, key: int):
        with self._lock:
            self._keys[key].request_in_flight = False

    def _request_lease(self, spec: TaskSpec, key: int, raylet=None,
                       hops: int = 0, clears_gate: bool = False,
                       grant_or_reject: bool = False):
        """``clears_gate`` marks the class's ONE gated new-lease request
        (issued by ``_pump``); spillback/bounce re-leases of an
        already-accounted entry leave the gate alone.
        ``grant_or_reject`` marks a spillback re-sent to its target."""
        raylet = raylet or self._pick_lease_raylet(spec)
        if raylet is None:
            if clears_gate:
                self._clear_request_gate(key)
            self._on_lease_failed(spec, key,
                                  exceptions.RayTpuError("no raylet"))
            return

        def on_reply(result):
            if clears_gate:
                self._clear_request_gate(key)
            self._on_lease_result(spec, key, result, hops)

        raylet.request_worker_lease(spec, on_reply,
                                    grant_or_reject=grant_or_reject)

    def _request_lease_batch(self, specs: List[TaskSpec], key: int):
        """One round-trip for up to ``lease_batch_size`` same-class
        workers.  The batch targets the first spec's locality choice —
        same scheduling class means same resources/options, and the
        raylet's own policy corrects any per-task locality difference
        via spillback (re-leased individually as today)."""
        raylet = self._pick_lease_raylet(specs[0])
        if raylet is None:
            self._clear_request_gate(key)
            for s in specs:
                self._on_lease_failed(s, key,
                                      exceptions.RayTpuError("no raylet"))
            return
        batch_fn = getattr(raylet, "request_worker_lease_batch", None)
        if batch_fn is None:
            # Transport without the batched RPC: plain single leases.
            self._clear_request_gate(key)
            for s in specs:
                self._request_lease(s, key, raylet=raylet)
            return

        def on_reply(reply):
            # Re-open the gate first: a grant below may pump the next
            # batch while the rest of this reply is still processing.
            self._clear_request_gate(key)
            results = (reply or {}).get("results") or []
            progress = False
            for i, spec in enumerate(specs):
                result = results[i] if i < len(results) else {
                    "rejected": True, "reason": "batch reply truncated"}
                if "worker" in result or "retry_at" in result:
                    progress = True
                self._on_lease_result(spec, key, result, 0)
            if not progress:
                # Pure backlog/bounce: nothing above re-pumps, and the
                # raylet no longer holds our entries — arm the delayed
                # re-pump fallback so the class can't starve.
                self._schedule_backlog_retry(key)

        batch_fn(specs, on_reply)

    def _on_lease_result(self, spec: TaskSpec, key: int, result: dict,
                         hops: int):
        """Shared per-entry lease resolution (single and batched)."""
        if "worker" in result:
            self._handle_grant(spec, key, result)
        elif "retry_at" in result:
            # Spillback (cluster_task_manager.cc:285-323): re-lease at
            # the suggested raylet, granted there or rejected (C.4).
            target = self._core.cluster.raylet(result["retry_at"])
            if target is None or hops > 10:
                with self._lock:
                    self._keys[key].pending_leases -= 1
                    self._keys[key].leased_task_ids.discard(spec.task_id)
                self._pump(key)
            else:
                self._request_lease(spec, key, raylet=target,
                                    hops=hops + 1, grant_or_reject=True)
        elif result.get("rejected") and result.get("grant_or_reject"):
            # The spillback's target could not run it now (C.4): lease
            # again at the local raylet, which decides on a newer view.
            # The entry stays accounted; no retry is charged.
            with self._lock:
                self.submitter_stats["spillback_rejections"] += 1
            self._request_lease(spec, key, raylet=self._core.local_raylet,
                                hops=hops + 1)
        elif result.get("backlog"):
            if result.get("infeasible"):
                # No node's totals fit: re-lease through the SINGLE
                # path, which parks raylet-side until the cluster
                # changes (autoscaler demand stays visible there).
                # Accounting unchanged — the entry is still in flight.
                self._request_lease(spec, key)
            else:
                # Feasible but no capacity this tick: the task stays in
                # our queue under lease back-off; a capacity edge (a
                # grant, a lease return) or the backlog-retry probe
                # re-opens leasing, and parked-lease reuse keeps
                # draining the queue meanwhile.
                with self._lock:
                    state = self._keys[key]
                    state.pending_leases = max(0, state.pending_leases - 1)
                    state.leased_task_ids.discard(spec.task_id)
                self._schedule_backlog_retry(key)
        elif result.get("batch_fault"):
            # The whole batch bounced (chaos point worker.lease_batch /
            # a transport refusing the batched RPC): retry this entry
            # on the single-lease path — a scheduling-plane hiccup,
            # never a task failure, so no retry budget is charged.
            self._request_lease(spec, key)
        else:
            reason = str(result.get("reason", "lease rejected"))
            transient = bool(result.get("rejected")) and (
                "connection lost" in reason or "node dead" in reason)
            self._on_lease_failed(
                spec, key, exceptions.RayTpuError(reason),
                transient=transient)

    def _handle_grant(self, spec: TaskSpec, key: int, result: dict):
        worker, raylet = result["worker"], result["raylet"]
        if _worker_dead(worker):
            # The worker died between grant and push (batched grants
            # widen this window): give the lease back — that frees the
            # raylet-side resource reservation — and re-lease via the
            # next pump WITHOUT burning the task's retry budget; the
            # task never reached a worker.
            try:
                raylet.return_worker(worker, disconnect=True)
            except Exception:
                logger.exception("returning a dead granted lease failed")
            with self._lock:
                state = self._keys[key]
                state.pending_leases = max(0, state.pending_leases - 1)
                state.leased_task_ids.discard(spec.task_id)
            self._pump(key)
            return
        with self._lock:
            state = self._keys[key]
            state.pending_leases -= 1
            state.leased_task_ids.discard(spec.task_id)
            state.backoff = False      # capacity edge: leasing works again
            self._lease_bounces.pop(spec.task_id, None)
            if state.queue and state.queue[0].task_id == spec.task_id:
                state.queue.popleft()
                dispatch = spec
            elif state.queue:
                dispatch = state.queue.popleft()
            else:
                dispatch = None
            if dispatch is not None:
                state.leased_task_ids.discard(dispatch.task_id)
        if dispatch is None:
            # Queue drained while the lease was in flight; return it.
            raylet.return_worker(worker)
        else:
            self._push(dispatch, worker, raylet, key)
        self._pump(key)

    def _schedule_backlog_retry(self, key: int):
        """Back the class off and arm its delayed re-pump — the raylet
        dropped our backlog entries, so no held reply will wake us when
        capacity frees.  Backoff and timer are set under ONE lock hold:
        a backoff left set without a pending timer (e.g. because the
        queue looked empty for an instant between bursts) would gate
        every future submit of the class forever.  Rides the raylet
        loop's timer heap (one pending timer per class, not one thread
        per bounce)."""
        raylet = self._core.local_raylet
        if raylet is None or getattr(raylet, "_dead", False):
            with self._lock:
                self._keys[key].backoff = False
            return
        with self._lock:
            state = self._keys[key]
            if not state.queue:
                # Nothing left to lease for: do not gate future
                # submits.
                state.backoff = False
                return
            state.backoff = True
            if state.backlog_retry_pending:
                return
            state.backlog_retry_pending = True

        def fire():
            with self._lock:
                state = self._keys[key]
                state.backlog_retry_pending = False
                state.backoff = False      # probe: try leasing again
            local = self._core.local_raylet
            if local is None or getattr(local, "_dead", False):
                return
            self._pump(key)

        delay = max(1, get_config().lease_backlog_retry_ms) / 1000.0
        raylet.loop.schedule_after(delay, fire, "lease.backlog_retry")

    def _on_lease_failed(self, spec: TaskSpec, key: int, err,
                         transient: bool = False):
        with self._lock:
            state = self._keys[key]
            state.pending_leases = max(0, state.pending_leases - 1)
            state.leased_task_ids.discard(spec.task_id)
            try:
                state.queue.remove(spec)
            except ValueError:
                pass
        if transient:
            # The lease bounced off a dying/unreachable node whose death
            # the GCS has not declared yet, so the scheduler may keep
            # pointing at it for a few heartbeats.  That is a
            # scheduling-plane hiccup, not a task failure: hold the spec
            # and re-lease after a beat WITHOUT burning the task's retry
            # budget (reference: lease failures against a dead raylet are
            # retried at the lease layer, task retries cover execution).
            # Bounded — past the window it becomes a real failure.
            with self._lock:
                n = self._lease_bounces.get(spec.task_id, 0) + 1
                self._lease_bounces[spec.task_id] = n
            if n <= _MAX_LEASE_BOUNCES:
                # Delayed re-lease rides the raylet event loop's timer
                # heap — a node death can bounce hundreds of queued
                # tasks every 0.2s for several heartbeats, and a Timer
                # THREAD per bounce would be thread churn exactly while
                # the scheduler is busiest.
                raylet = self._core.local_raylet
                if raylet is not None and not getattr(raylet, "_dead",
                                                      False):
                    raylet.loop.schedule_after(
                        _LEASE_BOUNCE_DELAY_S,
                        lambda: self._resubmit_bounced(spec),
                        "lease.rebounce")
                return
        with self._lock:
            self._lease_bounces.pop(spec.task_id, None)
        self._core.task_manager.fail_or_retry(
            spec, err, resubmit=self.submit)

    def _resubmit_bounced(self, spec: TaskSpec):
        """Timer-thread re-lease of a transiently bounced task.  A
        cluster torn down while the timer was pending must not be
        resubmitted into (the re-lease would bounce-loop against dead
        raylets across later tests in the same process)."""
        raylet = self._core.local_raylet
        if raylet is None or getattr(raylet, "_dead", False):
            return
        self.submit(spec)

    # ---- dispatch -------------------------------------------------------
    def _push(self, spec: TaskSpec, worker, raylet, key: int):
        def on_done(error):
            if error is None:
                self._core.task_manager.complete_task(spec)
                self._on_worker_idle(worker, raylet, key)
            else:
                # User errors don't poison the worker; system errors do.
                if isinstance(error, exceptions.TaskError):
                    self._on_worker_idle(worker, raylet, key)
                else:
                    raylet.return_worker(worker, disconnect=True)
                retried = self._core.task_manager.fail_or_retry(
                    spec, error, resubmit=self.submit)
                _ = retried

        worker.push_task(spec, on_done)
        # Cross-thread push: the target worker needs the GIL to START
        # the task, and the pushing thread (driver submit loop, raylet
        # loop, another worker's idle path) would otherwise keep
        # running a full switch interval — measured as the dominant
        # ``startup``-stage tail.  One yield hands the task over now.
        # A push from the worker's own thread (the reuse cycle) never
        # yields: the worker's loop picks the task up immediately.
        thr = getattr(worker, "_thread", None)
        if thr is not threading.current_thread():
            time.sleep(0)

    def _on_worker_idle(self, worker, raylet, key: int):
        """Reuse the leased worker for the next queued task of this class
        (OnWorkerIdle, direct_task_transport.cc:157); with no backlog,
        park the lease warm for ``worker_lease_keepalive_ms`` so a
        burst arriving inside the window pushes directly instead of
        paying a fresh lease round-trip."""
        spec = None
        with self._lock:
            state = self._keys[key]
            if state.queue:
                spec = state.queue.popleft()
        if spec is not None:
            # Push outside the lock (see _pump): this is the per-task
            # reuse hot path every worker cycles through concurrently.
            self._push(spec, worker, raylet, key)
            return
        keepalive = get_config().worker_lease_keepalive_ms / 1000.0
        local = self._core.local_raylet
        if keepalive <= 0 or _worker_dead(worker) or local is None \
                or getattr(local, "_dead", False):
            # No more work: return the lease.
            raylet.return_worker(worker)
            return
        # Per-park identity sentinel: entries must NOT compare equal
        # across parks of the same worker, or a stale keepalive timer
        # from an earlier park would `remove` (and return) a freshly
        # re-parked lease — capping the effective keepalive at
        # first-park + window under steady reuse.
        entry = (worker, raylet, object())
        with self._lock:
            state = self._keys[key]
            if state.queue:
                # A submit raced the park: its _pump saw neither a
                # parked worker nor a reason to lease, so if we parked
                # now the task would wait with nothing ever waking it
                # (lost-wakeup deadlock).  Pop-or-park must be atomic.
                spec = state.queue.popleft()
            else:
                state.idle_workers.append(entry)
        if spec is not None:
            self._push(spec, worker, raylet, key)
            return
        local.loop.schedule_after(
            keepalive, lambda: self._expire_idle(key, entry),
            "lease.keepalive")

    def _expire_idle(self, key: int, entry):
        """Keepalive lapsed: if the parked lease is still unclaimed,
        return it (and its resource reservation) to the raylet."""
        with self._lock:
            state = self._keys[key]
            try:
                state.idle_workers.remove(entry)
            except ValueError:
                return   # claimed by a push in the window
        worker, raylet = entry[0], entry[1]
        try:
            raylet.return_worker(worker)
        except Exception:
            logger.exception("returning an expired parked lease failed")
        # The returned lease freed raylet-side capacity: give the class
        # a progress edge in case work arrived while we held it parked.
        with self._lock:
            has_work = bool(self._keys[key].queue)
        if has_work:
            self._pump(key)
