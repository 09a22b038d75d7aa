"""The task-event pipeline: per-task lifecycle transitions.

A port of ``ray_tpu.gcs.task_events`` (reference
``src/ray/gcs/gcs_server/gcs_task_manager.h`` and the worker-side
``core_worker/task_event_buffer.h``): every layer that moves a task
(the core worker's submit, the raylet's tick, the submitter's push, the
executor, the owner's completion) drops a small transition record into
a bounded, lock-striped buffer (``TaskEventBuffer``); its batches reach
the GCS-side ``TaskEventManager`` over the publisher, which folds them
into one bounded record a task, with the attempt counter, stage
samples (``latency_summary``) and the per-job provenance graph
(``gcs/job_graph.py``).

Lifecycle (task_events.proto ``TaskStatus`` subset)::

    PENDING_ARGS_AVAIL -> SCHEDULED -> SUBMITTED_TO_WORKER -> RUNNING
                                   -> FINISHED | FAILED

plus ``RECONSTRUCTING``: lineage reconstruction resubmitted a finished
task, and the record rewinds (the attempt bumps, as for a retry).

Loss is counted, never silent: the buffer drops events past
``max_buffer`` and counts them (every batch carries the count), and
the manager evicts the oldest finished records past ``max_tasks`` and
counts them in ``evicted``.

Divergences: ``emit`` counts and logs a failing emit (``emit_errors``)
where the reference swallows it; the flusher counts and logs a failed
flush (``flush_errors``) where the reference notes it on its debug
plane, and ``stop`` joins the flusher thread.  The reference's stall
watchdog around the flusher is a debug plane (ROADMAP A.4b.7).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.metrics_agent import observe_internal
from ray_tpu_torch.gcs.job_graph import JobGraphStore
from ray_tpu_torch.gcs.pubsub import TASK_EVENT_CHANNEL

logger = logging.getLogger(__name__)

# Task lifecycle states (reference TaskStatus enum subset).
PENDING_ARGS_AVAIL = "PENDING_ARGS_AVAIL"
SCHEDULED = "SCHEDULED"
SUBMITTED_TO_WORKER = "SUBMITTED_TO_WORKER"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
# Lineage reconstruction resubmitted this (already finished) task to
# recompute a lost return object.  Emitted with a BUMPED attempt
# counter, which is what rewinds the record out of its terminal state
# (same mechanism as ordinary retries); it sits first in STATE_ORDER so
# the resubmission's own PENDING->...->FINISHED transitions move the
# record forward again.
RECONSTRUCTING = "RECONSTRUCTING"

# Canonical ordering, used by consumers to sanity-check transitions.
STATE_ORDER = (RECONSTRUCTING, PENDING_ARGS_AVAIL, SCHEDULED,
               SUBMITTED_TO_WORKER, RUNNING, FINISHED, FAILED)
TERMINAL_STATES = (FINISHED, FAILED)

# Per-task history cap: a lifecycle is ~6 transitions; retries add a
# handful more.  Bounded so one infinitely-retried task can't grow a
# record without limit.
_MAX_HISTORY = 32

# Dispatch-latency decomposition: arriving state -> (stage name, the
# predecessor states whose timestamp anchors the stage — first present
# wins).  Derived purely from the lifecycle the emitters already report
# — no new emission sites.  SUBMITTED falls back to PENDING because a
# task pushed onto a REUSED lease never traverses the raylet scheduler
# (no SCHEDULED): its whole pre-push wait is still dispatch time.
# "total" (submit -> running, i.e. everything but execution) is the
# task-dispatch latency.
_STAGE_EDGES = {
    SCHEDULED: ("queue_wait", (PENDING_ARGS_AVAIL,)),
    SUBMITTED_TO_WORKER: ("dispatch", (SCHEDULED, PENDING_ARGS_AVAIL)),
    RUNNING: ("startup", (SUBMITTED_TO_WORKER,)),
    FINISHED: ("execution", (RUNNING,)),
}
_TOTAL_STAGE = ("total", PENDING_ARGS_AVAIL, RUNNING)

# Dispatch stages are sub-millisecond in-process and tens of ms over
# the wire: finer-grained low end than the generic latency buckets.
_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Per-stage bounded sample window for exact p50/p99 rollups (the
# histogram at /metrics covers trend; summarize_tasks wants real
# quantiles over the recent window).
_STAGE_SAMPLE_CAP = 4096


class _EventStripe:
    """One lock-striped sub-buffer of a TaskEventBuffer."""

    __slots__ = ("lock", "events", "dropped")

    def __init__(self, name: str):
        self.lock = threading.Lock()
        self.events: List[dict] = []
        self.dropped = 0


class TaskEventBuffer:
    """Emitter-side bounded buffer (core_worker/task_event_buffer.h
    parity): ``emit`` is the hot-path call — append under a lock, no
    I/O; batches go out over the pubsub channel when the buffer reaches
    ``batch_size`` or ``flush_interval`` has elapsed since the last
    flush, or on an explicit ``flush()`` from the query layer
    (read-your-writes).  The actual flush+ingest runs on a dedicated
    (lazily started) daemon thread, reference io_service parity: a
    flush delivers the batch straight into the manager's ingest — a
    couple of ms for a full batch — and paying that inline on whichever
    WORKER thread happened to cross the threshold put a hard stall in
    the task hot path's latency tail.  ``emit`` only signals.

    Lock striping: the buffer is ``task_event_stripes`` independent
    (lock, list) stripes; each emitting thread is bound round-robin to
    one stripe at its first emit, so concurrent emitters contend only
    when they share a stripe.  The flusher drains every stripe (one
    stripe lock at a time), merges, and sorts by ``ts``; per-thread
    order is kept within a stripe.  The manager's ingest tolerates any
    arrival order (first arrival per state per attempt wins).  Past
    half a stripe's cap the emitting thread flushes inline
    (backpressure rather than loss)."""

    def __init__(self, publisher, buffer_id: str = "head",
                 max_buffer: int = 8192, batch_size: int = 256,
                 flush_interval: float = 0.2,
                 stripes: Optional[int] = None):
        self._publisher = publisher
        self._buffer_id = buffer_id
        self._max_buffer = max_buffer
        self._batch_size = batch_size
        self._flush_interval = flush_interval
        if stripes is None:
            stripes = get_config().task_event_stripes
        self._n_stripes = max(1, int(stripes))
        self._stripes = [
            _EventStripe(f"TaskEventBuffer._lock[s{i:02d}]")
            for i in range(self._n_stripes)]
        # Per-stripe thresholds: the global caps split evenly so the
        # overflow/flush/backpressure semantics scale with stripe count.
        self._stripe_cap = max(1, max_buffer // self._n_stripes)
        self._stripe_batch = max(1, batch_size // self._n_stripes)
        # Round-robin thread->stripe binding (itertools.count.__next__
        # is atomic in CPython); a thread keeps its stripe for life so
        # its emission order is preserved within the stripe.
        self._stripe_rr = itertools.count()
        self._stripe_tls = threading.local()
        # Serializes pop+publish so concurrent flushes from different
        # emitting threads cannot deliver batches out of emission order
        # (a FINISHED overtaking its own PENDING would seed the
        # manager's record with the wrong start_time).
        self._flush_lock = threading.Lock()
        self._start_lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._publish_dropped = 0  # batches lost at the publisher
        # Lazily-started flusher thread (see class docstring): emit
        # signals, the thread flushes; stop() on GCS/node shutdown so
        # per-test clusters don't accumulate parked threads.
        self._flush_wake = threading.Event()
        self._flusher_started = False
        self._flusher: Optional[threading.Thread] = None
        self._stopped = False
        self.flush_errors = 0

    @property
    def dropped(self) -> int:
        """Cumulative drops (stripe overflow + failed publishes) —
        rides every batch."""
        return sum(s.dropped for s in self._stripes) + \
            self._publish_dropped

    def _stripe_for_thread(self) -> _EventStripe:
        stripe = getattr(self._stripe_tls, "stripe", None)
        if stripe is None:
            stripe = self._stripes[
                next(self._stripe_rr) % self._n_stripes]
            self._stripe_tls.stripe = stripe
        return stripe

    def emit(self, task_id, state: str, *, name: str = "",
             job_id: str = "", task_type: str = "NORMAL_TASK",
             node_id: str = "", worker_id: str = "", attempt: int = 0,
             error: Optional[str] = None, parent_task_id: str = "",
             arg_object_ids: Optional[Sequence[str]] = None) -> None:
        tid = task_id.hex() if hasattr(task_id, "hex") else str(task_id)
        ev = {"task_id": tid, "state": state, "ts": time.time()}
        if name:
            ev["name"] = name
        if job_id:
            ev["job_id"] = job_id
        if task_type != "NORMAL_TASK":
            ev["type"] = task_type
        if node_id:
            ev["node_id"] = node_id
        if worker_id:
            ev["worker_id"] = worker_id
        if attempt:
            ev["attempt"] = attempt
        if error is not None:
            ev["error"] = str(error)[:500]
        # Provenance (submit-side only; a few dozen bytes per task —
        # the DAG reconstruction the profiler runs on).
        if parent_task_id:
            ev["parent"] = parent_task_id
        if arg_object_ids:
            ev["args"] = list(arg_object_ids)
        flush_now = False
        start_flusher = False
        inline_flush = False
        stripe = self._stripe_for_thread()
        with stripe.lock:
            if len(stripe.events) >= self._stripe_cap:
                stripe.dropped += 1
                return
            stripe.events.append(ev)
            depth = len(stripe.events)
        if depth >= self._stripe_batch or \
                time.monotonic() - self._last_flush \
                >= self._flush_interval:
            flush_now = True
            # High-water backstop: the off-thread flusher removed
            # the inline backpressure that used to bound the
            # buffer, so a GIL-starved flusher under a hot burst
            # could overflow the stripe and silently drop events.
            # Past half the stripe cap the emitting thread pays the
            # flush itself — backpressure over loss.
            inline_flush = depth >= self._stripe_cap // 2
            if not self._flusher_started:
                with self._start_lock:
                    if not self._flusher_started:
                        self._flusher_started = True
                        start_flusher = True
        if start_flusher:
            # Started under the lock ``stop`` takes: ``stop`` sees no
            # flusher or a started one, and none starts after it.
            with self._start_lock:
                if not self._stopped:
                    flusher = threading.Thread(
                        target=self._flusher_loop, daemon=True,
                        name=f"ray_tpu_torch::task-events::"
                             f"{self._buffer_id[:16]}")
                    flusher.start()
                    self._flusher = flusher
        if inline_flush:
            self.flush()
        elif flush_now and not self._flush_wake.is_set():
            # Set once a wake-up: a set takes the event's lock, and every
            # emit past the threshold would take it again until the
            # flusher runs.
            self._flush_wake.set()

    def _flusher_loop(self):
        while not self._stopped:
            self._flush_wake.wait(timeout=self._flush_interval)
            if self._stopped:
                return
            self._flush_wake.clear()
            try:
                self.flush()
            except Exception:
                # Publish failures are counted inside flush; anything
                # else must not kill the flusher unseen.
                self.flush_errors += 1
                logger.exception("task-event flush failed")

    def stop(self):
        """Shut the flusher down, draining the tail events first."""
        with self._start_lock:
            self._stopped = True
            thread = self._flusher
        self._flush_wake.set()
        self.flush()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)

    def flush(self) -> None:
        with self._flush_lock:
            # Drain each stripe under its own lock, one at a time,
            # never nested.  Merge and sort by ``ts`` (stable)
            # to restore a deterministic cross-thread batch order;
            # per-thread order is already monotone within a stripe.
            batch: List[dict] = []
            dropped = self._publish_dropped
            for stripe in self._stripes:
                with stripe.lock:
                    if stripe.events:
                        batch.extend(stripe.events)
                        stripe.events = []
                    dropped += stripe.dropped
            self._last_flush = time.monotonic()
            if not batch:
                return
            batch.sort(key=lambda e: e["ts"])
            try:
                self._publisher.publish(
                    TASK_EVENT_CHANNEL, b"",
                    {"buffer_id": self._buffer_id, "events": batch,
                     "dropped": dropped})
            except Exception:
                # The popped batch is gone: count it, keep loss
                # explicit.  _publish_dropped is only mutated under
                # _flush_lock (held here).
                self._publish_dropped += len(batch)

    def num_buffered(self) -> int:
        total = 0
        for stripe in self._stripes:
            with stripe.lock:
                total += len(stripe.events)
        return total


class TaskEventManager:
    """GCS-side aggregator (gcs_task_manager.h parity): subscribes to
    the task-event channel, folds batches into one bounded record per
    task (latest state, per-state wall-clock, attempt counter, node /
    worker placement, ordered transition history)."""

    def __init__(self, publisher, max_tasks: int = 10_000):
        self._lock = threading.Lock()
        self._max_tasks = max_tasks
        #: Per-job provenance DAG (terminal records copied in at each
        #: task's terminal transition, bounded and LRU-evicted by job),
        #: which ``critical_path`` walks.  Fed from this ingest.
        self.job_graphs = JobGraphStore()
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        # Terminal-record index (insertion order): O(1) eviction even
        # when ingest runs synchronously on the emitter's flush path.
        self._terminal: "OrderedDict[str, None]" = OrderedDict()
        # Per-source cumulative drop counters (reported by buffers).
        self._source_dropped: Dict[str, int] = {}
        # Dispatch-latency decomposition: bounded recent-sample window
        # per stage (exact p50/p99 for summarize_tasks) — the
        # stage-labelled histogram at /metrics is observed on the same
        # ingest edge.
        self._stage_samples: Dict[str, "deque"] = {}
        self._stage_deque = lambda: deque(maxlen=_STAGE_SAMPLE_CAP)
        self.evicted = 0
        publisher.subscribe(TASK_EVENT_CHANNEL, None, self._on_batch)

    # ---- ingest ---------------------------------------------------------
    def _on_batch(self, _key, batch) -> None:
        try:
            events = batch["events"]
            buffer_id = batch.get("buffer_id", "")
            dropped = int(batch.get("dropped", 0))
        except Exception:
            return
        with self._lock:
            self._source_dropped[buffer_id] = max(
                self._source_dropped.get(buffer_id, 0), dropped)
            for ev in events:
                self._ingest_one(ev)
            while len(self._records) > self._max_tasks:
                self._evict_one()

    def _ingest_one(self, ev: dict) -> None:
        tid = ev["task_id"]
        rec = self._records.get(tid)
        if rec is None:
            rec = {"task_id": tid, "name": "", "job_id": "",
                   "type": "NORMAL_TASK", "state": None, "node_id": "",
                   "worker_id": "", "attempt": 0, "state_ts": {},
                   "events": [], "error": None,
                   "start_time": ev["ts"], "end_time": None,
                   "parent_task_id": "", "arg_object_ids": [],
                   "stages": {},
                   "_observed_stages": set(), "_seen_states": set()}
            self._records[tid] = rec
        state, ts = ev["state"], ev["ts"]
        # Batches from different buffers (owner-side vs node-side)
        # interleave in arrival order, not wall-clock order: an early
        # PENDING arriving after the node's SCHEDULED batch must still
        # anchor the duration at submit time.
        if ts < rec["start_time"]:
            rec["start_time"] = ts
        if ev.get("attempt", 0) > rec["attempt"]:
            # Retry rewind: the lifecycle reruns, so its stages must be
            # measured again for the new attempt.
            rec["_observed_stages"] = set()
            rec["_seen_states"] = set()
            rec["stages"] = {}
        # First arrival per state per attempt wins: a straggling
        # duplicate from another buffer must not overwrite the anchor a
        # later stage will be measured against (last-wins would poison
        # the very durations this pipeline exists to measure).
        if state not in rec["_seen_states"]:
            rec["_seen_states"].add(state)
            rec["state_ts"][state] = ts
        self._observe_stages(rec)
        if len(rec["events"]) < _MAX_HISTORY:
            rec["events"].append((state, ts))
        for key in ("name", "job_id", "node_id", "worker_id"):
            if ev.get(key):
                rec[key] = ev[key]
        if ev.get("type"):
            rec["type"] = ev["type"]
        # Provenance rides the submit event; fold it once per record.
        if ev.get("parent"):
            rec["parent_task_id"] = ev["parent"]
        if ev.get("args"):
            rec["arg_object_ids"] = list(ev["args"])
        is_retry = ev.get("attempt", 0) > rec["attempt"]
        if is_retry:
            rec["attempt"] = ev["attempt"]
        if ev.get("error"):
            rec["error"] = ev["error"]
        # Emitters race across threads AND buffers (owner-side events
        # flush from the head buffer, node-side SCHEDULED/RUNNING ride
        # the wire from remote raylets): a straggling earlier state
        # must never regress the record — not past a terminal state,
        # and not past a later non-terminal state either (RUNNING must
        # not flip back to SUBMITTED_TO_WORKER because the owner's
        # batch arrived late).  Only a genuine retry (higher attempt)
        # rewinds the lifecycle.
        if state in TERMINAL_STATES:
            rec["state"] = state
            rec["end_time"] = ts
            self._terminal[tid] = None
        elif is_retry:
            rec["state"] = state
            rec["end_time"] = None
            self._terminal.pop(tid, None)
        elif rec["state"] not in TERMINAL_STATES and (
                rec["state"] is None or
                STATE_ORDER.index(state) >= STATE_ORDER.index(rec["state"])):
            rec["state"] = state
        # Job-graph feed: UPSERT the record into the per-job DAG store
        # whenever it is terminal — not only on the terminal event
        # itself, because cross-buffer straggler states (a node-side
        # RUNNING landing after the owner's FINISHED) complete stage
        # durations the profiler needs after the first terminal fold.
        if rec["state"] in TERMINAL_STATES:
            self.job_graphs.note_terminal(rec)

    def _observe_stages(self, rec: dict) -> None:
        """Fold the record's current state_ts into the dispatch-latency
        decomposition (callers hold ``_lock``): a stage is measured as
        soon as BOTH of its endpoints are known, whatever order their
        batches arrived in — owner-side and node-side buffers interleave
        freely, so the dependent state routinely lands before its anchor
        and measuring only on arrival edges would silently drop exactly
        the racy (biased) subset of tasks.  Each stage is measured once
        per attempt.  A negative duration (two threads' stamps out of
        order) is clamped at zero rather than poisoning the rollup.  KNOWN
        APPROXIMATION: when SUBMITTED arrives before a (late) SCHEDULED,
        dispatch anchors to PENDING and over-attributes the queue wait —
        bounded, and better than dropping the sample."""
        measured = rec["_observed_stages"]
        # Endpoints must both belong to the CURRENT attempt (_seen_states
        # clears on retry rewind): a leftover attempt-0 timestamp in
        # state_ts must not pair with an attempt-1 state.
        seen = rec["_seen_states"]
        sts = rec["state_ts"]
        pairs = []
        for state, (stage, anchors) in _STAGE_EDGES.items():
            if stage in measured or state not in seen:
                continue
            anchor_ts = next((sts[a] for a in anchors if a in seen), None)
            if anchor_ts is None:
                continue
            measured.add(stage)
            pairs.append((stage, max(0.0, sts[state] - anchor_ts)))
        if _TOTAL_STAGE[0] not in measured and _TOTAL_STAGE[2] in seen \
                and _TOTAL_STAGE[1] in seen:
            measured.add(_TOTAL_STAGE[0])
            pairs.append((_TOTAL_STAGE[0],
                          max(0.0, sts[_TOTAL_STAGE[2]]
                              - sts[_TOTAL_STAGE[1]])))
        if not pairs:
            return
        for stage, dt in pairs:
            # Kept on the record too: the critical-path engine
            # attributes each path task's wall-clock by stage without
            # re-deriving the decomposition.
            rec["stages"][stage] = dt
            window = self._stage_samples.get(stage)
            if window is None:
                window = self._stage_samples[stage] = self._stage_deque()
            window.append(dt)
            observe_internal("ray_tpu.task.dispatch_stage_seconds", dt,
                             buckets=_STAGE_BUCKETS, stage=stage)

    def reset_stage_samples(self) -> None:
        """Clear the per-stage sample windows (bench sweeps measure one
        concurrency level per window; the /metrics histogram keeps its
        cumulative trend)."""
        with self._lock:
            self._stage_samples.clear()

    def latency_summary(self) -> Dict[str, dict]:
        """Per-stage p50/p99 rollup over the recent sample window."""
        with self._lock:
            samples = {stage: list(window)
                       for stage, window in self._stage_samples.items()}
        out: Dict[str, dict] = {}
        for stage, vals in samples.items():
            if not vals:
                continue
            vals.sort()
            n = len(vals)
            out[stage] = {
                "count": n,
                "mean_s": sum(vals) / n,
                "p50_s": vals[int(0.50 * (n - 1))],
                "p99_s": vals[int(0.99 * (n - 1))],
                "max_s": vals[-1],
            }
        return out

    def _evict_one(self) -> None:
        # Oldest finished task first; if everything is still live, the
        # oldest record goes regardless (bounded memory beats history).
        if self._terminal:
            victim, _ = self._terminal.popitem(last=False)
        else:
            victim = next(iter(self._records))
        del self._records[victim]
        self.evicted += 1

    # ---- query ----------------------------------------------------------
    @staticmethod
    def _snapshot(rec: dict) -> dict:
        """Deep-enough copy: callers may iterate state_ts/events while
        the ingest thread keeps folding into the live record.  History
        is presented in wall-clock order — ingest appends in arrival
        order, and batches from different buffers interleave."""
        row = dict(rec)
        row.pop("_observed_stages", None)   # ingest-internal bookkeeping
        row.pop("_seen_states", None)
        row["state_ts"] = dict(rec["state_ts"])
        row["stages"] = dict(rec["stages"])
        row["arg_object_ids"] = list(rec["arg_object_ids"])
        row["events"] = sorted(rec["events"], key=lambda e: e[1])
        start, end = row["start_time"], row["end_time"]
        row["duration_s"] = (end - start) if end is not None else None
        return row

    def tasks(self, limit: Optional[int] = None, offset: int = 0,
              pred=None) -> List[dict]:
        """Snapshot of tracked task records (insertion order).
        Filtering (``pred`` runs against the live record — cheap field
        reads only) and slicing happen BEFORE the per-record copies, so
        a paginated query of a full manager only pays for the page it
        asked for — the copies must stay under the lock (the ingest
        thread keeps folding into the live dicts), so the page size
        bounds the expensive part of the hold."""
        with self._lock:
            recs = self._records.values()
            if pred is not None:
                recs = [rec for rec in recs if pred(rec)]
            else:
                recs = list(recs)
            if offset:
                recs = recs[offset:]
            if limit is not None:
                recs = recs[:limit]
            return [self._snapshot(rec) for rec in recs]

    def get(self, task_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(task_id)
            return self._snapshot(rec) if rec is not None else None

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._records)

    def num_dropped_at_source(self) -> int:
        """Events dropped before ingest (emitter buffers overflowed)."""
        with self._lock:
            return sum(self._source_dropped.values())

    def summarize(self) -> Dict[str, dict]:
        """Per-function-name rollup (``ray summary tasks`` parity)."""
        out: Dict[str, dict] = {}
        for rec in self.tasks():
            name = rec["name"] or "<unknown>"
            row = out.setdefault(name, {"count": 0, "by_state": {},
                                        "total_duration_s": 0.0,
                                        "finished": 0})
            row["count"] += 1
            st = rec["state"] or "UNKNOWN"
            row["by_state"][st] = row["by_state"].get(st, 0) + 1
            if rec["duration_s"] is not None:
                row["total_duration_s"] += rec["duration_s"]
                row["finished"] += 1
        for row in out.values():
            row["mean_duration_s"] = (
                row["total_duration_s"] / row["finished"]
                if row["finished"] else None)
        return out


def flushed_manager(gcs) -> Optional[TaskEventManager]:
    """Read-your-writes entry for the query layer: flush the local
    buffer (events emitted in this process become visible) and hand
    back the manager, or None where the pipeline isn't wired (remote
    gcs proxies)."""
    buf = getattr(gcs, "task_events", None)
    if buf is not None:
        buf.flush()
    return getattr(gcs, "task_event_manager", None)


# ---------------------------------------------------------------------------
# Emission helper: safe from every layer.
# ---------------------------------------------------------------------------

#: Failed emits (``emit`` counts them and logs them; the reference's
#: swallows them).
emit_errors = 0


def emit(cluster, task_id, state: str, **kw) -> None:
    """Record one lifecycle transition where this process reaches a
    task-event buffer; a no-op where the cluster has no GCS with a
    buffer (a bare raylet).  A failing emit never raises into the
    caller's task path: it is counted in ``emit_errors`` and logged."""
    global emit_errors
    buf = getattr(getattr(cluster, "gcs", None), "task_events", None)
    if buf is None:
        return
    try:
        buf.emit(task_id, state, **kw)
    except Exception:
        emit_errors += 1
        logger.exception("task event %s of %s dropped", state, task_id)
