"""The per-job task graph and the critical-path engine.

A port of ``ray_tpu.gcs.job_graph``:

* ``JobGraphStore``: a bounded per-job DAG, keyed by job id and
  LRU-evicted, fed by the ``TaskEventManager``'s ingest: a task's record
  is upserted at its terminal transition with the provenance fields of
  its submit (``parent_task_id``, ``arg_object_ids``), its stage
  durations and its state timestamps.  Object ids embed their creating
  task's id, so the producer of argument ``o`` is ``o[:32]``.
* ``critical_path``: walks a finished job's DAG back from the task that
  finished last, through the argument whose producer finished last
  (a data edge) or the submitting parent (a control edge), and splits
  each path entry's window into the stages (queue_wait, dispatch,
  startup, execution, with object-transfer span time carved out of the
  execution on a data edge), so the attribution sums to the path's wall
  clock.

``profile_job`` and ``critical_path_flow_events`` read the tracing
buffer through the merged timeline and come with ``util.tracing``
(ROADMAP A.4b.7).  Where the reference notes a malformed span on its
debug plane, this module logs it and counts it in ``span_errors``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch._private.config import get_config

logger = logging.getLogger(__name__)

#: Malformed object spans skipped by ``critical_path``.
span_errors = 0

# Task-id hex length (TaskID.SIZE == 16 bytes): an object id's hex is
# its creating task's hex + the little-endian index — lineage is
# recoverable from the id alone (ids.py ObjectID.FromIndex parity).
_TASK_HEX_LEN = 32

# Chain-walk guards: a cycle cannot form from well-formed provenance
# (object producers precede consumers), but records come off the wire.
_MAX_PATH_LEN = 10_000
_EPS = 1e-9

_GRAPH_FIELDS = ("task_id", "name", "job_id", "type", "state", "node_id",
                 "worker_id", "attempt", "start_time", "end_time",
                 "parent_task_id", "error")


def producer_of(object_id_hex: str) -> str:
    """The hex task id that created this object (id-embedded lineage)."""
    return object_id_hex[:_TASK_HEX_LEN]


class JobGraphStore:
    """Bounded per-job provenance DAG (LRU by job, FIFO-with-terminal
    eviction within a job).  Fed synchronously from the
    ``TaskEventManager`` ingest under ITS lock, so this store's lock is
    strictly inner — readers (`graph`, `summary`, `resolve`) take only
    the store lock."""

    def __init__(self):
        cfg = get_config()
        self._max_jobs = cfg.job_graph_max_jobs
        self._max_tasks = cfg.job_graph_max_tasks
        self._lock = threading.Lock()
        # job hex -> {"tasks": OrderedDict[tid, row], "last_update": ts,
        #             "evicted": int}
        self._jobs: "OrderedDict[str, dict]" = OrderedDict()
        self.evicted_jobs = 0
        self.evicted_tasks = 0

    # ---- ingest ---------------------------------------------------------
    def note_terminal(self, rec: dict) -> None:
        """Upsert one terminal task record into its job's graph (called
        from the TaskEventManager ingest; copies the fields the engine
        reads so later record eviction cannot lose completed-job
        provenance)."""
        job = rec.get("job_id") or ""
        if not job:
            return
        row = {k: rec.get(k) for k in _GRAPH_FIELDS}
        row["state_ts"] = dict(rec["state_ts"])
        row["stages"] = dict(rec["stages"])
        row["arg_object_ids"] = list(rec["arg_object_ids"])
        with self._lock:
            entry = self._jobs.get(job)
            if entry is None:
                entry = self._jobs[job] = {"tasks": OrderedDict(),
                                           "last_update": 0.0,
                                           "evicted": 0}
                while len(self._jobs) > self._max_jobs:
                    # LRU job eviction: least-recently-updated first.
                    victim, vent = self._jobs.popitem(last=False)
                    if victim == job:       # re-add the one we need
                        self._jobs[job] = entry = vent
                        continue
                    self.evicted_jobs += 1
            entry["tasks"][row["task_id"]] = row
            entry["last_update"] = time.time()
            self._jobs.move_to_end(job)
            while len(entry["tasks"]) > self._max_tasks:
                entry["tasks"].popitem(last=False)
                entry["evicted"] += 1
                self.evicted_tasks += 1

    # ---- query ----------------------------------------------------------
    def resolve(self, job_ref: Optional[str]) -> Optional[str]:
        """Full job hex for a reference: exact id, unique prefix, or
        ``None``/``"last"`` for the most recently updated job."""
        with self._lock:
            if not job_ref or job_ref == "last":
                return next(reversed(self._jobs), None)
            if job_ref in self._jobs:
                return job_ref
            hits = [j for j in self._jobs if j.startswith(job_ref)]
            return hits[0] if len(hits) == 1 else None

    def graph(self, job_id: str) -> Dict[str, dict]:
        """Snapshot of one job's task rows (task hex -> row copy)."""
        with self._lock:
            entry = self._jobs.get(job_id)
            if entry is None:
                return {}
            return {tid: dict(row) for tid, row in entry["tasks"].items()}

    def task_ids(self, job_id: str) -> set:
        with self._lock:
            entry = self._jobs.get(job_id)
            return set(entry["tasks"]) if entry else set()

    def num_jobs(self) -> int:
        with self._lock:
            return len(self._jobs)

    def summary(self) -> dict:
        """Store accounting for ``summarize_tasks``: per-job task/
        finished counts + wall-clock, and the eviction counters that
        keep the bounded-memory claim honest."""
        with self._lock:
            jobs = {}
            for job, entry in self._jobs.items():
                rows = entry["tasks"].values()
                ends = [r["end_time"] for r in rows
                        if r.get("end_time") is not None]
                starts = [r["start_time"] for r in rows
                          if r.get("start_time") is not None]
                jobs[job] = {
                    "tasks": len(entry["tasks"]),
                    "finished": sum(1 for r in rows
                                    if r.get("state") == "FINISHED"),
                    "failed": sum(1 for r in rows
                                  if r.get("state") == "FAILED"),
                    "evicted": entry["evicted"],
                    "wall_clock_s": (round(max(ends) - min(starts), 6)
                                     if ends and starts else None),
                }
            return {"jobs": jobs, "evicted_jobs": self.evicted_jobs,
                    "evicted_tasks": self.evicted_tasks}


# ---------------------------------------------------------------------------
# Critical-path engine.
# ---------------------------------------------------------------------------

def _segments(row: dict) -> List[tuple]:
    """Absolute stage boundaries for one task, clamped monotone: a
    missing state (e.g. a lease-reuse push that never traversed the
    scheduler, or a node-side RUNNING still riding a heartbeat) folds
    its segment to zero width instead of poisoning the attribution."""
    sts = row.get("state_ts") or {}
    b0 = row.get("start_time")
    end = row.get("end_time")
    if b0 is None or end is None:
        return []
    b1 = max(b0, sts.get("SCHEDULED", b0))
    b2 = max(b1, sts.get("SUBMITTED_TO_WORKER", b1))
    b3 = max(b2, sts.get("RUNNING", b2))
    b4 = max(b3, end)
    return [("queue_wait", b0, b1), ("dispatch", b1, b2),
            ("startup", b2, b3), ("execution", b3, b4)]


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _object_span_index(timeline: Optional[Sequence[dict]]) -> Dict[str, dict]:
    """object hex -> per-object IO record from the merged timeline's
    object-plane spans (force-recorded when the profiler is enabled):

    * ``transfers`` / ``restores`` — ``(consuming task hex, seconds,
      bytes)`` tuples, one per SUCCESSFUL span (failed and reselected
      transfer attempts carry ``ok`` and are excluded — a retry loop's
      dead attempts are not edge time);
    * ``spill_s`` — this object's *share* of batch spill time (a batch
      span charges ``dur / len(object_ids)`` per object, not the whole
      batch to each).
    """
    out: Dict[str, dict] = {}

    def slot(oid):
        row = out.get(oid)
        if row is None:
            row = out[oid] = {"transfers": [], "restores": [],
                              "spill_s": 0.0}
        return row

    for ev in timeline or ():
        try:
            name = ev.get("name", "")
            if name not in ("object.transfer", "object.restore",
                            "object.spill"):
                continue
            args = ev.get("args") or {}
            dur_s = float(ev.get("dur", 0.0)) / 1e6
            if name == "object.transfer":
                oid = args.get("object_id")
                if not oid or args.get("ok") not in (None, True):
                    continue
                slot(oid)["transfers"].append(
                    (args.get("task_id") or "", dur_s,
                     int(args.get("bytes") or 0)))
            elif name == "object.restore":
                oid = args.get("object_id")
                if not oid:
                    continue
                slot(oid)["restores"].append(
                    (args.get("task_id") or "", dur_s))
            else:                         # spill batches carry id lists
                ids = args.get("object_ids") or ()
                # The id list is capped at the emitter (64) but the
                # span's ``objects`` field carries the TRUE batch size:
                # divide by that, or a 1000-object batch would inflate
                # each listed object's share ~16x.
                share = dur_s / max(1, int(args.get("objects")
                                           or len(ids)))
                for oid in ids:
                    slot(oid)["spill_s"] += share
        except Exception:
            # A malformed span is skipped visibly: a broken emitter
            # would otherwise read as no transfer time on any edge.
            global span_errors
            span_errors += 1
            logger.exception("malformed object span skipped")
            continue
    return out


def _edge_io(io: Optional[dict], consumer_tid: str) -> dict:
    """This consumer's IO on one object edge.  A shared arg is pulled
    once per consuming node: spans tagged with THIS consumer's task id
    are preferred, untagged spans (pull/pump threads with no task
    context) are the fallback — summing every consumer's tagged spans
    onto one edge would charge a fan-out's whole broadcast to the
    critical task."""
    io = io or {}
    transfers = io.get("transfers", ())
    mine = [t for t in transfers if t[0] == consumer_tid] or \
        [t for t in transfers if not t[0]]
    restores = io.get("restores", ())
    r_mine = [r for r in restores if r[0] == consumer_tid] or \
        [r for r in restores if not r[0]]
    return {
        "transfer_s": sum(t[1] for t in mine),
        "bytes": max((t[2] for t in mine), default=0) or
        max((t[2] for t in transfers), default=0),
        "restore_s": sum(r[1] for r in r_mine),
        "spill_s": io.get("spill_s", 0.0),
    }


def critical_path(tasks: Dict[str, dict],
                  timeline: Optional[Sequence[dict]] = None,
                  top_k: int = 3) -> dict:
    """Critical path of one job's DAG with stage/node/edge attribution.

    ``tasks`` is a JobGraphStore.graph() snapshot (task hex -> row).
    Returns a dict with ``path`` (root-first entries, each with a
    ``stages`` split whose values sum to the entry's ``window_s``),
    ``attribution`` rollups, and ``near_critical`` alternatives.  The
    per-entry windows tile ``[path_start, sink_end]`` exactly, so
    attribution sums to the path wall-clock by construction.
    """
    finished = {tid: row for tid, row in tasks.items()
                if row.get("end_time") is not None}
    if not finished:
        return {"error": "no finished tasks in the job graph",
                "tasks": len(tasks)}
    spans = _object_span_index(timeline)
    sink_id = max(finished, key=lambda t: finished[t]["end_time"])

    def gating_producer(row):
        """(object hex, producer row) of the arg whose task finished
        last, or (None, None) when no finished producer is known."""
        best = (None, None)
        for oid in row.get("arg_object_ids") or ():
            p = finished.get(producer_of(oid))
            if p is None:
                continue
            if best[1] is None or p["end_time"] > best[1]["end_time"]:
                best = (oid, p)
        return best

    entries: List[dict] = []
    near: List[dict] = []
    tid, cursor = sink_id, finished[sink_id]["end_time"]
    visited = set()
    while tid is not None and tid not in visited and \
            len(entries) < _MAX_PATH_LEN:
        visited.add(tid)
        row = finished[tid]
        start = row["start_time"]
        oid, gate = gating_producer(row)
        gated = gate is not None and gate["end_time"] > start + _EPS
        window_start = gate["end_time"] if gated else start
        window_start = min(window_start, cursor)
        stages: Dict[str, float] = {}
        for name, s0, s1 in _segments(row):
            ov = _overlap(s0, s1, window_start, cursor)
            if ov > _EPS:
                stages[name] = ov
        edge = None
        if gated:
            # Arg materialization happens after RUNNING is emitted
            # (executor resolves args inside the execute frame), so
            # THIS consumer's edge-transfer + restore time is carved
            # out of the execution segment.  Producer-side spill time
            # is reported on the edge but NOT carved — it was paid in
            # the producer's/spiller's frame, not this window.
            io = _edge_io(spans.get(oid), tid)
            moved = min(io["transfer_s"] + io["restore_s"],
                        stages.get("execution", 0.0))
            if moved > _EPS:
                stages["execution"] -= moved
                stages["transfer"] = moved
            edge = {"object_id": oid,
                    "producer_task_id": gate["task_id"],
                    "producer": gate.get("name", ""),
                    "transfer_s": round(io["transfer_s"], 6),
                    "restore_s": round(io["restore_s"], 6),
                    "spill_s": round(io["spill_s"], 6),
                    "bytes": io["bytes"]}
            # Near-critical bookkeeping: the runner-up gating args at
            # this fan-in, ranked by slack (how much sooner they were
            # ready than the winner).
            for alt_oid in row.get("arg_object_ids") or ():
                p = finished.get(producer_of(alt_oid))
                if p is None or alt_oid == oid:
                    continue
                near.append({"at_task": row.get("name", ""),
                             "instead_of": gate.get("name", ""),
                             "candidate": p.get("name", ""),
                             "candidate_task_id": p["task_id"],
                             "slack_s": round(
                                 gate["end_time"] - p["end_time"], 6)})
        window = max(0.0, cursor - window_start)
        other = window - sum(stages.values())
        if other > _EPS:
            stages["other"] = other
        entries.append({
            "task_id": tid, "name": row.get("name", ""),
            "node_id": row.get("node_id", ""),
            "window_start": window_start, "window_end": cursor,
            "window_s": round(window, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "edge": edge,
        })
        if gated:
            cursor, tid = gate["end_time"], gate["task_id"]
            continue
        parent = finished.get(row.get("parent_task_id") or "")
        if parent is not None and parent["start_time"] < start - _EPS:
            # Control edge: the chain continues at the submitter, whose
            # entry window ends at this task's submit instant.
            cursor, tid = start, parent["task_id"]
            continue
        break
    entries.reverse()                      # root-first

    path_start = entries[0]["window_start"]
    sink_end = finished[sink_id]["end_time"]
    path_s = max(sink_end - path_start, _EPS)
    by_stage: Dict[str, float] = {}
    by_node: Dict[str, float] = {}
    for e in entries:
        for stage, v in e["stages"].items():
            by_stage[stage] = by_stage.get(stage, 0.0) + v
        node = e["node_id"] or "<unknown>"
        by_node[node] = by_node.get(node, 0.0) + e["window_s"]
    near.sort(key=lambda r: r["slack_s"])
    starts = [r["start_time"] for r in finished.values()]
    wall = max(r["end_time"] for r in finished.values()) - min(starts)
    top = sorted(by_stage.items(), key=lambda kv: -kv[1])
    hot_node = max(by_node.items(), key=lambda kv: kv[1])[0] \
        if by_node else ""
    headline = ", ".join(
        f"{100.0 * v / path_s:.0f}% {stage}" for stage, v in top[:3])
    if hot_node:
        headline += f" (hottest node {hot_node[:12] or '?'})"
    return {
        "job_id": next(iter(finished.values())).get("job_id", ""),
        "sink_task": {"task_id": sink_id,
                      "name": finished[sink_id].get("name", ""),
                      "node_id": finished[sink_id].get("node_id", "")},
        "path": entries,
        "path_s": round(path_s, 6),
        "wall_clock_s": round(wall, 6),
        "coverage": {"tasks": len(tasks), "finished": len(finished),
                     "path_len": len(entries)},
        "attribution": {
            "by_stage": {k: {"seconds": round(v, 6),
                             "fraction": round(v / path_s, 4)}
                         for k, v in by_stage.items()},
            "by_node": {k: {"seconds": round(v, 6),
                            "fraction": round(v / path_s, 4)}
                        for k, v in by_node.items()},
        },
        "headline": headline,
        "near_critical": near[:max(0, top_k)],
    }
