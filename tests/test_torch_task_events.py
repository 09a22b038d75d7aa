"""The port's task-event pipeline (``ray_tpu_torch.gcs.task_events`` and
``gcs.job_graph``) against the JAX package's, on the CPU.

* The ``TestTaskEvents`` cases of ``tests/test_observability.py`` that
  need no process worker, under each package's ``init``, reading
  ``gcs.task_event_manager`` (through ``flushed_manager``) where the
  reference reads ``experimental.state`` (ROADMAP A.4b.10): the
  lifecycle, the attempt counter of a retry, a failed task's error, a
  500-task burst with no event dropped, filters and pages, a task's
  record by id; and an actor's: its creation task's records and its
  methods' lifecycles (PENDING_ARGS_AVAIL at the submit,
  SUBMITTED_TO_WORKER at the actor submitter, RUNNING, FINISHED or
  FAILED with the error), all on the actor's node and worker. The
  outcomes (states, attempts, counts; no time stamp) must be equal.
* A lineage reconstruction rewinds the task's FINISHED record
  (RECONSTRUCTING with an attempt above the retries, then FINISHED
  again), under both packages.
* ``TaskEventManager`` (with its ``JobGraphStore``) and ``critical_path``
  of each package fed the same seeded batches, with their time stamps:
  equal records, summaries, stage rollups, graphs and critical paths,
  exactly.
"""

import importlib
import os
import time

import numpy as np
import pytest

from torch_cluster_util import both, wait_until

PACKAGES = ("ray_tpu", "ray_tpu_torch")
LIFECYCLE = ["PENDING_ARGS_AVAIL", "SCHEDULED", "SUBMITTED_TO_WORKER",
             "RUNNING", "FINISHED"]
ORDER = LIFECYCLE + ["FAILED"]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def manager(env):
    return mod(env.name, "gcs.task_events").flushed_manager(env.cluster.gcs)


def rows_named(env, fragment, terminal_within=10.0):
    """The records whose name holds ``fragment``, once the last is
    terminal (a FINISHED can trail the driver's get by a flush)."""
    def rows():
        return [r for r in manager(env).tasks() if fragment in r["name"]]
    deadline = time.monotonic() + terminal_within
    while time.monotonic() < deadline:
        out = rows()
        if out and out[-1]["state"] in ("FINISHED", "FAILED"):
            return out
        time.sleep(0.05)
    return rows()


def lifecycle(rec):
    """A record's lifecycle as comparable data, with the reference
    test's checks: every state stamped, in order, stamps not going down."""
    states = [s for s, _ts in rec["events"]]
    indices = [ORDER.index(s) for s in states if s in ORDER]
    ts = [rec["state_ts"][s] for s in LIFECYCLE if s in rec["state_ts"]]
    return (sorted(set(states), key=ORDER.index) if indices else states,
            indices == sorted(indices), ts == sorted(ts), rec["state"],
            bool(rec["node_id"]), bool(rec["worker_id"]),
            rec["duration_s"] is not None and rec["duration_s"] >= 0)


# -- tests/test_observability.py::TestTaskEvents -------------------------------

def add_one_te(x):
    return x + 1


def case_lifecycle(env):
    assert env.pkg.get(env.pkg.remote(add_one_te).remote(1), timeout=30) == 2
    rows = rows_named(env, "add_one_te")
    return len(rows), lifecycle(rows[-1])


def flaky_te(path):
    if not os.path.exists(path):
        open(path, "w").close()
        raise ValueError("first attempt fails")
    return "ok"


def case_attempt_counter_on_retry(env):
    marker = os.path.join(env.temp_dir, "flaky_marker")
    f = env.pkg.remote(max_retries=2, retry_exceptions=True)(flaky_te)
    value = env.pkg.get(f.remote(marker), timeout=30)
    rec = rows_named(env, "flaky_te")[-1]
    return value, rec["attempt"], rec["state"], lifecycle(rec)[0]


def boom_te():
    raise RuntimeError("deliberate")


def case_failed_task_records_error(env):
    try:
        env.pkg.get(env.pkg.remote(max_retries=0)(boom_te).remote(),
                    timeout=30)
        raised = False
    except Exception:  # noqa: BLE001 — the error is the outcome
        raised = True
    rec = rows_named(env, "boom_te")[-1]
    return (raised, rec["state"], "FAILED" in rec["state_ts"],
            "deliberate" in (rec["error"] or ""))


def unit_te(i):
    return i


def case_burst_500_tasks_zero_drops(env):
    f = env.pkg.remote(unit_te)
    out = env.pkg.get([f.remote(i) for i in range(500)], timeout=120)
    mgr = manager(env)
    rows = [r for r in mgr.tasks() if "unit_te" in r["name"]]
    finished = [r for r in rows if r["state"] == "FINISHED"]
    name = next(k for k in mgr.summarize() if "unit_te" in k)
    stages = mgr.latency_summary()
    return (sorted(out) == list(range(500)), mgr.num_dropped_at_source(),
            len(finished), mgr.summarize()[name]["count"],
            mgr.summarize()[name]["by_state"],
            sorted(k for k in stages),
            all(stages[k]["count"] >= 500 for k in stages),
            {lifecycle(r)[0] == LIFECYCLE for r in finished})


def page_te(i):
    return i


def case_filters_and_pagination(env):
    f = env.pkg.remote(page_te)
    env.pkg.get([f.remote(i) for i in range(10)], timeout=60)
    wait_until(lambda: sum(r["state"] == "FINISHED"
                           for r in manager(env).tasks()) == 10,
               10, "ten FINISHED records")
    mgr = manager(env)
    finished = mgr.tasks(pred=lambda r: r["state"] == "FINISHED")
    page1, page2 = mgr.tasks(limit=4), mgr.tasks(limit=4, offset=4)
    not_finished = mgr.tasks(pred=lambda r: r["state"] != "FINISHED")
    return (len(finished), len(page1), len(page2),
            {r["task_id"] for r in page1}.isdisjoint(
                {r["task_id"] for r in page2}),
            len(not_finished), mgr.num_tracked())


def table_te():
    return 1


def case_record_by_task_id(env):
    ref = env.pkg.remote(table_te).remote()
    assert env.pkg.get(ref, timeout=30) == 1
    tid = ref.task_id().hex()
    wait_until(lambda: (manager(env).get(tid) or {}).get("state")
               == "FINISHED", 10, "the task's FINISHED record")
    rec = manager(env).get(tid)
    return rec["task_id"] == tid, rec["state"], rec["name"].split(".")[-1]


def _produce():
    return np.ones(2_000_000, dtype=np.float32)


def case_reconstruction_rewinds_the_record(env):
    producer = env.add_node("producer", 1, {"prod": 1})
    f = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0,
                       max_retries=2)(_produce)
    ref = f.remote()
    # Ready without a fetch: the only copy stays on the producer.
    ready, _ = env.pkg.wait([ref], timeout=10)
    env.add_node("replacement", 1, {"prod": 1})
    env.cluster.remove_node(producer)
    time.sleep(0.3)
    again = env.pkg.get(ref, timeout=15).sum()
    tid = ref.task_id().hex()
    wait_until(lambda: (manager(env).get(tid) or {}).get("state")
               == "FINISHED", 10, "the rerun's FINISHED record")
    rec = manager(env).get(tid)
    states = [s for s, _ts in rec["events"]]
    return (len(ready), again, rec["attempt"], rec["state"],
            "RECONSTRUCTING" in states,
            states.index("RECONSTRUCTING") < len(states) - 1,
            env.names.get(rec["node_id"], rec["node_id"]))


class CounterTe:
    def __init__(self, start):
        self.n = start

    def incr(self):
        self.n += 1
        return self.n

    def boom(self):
        raise RuntimeError("deliberate")


def _creation_records(env):
    """The records of the creation task: it has no submit event (the
    GCS places it), so its record has no name, or the class's
    ``__init__``."""
    def rows():
        return [r for r in manager(env).tasks()
                if "CounterTe.__init__" in r["name"] or not r["name"]]
    wait_until(lambda: any("RUNNING" in r["state_ts"] for r in rows()),
               10, "the creation's record")
    return rows()


def case_actor_lifecycle(env):
    """An actor's creation and its methods' lifecycles: each method
    goes PENDING_ARGS_AVAIL, SUBMITTED_TO_WORKER, RUNNING, FINISHED on
    the actor's node and worker; the creation task is stamped where the
    raylet placed it and where it ran."""
    c = env.pkg.remote(CounterTe).remote(10)
    out = env.pkg.get([c.incr.remote() for _ in range(3)], timeout=30)
    rows = rows_named(env, "CounterTe.incr")
    wait_until(lambda: sum(r["state"] == "FINISHED"
                           for r in rows_named(env, "CounterTe.incr")) == 3,
               10, "three FINISHED records")
    rows = rows_named(env, "CounterTe.incr")
    creation = _creation_records(env)
    created = [sorted(set(s for s, _ts in r["events"]), key=ORDER.index)
               for r in creation]
    return (out, len(rows), [lifecycle(r) for r in rows],
            len({(r["node_id"], r["worker_id"]) for r in rows}),
            created, [bool(r["node_id"]) for r in creation])


def case_actor_method_failure(env):
    c = env.pkg.remote(CounterTe).remote(0)
    try:
        env.pkg.get(c.boom.remote(), timeout=30)
        raised = False
    except RuntimeError:
        raised = True
    rec = rows_named(env, "CounterTe.boom")[-1]
    return (raised, rec["state"], lifecycle(rec)[0],
            "deliberate" in (rec["error"] or ""))


@pytest.mark.parametrize("case", [
    case_lifecycle, case_attempt_counter_on_retry,
    case_failed_task_records_error, case_burst_500_tasks_zero_drops,
    case_filters_and_pagination, case_record_by_task_id,
    case_reconstruction_rewinds_the_record, case_actor_lifecycle,
    case_actor_method_failure,
], ids=lambda c: c.__name__)
def test_task_events_case_matches_jax(case):
    jax, port = both(case, 2)
    assert port == jax
    assert port[0] == "value", port


def test_actor_method_lifecycle_is_the_reference_one():
    jax, port = both(case_actor_lifecycle, 2)
    assert port == jax
    out, n, lifecycles, places, _created, _placed = jax[1]
    assert (out, n, places) == ([11, 12, 13], 3, 1)
    # A method is never leased: no SCHEDULED.
    method = [s for s in LIFECYCLE if s != "SCHEDULED"]
    assert lifecycles == [(method, True, True, "FINISHED",
                           True, True, True)] * 3


def test_lifecycle_is_the_reference_one():
    jax, port = both(case_lifecycle, 2)
    assert port == jax == ("value", (1, (LIFECYCLE, True, True, "FINISHED",
                                         True, True, True)))


# -- the manager, the job graph and the critical path on the same batches -----

def _batches(seed, n_tasks=60, n_jobs=2):
    """Seeded event batches from two buffers: a DAG of tasks per job
    (each with a parent and argument objects of earlier tasks), every
    lifecycle stamped, some retried, some failed, some reconstructed,
    delivered out of order across the two buffers."""
    rng = np.random.default_rng(seed)
    t0 = 1_000.0
    owner, node = [], []
    tasks = []
    for i in range(n_tasks):
        job = f"{int(rng.integers(n_jobs)):08x}"
        tid = f"{i:032x}"
        earlier = [t for t in tasks if t[1] == job]
        parent = earlier[int(rng.integers(len(earlier)))][0] \
            if earlier and rng.random() < 0.5 else ""
        args = [f"{t[0]}{1:08x}" for t in earlier
                if rng.random() < 0.15][:3]
        tasks.append((tid, job))
        ts = t0 + float(rng.uniform(0, 5))
        sub = {"task_id": tid, "state": "PENDING_ARGS_AVAIL", "ts": ts,
               "name": f"f{int(rng.integers(4))}", "job_id": job}
        if parent:
            sub["parent"] = parent
        if args:
            sub["args"] = args
        owner.append(sub)
        attempts = 2 if rng.random() < 0.2 else 1
        for attempt in range(attempts):
            extra = {"attempt": attempt} if attempt else {}
            if attempt:
                ts += 0.01
                owner.append(dict({"task_id": tid, "state":
                                   "PENDING_ARGS_AVAIL", "ts": ts}, **extra))
            for state, who in (("SCHEDULED", node),
                               ("SUBMITTED_TO_WORKER", owner),
                               ("RUNNING", node)):
                ts += float(rng.exponential(0.002))
                ev = dict({"task_id": tid, "state": state, "ts": ts,
                           "node_id": f"n{int(rng.integers(3))}",
                           "worker_id": "w"}, **extra)
                who.append(ev)
            ts += float(rng.exponential(0.01))
            last = attempt == attempts - 1
            if not last or rng.random() < 0.1:
                owner.append(dict({"task_id": tid, "state": "FAILED",
                                   "ts": ts, "error": "boom"}, **extra))
            else:
                owner.append(dict({"task_id": tid, "state": "FINISHED",
                                   "ts": ts}, **extra))
        if rng.random() < 0.1:
            ts += 0.5
            owner.append({"task_id": tid, "state": "RECONSTRUCTING",
                          "ts": ts, "attempt": 5, "name": "recon"})
            for state in LIFECYCLE[1:]:
                ts += 0.001
                owner.append({"task_id": tid, "state": state, "ts": ts,
                              "attempt": 5})
    out = []
    for buffer_id, events in (("head", owner), ("node", node)):
        order = rng.permutation(len(events))
        for lo in range(0, len(events), 37):
            out.append({"buffer_id": buffer_id,
                        "events": [events[j] for j in order[lo:lo + 37]],
                        "dropped": int(lo // 37 % 3)})
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_graph_and_critical_path_match_jax(seed):
    batches = _batches(seed)

    def case(pkg):
        te = mod(pkg, "gcs.task_events")
        jg = mod(pkg, "gcs.job_graph")
        pub = mod(pkg, "gcs.pubsub").Publisher()
        mgr = te.TaskEventManager(pub, max_tasks=50)
        for batch in batches:
            pub.publish(te.TASK_EVENT_CHANNEL, b"",
                        {k: (list(v) if k == "events" else v)
                         for k, v in batch.items()})
        store = mgr.job_graphs
        jobs = sorted(store.summary()["jobs"])
        paths = {job: jg.critical_path(store.graph(job)) for job in jobs}
        summary = store.summary()
        return (mgr.tasks(), mgr.num_tracked(), mgr.evicted,
                mgr.num_dropped_at_source(), mgr.summarize(),
                mgr.latency_summary(), jobs,
                {job: store.graph(job) for job in jobs},
                {job: {k: v for k, v in row.items()
                       if k != "wall_clock_s"}
                 for job, row in summary["jobs"].items()},
                summary["evicted_tasks"], paths, store.resolve(None),
                store.resolve(jobs[0][:6]))
    jax, port = [case(pkg) for pkg in PACKAGES]
    assert port == jax
    tasks, _, evicted = port[:3]
    assert evicted > 0 and any(r["state"] == "FAILED" for r in tasks)
    assert all("path" in p for p in port[10].values())


def test_buffer_flushes_every_event_as_in_jax():
    """The striped buffer of each package, fed the same emits from four
    threads at a small cap: the same events reach the manager, and the
    drops are counted the same way."""
    import threading

    def case(pkg):
        te = mod(pkg, "gcs.task_events")
        pub = mod(pkg, "gcs.pubsub").Publisher()
        mgr = te.TaskEventManager(pub)
        buf = te.TaskEventBuffer(pub, max_buffer=64, batch_size=16,
                                 stripes=4)
        barrier = threading.Barrier(4)

        def emitter(k):
            barrier.wait()
            for i in range(200):
                buf.emit(f"{k:02x}{i:030x}", "PENDING_ARGS_AVAIL",
                         name="e", job_id="01")
        threads = [threading.Thread(target=emitter, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        buf.stop()
        return mgr.num_tracked() + buf.dropped, buf.num_buffered(), \
            mgr.num_dropped_at_source() == buf.dropped
    jax, port = [case(pkg) for pkg in PACKAGES]
    assert port == jax == (800, 0, True)


def test_stop_during_the_flushers_start_joins_it(monkeypatch):
    """A ``stop`` that comes while an emit is starting the flusher
    thread (a shutdown racing a late task event) waits for the start
    and joins the thread, where it used to find the thread created but
    not started and raise.  The port joins its flusher; the reference
    never does, so this is the port's alone."""
    import threading

    te = mod("ray_tpu_torch", "gcs.task_events")
    started = threading.Event()

    class SlowStart(threading.Thread):
        def start(self):
            started.set()
            time.sleep(0.2)
            super().start()

    class Threading:
        """The module's ``threading`` with a flusher slow to start."""
        Thread = SlowStart

        def __getattr__(self, name):
            return getattr(threading, name)

    buf = te.TaskEventBuffer(mod("ray_tpu_torch", "gcs.pubsub").Publisher(),
                             batch_size=1, stripes=1)
    monkeypatch.setattr(te, "threading", Threading())
    emitter = threading.Thread(
        target=lambda: buf.emit("00" * 16, "RUNNING"))
    emitter.start()
    assert started.wait(10)
    buf.stop()
    emitter.join(10)
    assert not emitter.is_alive()
    assert buf._flusher is not None and not buf._flusher.is_alive()


def test_emit_counts_a_failing_buffer():
    """Divergence: the port's ``emit`` counts and logs an error the
    reference swallows."""
    import types

    from ray_tpu_torch.gcs import task_events as te

    def broken(*a, **kw):
        raise RuntimeError("buffer down")
    cluster = types.SimpleNamespace(
        gcs=types.SimpleNamespace(task_events=types.SimpleNamespace(
            emit=broken)))
    before = te.emit_errors
    te.emit(cluster, "00" * 16, te.RUNNING)
    te.emit(types.SimpleNamespace(), "00" * 16, te.RUNNING)  # no GCS
    assert te.emit_errors == before + 1


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_task_events")
