"""The port's heartbeat, resource broadcast and node death against the
JAX package's, on the CPU.

* ``GcsHeartbeatManager`` of each package under one seeded script of
  beats, ticks (posted to a ``gcs`` loop, as the manager's own timer
  would run them), registrations and pauses: the same suspect,
  recovered and dead callbacks in the same order.
* ``GcsResourceManager`` of each package polling stub raylets (two in
  the process, one ``is_remote_proxy``) through the same reports: the
  same batches, full ones for the in-process raylets, deltas and the
  20-period resync for the remote one, ``suspect`` on every batch.
* The cases of ``tests/test_failure.py`` that need no actor: death by
  heartbeat timeout (``:12``, with the SUSPECT then DEAD publication),
  reconstruction after a node's loss (``:71``, by ``remove_node`` and by
  ``kill_node``), and a prompt ``ObjectLostError`` when no copy and no
  lineage is left (``:104``, with a normal task and lineage pinning off
  where the reference uses an actor task), each under both packages'
  ``init`` with the outcomes compared; a placement group rescheduled
  after ``kill_node``.
* One lease burst at a raylet whose view masks a suspect node: the
  JAX package's replies, tick by tick, and none on the masked node.
* The port's own: the heartbeat timer's catch-up, the resource round's
  re-arm, and four repairs of ROADMAP C.33: leases a tick puts back after
  its raylet's kill are answered, a task a killed node's thread submits
  is leased on a live raylet, a beat sent before a kill that lands
  after it does not delay the death (with C.34, the same late beat to
  both packages' managers: the reference restarts its count), and a
  check after checks the grid lost reads the clock; and C.36, a worker
  stopped by its node's kill handed no task by either package's
  submitter, stub worker and raylet given.

Every comparison is exact.  The heartbeats run at the defaults (100 ms,
suspect at 15 missed, dead at 30) in the end-to-end cases.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import torch_runtime_util as rt
from ray_tpu._private.config import get_config as jax_config
from ray_tpu_torch._private.config import get_config as port_config
from torch_cluster_util import both, wait_until

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_on(loop, fn):
    """Run ``fn`` on ``loop`` and wait for it."""
    done, out = threading.Event(), []

    def run():
        try:
            out.append(fn())
        finally:
            done.set()
    loop.post(run, "test.run")
    assert done.wait(30), f"loop {loop.name} did not answer"
    return out[0] if out else None


@pytest.fixture
def quiet_gcs_timers(monkeypatch):
    """Both packages' GCS timers never fire on their own: the test posts
    every tick and every broadcast round."""
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "raylet_heartbeat_period_milliseconds",
                            int(rt.NEVER_MS))
        monkeypatch.setattr(cfg, "gcs_resource_broadcast_period_milliseconds",
                            int(rt.NEVER_MS))
        monkeypatch.setattr(cfg, "num_heartbeats_timeout", 6)
        monkeypatch.setattr(cfg, "num_heartbeats_suspect", 3)


# -- the heartbeat manager ---------------------------------------------------

def _heartbeat_script(seed, n_ops=400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        node = int(rng.integers(4))
        if r < 0.45:
            ops.append(("tick",))
        elif r < 0.85:
            ops.append(("beat", node))
        elif r < 0.92:
            ops.append(("register", node))
        elif r < 0.96:
            ops.append(("unregister", node))
        else:
            ops.append(("pause", bool(rng.integers(2))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heartbeat_manager_callbacks_match_jax(quiet_gcs_timers, seed):
    script = _heartbeat_script(seed)

    def case(pkg):
        ids = mod(pkg, "_private.ids")
        loop = mod(pkg, "_private.event_loop").EventLoop(f"gcs-hb-{pkg}")
        events = []
        nodes = [ids.NodeID(bytes([i + 1]) * ids.NodeID.SIZE)
                 for i in range(4)]
        name = {n: i for i, n in enumerate(nodes)}
        try:
            hb = mod(pkg, "gcs.server").GcsHeartbeatManager(
                loop, lambda n: events.append(("dead", name[n])),
                on_node_suspect=lambda n: events.append(
                    ("suspect", name[n])),
                on_node_recovered=lambda n: events.append(
                    ("recovered", name[n])))
            for node in nodes[:3]:
                hb.register(node)
            beats = []
            for op in script:
                if op[0] == "tick":
                    run_on(loop, hb._tick)
                elif op[0] == "beat":
                    # The port's raylets stamp their beats: stamped at the
                    # call, a beat clears the count as the reference's does.
                    stamp = (time.monotonic(),) if pkg == "ray_tpu_torch" \
                        else ()
                    beats.append(hb.heartbeat(nodes[op[1]], *stamp))
                elif op[0] == "register":
                    hb.register(nodes[op[1]])
                elif op[0] == "unregister":
                    hb.unregister(nodes[op[1]])
                else:
                    hb.pause(op[1])
            return events, beats, [hb.is_suspect(n) for n in nodes]
        finally:
            loop.stop()
    jax, port = both_packages(case)
    assert port == jax
    assert any(e[0] == "dead" for e in port[0]) and \
        any(e[0] == "recovered" for e in port[0])


def both_packages(case):
    return [case(pkg) for pkg in PACKAGES]


# -- the resource manager's broadcast -----------------------------------------

class _StubRaylet:
    """What the GCS resource manager reads of a raylet: its id, its
    ledger, a scripted report a round and the batches it is sent."""

    def __init__(self, pkg, node_id, total, reports, remote):
        res = mod(pkg, "scheduler.resources")
        self.node_id = node_id
        self.local_resources = res.NodeResources(total)
        self.is_remote_proxy = remote
        self._reports = iter(reports)
        self.batches = []

    def get_resource_report(self):
        return next(self._reports)

    def update_resource_usage(self, batch):
        self.batches.append(batch)


def _reports(rng, total, n):
    """``n`` reports: the availability changes on about a third of the
    rounds, so most deltas are empty."""
    avail = dict(total)
    out = []
    for _ in range(n):
        if rng.random() < 0.35:
            avail = {k: float(np.floor(v * rng.uniform(0, 1) * 2) / 2)
                     for k, v in total.items()}
        out.append({"available": dict(avail), "total": dict(total),
                    "load": {"queued": 0, "dispatch": 0}})
    return out


def test_resource_broadcast_batches_match_jax(quiet_gcs_timers):
    totals = [{"CPU": 4.0, "memory": 8.0}, {"CPU": 8.0},
              {"CPU": 2.0, "GPU": 1.0}, {"CPU": 16.0, "memory": 4.0}]
    rounds = 45

    def case(pkg):
        ids = mod(pkg, "_private.ids")
        loop = mod(pkg, "_private.event_loop").EventLoop(f"gcs-rm-{pkg}")
        try:
            rm = mod(pkg, "gcs.server").GcsResourceManager(
                loop, mod(pkg, "gcs.pubsub").Publisher())
            rng = np.random.default_rng(7)
            size = ids.NodeID.SIZE
            stubs = [_StubRaylet(pkg, ids.NodeID(bytes([i + 1]) * size),
                                 totals[i], _reports(rng, totals[i], rounds),
                                 remote=(i == 2))
                     for i in range(4)]
            name = {s.node_id: i for i, s in enumerate(stubs)}
            for s in stubs[:3]:
                rm.register_raylet(s.node_id, s, s.local_resources)
            live = []
            for r in range(rounds):
                if r == 5:
                    rm.set_suspect(stubs[1].node_id, True)
                if r == 9:
                    rm.set_suspect(stubs[1].node_id, False)
                if r == 14:
                    rm.unregister_raylet(stubs[0].node_id)
                if r == 17:
                    rm.register_raylet(stubs[3].node_id, stubs[3],
                                       stubs[3].local_resources)
                if r == 30:
                    rm.set_suspect(stubs[3].node_id, True)
                run_on(loop, rm._poll_and_broadcast)
                live.append(rm.live_available_resources())
            sent = {i: [{"rows": {name[k]: v for k, v in b["rows"].items()},
                         "full": b["full"],
                         "removed": sorted(name[k] for k in b["removed"]),
                         "suspect": sorted(name[k] for k in b["suspect"])}
                        for b in s.batches] for i, s in enumerate(stubs)}
            view = rm.view
            return sent, live, view.total_cluster_resources(), \
                view.available_cluster_resources(), \
                sorted(name[n] for n in view.masked_nodes())
        finally:
            loop.stop()
    jax, port = both_packages(case)
    assert port == jax
    sent = port[0]
    assert all(b["full"] for b in sent[1]), "in-process: full every round"
    assert not all(b["full"] for b in sent[2]), "remote: deltas"
    assert any(b["suspect"] == [1] for b in sent[2])


# -- tests/test_failure.py ----------------------------------------------------

def _node_states(env, node_id):
    """Every NODE_CHANNEL state published for ``node_id`` from now on."""
    pubsub = mod(env.name, "gcs.pubsub")
    states = []
    env.cluster.gcs.publisher.subscribe(
        pubsub.NODE_CHANNEL, node_id.binary(),
        lambda _k, m: states.append(m["state"]))
    return states


def case_death_by_heartbeat_timeout(env):
    victim = env.add_node("victim", 1)
    assert env.cluster.wait_for_nodes(2)
    states = _node_states(env, victim.node_id)
    env.cluster.kill_node(victim)
    gcs = env.cluster.gcs
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and \
            victim.node_id in gcs.node_manager.alive_nodes:
        time.sleep(0.05)
    info = gcs.node_manager.dead_nodes.get(victim.node_id, {})
    alive = sorted(n["node_name"] for n in env.pkg.nodes() if n["Alive"])
    return (victim.node_id not in gcs.node_manager.alive_nodes,
            victim.node_id in gcs.node_manager.dead_nodes,
            info.get("death_reason"), states, alive)


def _produce():
    return np.ones(2_000_000, dtype=np.float32)


def _object_lost_on(env, kill):
    """``:71``'s script; with ``kill``, the producer dies by missed
    heartbeats and the driver never fetched the array, so its only copy
    dies with the node and lineage recomputes it."""
    producer = env.add_node("producer", 1, {"prod": 1})
    assert env.cluster.wait_for_nodes(2)
    produce = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0,
                             max_retries=2)(_produce)
    ref = produce.remote()
    if kill:
        first = len(env.pkg.wait([ref], timeout=10)[0])
    else:
        first = env.pkg.get(ref).sum()
    env.add_node("replacement", 1, {"prod": 1})
    if kill:
        env.cluster.kill_node(producer)
        wait_until(lambda: producer.node_id in
                   env.cluster.gcs.node_manager.dead_nodes, 15,
                   "the producer's death")
    else:
        env.cluster.remove_node(producer)
    time.sleep(0.3)
    return first, env.pkg.get(ref, timeout=15).sum()


def case_reconstruction_after_remove_node(env):
    return _object_lost_on(env, kill=False)


def case_reconstruction_after_kill_node(env):
    return _object_lost_on(env, kill=True)


def case_unrecoverable_loss_raises_object_lost(env):
    env.add_node("producer", 1, {"prod": 1})
    producer = env.cluster.raylets()[-1]
    assert env.cluster.wait_for_nodes(2)
    produce = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0,
                             max_retries=0)(_produce)
    ref = produce.remote()
    ready, _ = env.pkg.wait([ref], timeout=10)
    assert ready
    env.cluster.remove_node(producer)
    time.sleep(0.3)
    t0 = time.monotonic()
    try:
        env.pkg.get(ref, timeout=20)
        raised = None
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        raised = type(e).__name__
    return raised, time.monotonic() - t0 < 10


def case_group_rescheduled_after_kill_node(env):
    victim = env.add_node("victim", 2, {"spot": 1})
    pg = env.util.placement_group([{"CPU": 1, "spot": 1}], strategy="PACK")
    assert pg.wait(10)
    before = env.bundle_nodes(pg)
    env.add_node("replacement", 2, {"spot": 1})
    env.broadcast()
    env.cluster.kill_node(victim)
    wait_until(lambda: env.bundle_nodes(pg) == {0: "replacement"}, 20,
               "the group's bundle on the replacement")
    info = env.util.placement_group_table(pg)
    return before, env.bundle_nodes(pg), info["state"], pg.wait(5)


@pytest.mark.parametrize("case, system_config", [
    (case_death_by_heartbeat_timeout, None),
    (case_reconstruction_after_remove_node, None),
    (case_reconstruction_after_kill_node, None),
    (case_unrecoverable_loss_raises_object_lost,
     {"lineage_pinning_enabled": False}),
    (case_group_rescheduled_after_kill_node, None),
], ids=lambda c: getattr(c, "__name__", ""))
def test_failure_case_matches_jax(case, system_config):
    jax, port = both(case, 1, system_config)
    assert port == jax
    assert port[0] == "value", port


def test_death_outcomes_are_the_expected_ones():
    """The shared outcome of the death case, spelled out: SUSPECT then
    DEAD, by heartbeat timeout, and only the head left alive."""
    jax, port = both(case_death_by_heartbeat_timeout, 1)
    assert port == jax == ("value", (True, True, "heartbeat timeout",
                                     ["SUSPECT", "DEAD"], ["head"]))


# -- a lease burst with a node suspect ----------------------------------------

SHAPES = [{"CPU": 1}, {"CPU": 2}, {"CPU": 0.5}, {"CPU": 1, "memory": 2},
          {"memory": 4}, {"CPU": 4}]


@pytest.fixture
def tick_knobs(monkeypatch):
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "scheduler_wakeup_debounce_ms", rt.NEVER_MS)
        monkeypatch.setattr(cfg, "event_loop_tick_ms", int(rt.NEVER_MS))


@pytest.mark.parametrize("seed", [3, 4])
def test_lease_burst_with_a_suspect_node_matches_jax(tick_knobs, seed):
    rng = np.random.default_rng(seed)
    node_ids, total_q, avail_q = rt.random_nodes(rng, 12)
    avail_q = total_q.copy()            # every node idle: each could take
    pair = rt.make_pair(node_ids, total_q, avail_q)
    suspect = node_ids[int(rng.integers(1, 12))]
    replies = (rt.Replies(), rt.Replies())
    try:
        for stub in pair:
            nid = type(stub.node_id)
            stub.update_resource_usage({"rows": {}, "full": False,
                                        "removed": [],
                                        "suspect": [nid(suspect)]})
        fields = [rt.spec_fields(rng, SHAPES[int(c)])
                  for c in rng.integers(len(SHAPES), size=90)]
        for lo in range(0, len(fields), 15):
            keys = list(range(lo, lo + 15))
            for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec),
                                       replies):
                stub.request_worker_lease_batch(
                    [make(f) for f in fields[lo:lo + 15]], rep.batch(keys))
        for _ in range(3):
            for stub in pair:
                rt.tick(stub)
            assert replies[0].by_lease == replies[1].by_lease
        replies_port = [r for rs in replies[1].by_lease.values() for r in rs]
        assert ("spill", suspect.hex()) not in replies_port
        assert any(r[0] == "spill" for r in replies_port)
    finally:
        for stub in pair:
            stub.shutdown()


# -- the port's timers (divergences: the reference has neither) -------------

def test_heartbeat_timer_makes_up_a_few_missed_periods_only():
    """The heartbeat check's timer keeps to its grid and makes up at most
    ``HEARTBEAT_CATCH_UP`` runs after a pause: a handler that holds the
    loop for 20 periods costs 20 - 3 runs (a timer that skipped them
    would lose 20, one that made them all up none, and a drifting one
    more than 20)."""
    from ray_tpu_torch._private.event_loop import EventLoop
    from ray_tpu_torch.gcs.server import HEARTBEAT_CATCH_UP
    period = 0.05
    loop = EventLoop("gcs-catch-up")
    runs, busy = [], []

    def hold():
        t = time.monotonic()
        time.sleep(20 * period)
        busy.append(time.monotonic() - t)
    try:
        t0 = time.monotonic()
        loop.schedule_every(period, lambda: runs.append(time.monotonic()),
                            "check", catch_up=HEARTBEAT_CATCH_UP)
        time.sleep(0.5 * period)
        loop.post(hold, "busy")
        time.sleep(40 * period)
        t_end = time.monotonic()
    finally:
        loop.stop()
    grid = int((t_end - t0) / period)
    missed = int(busy[0] / period)
    ran = len([t for t in runs if t <= t_end])
    assert abs(ran - (grid - missed + HEARTBEAT_CATCH_UP)) <= 1, \
        (ran, grid, missed)


def test_resource_round_rearms_after_its_end(monkeypatch):
    """A poll and broadcast longer than the period does not run back to
    back: the next round starts a period after the last one ended."""
    from ray_tpu_torch._private.event_loop import EventLoop
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch.gcs.pubsub import Publisher
    from ray_tpu_torch.gcs.server import GcsResourceManager
    from ray_tpu_torch.scheduler.resources import NodeResources
    monkeypatch.setattr(port_config(),
                        "gcs_resource_broadcast_period_milliseconds", 50)
    spans = []

    class SlowRaylet:
        node_id = NodeID.from_random()
        local_resources = NodeResources({"CPU": 1.0})

        def get_resource_report(self):
            t = time.monotonic()
            time.sleep(0.08)
            spans.append((t, time.monotonic()))
            return {"available": {"CPU": 1.0}, "total": {"CPU": 1.0}}

        def update_resource_usage(self, batch):
            pass
    loop = EventLoop("gcs-round")
    try:
        rm = GcsResourceManager(loop, Publisher())
        raylet = SlowRaylet()
        rm.register_raylet(raylet.node_id, raylet, raylet.local_resources)
        wait_until(lambda: len(spans) >= 4, 10, "four rounds")
    finally:
        loop.stop()
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    assert min(gaps) >= 0.05, gaps


def test_lease_a_tick_puts_back_after_the_kill_is_answered_in_the_port(
        monkeypatch):
    """A raylet killed while its loop is inside a tick: ``kill`` stops
    the loop (giving up after 2 s), answers the queued leases "node
    dead", and the tick, finishing later, puts back the leases it had
    popped.  Those are answered "node dead" at the tick's end (ROADMAP
    C.33); before, they waited for a tick that never came, and the
    submitter's class with them."""
    from ray_tpu_torch._private import ids, task_spec
    from ray_tpu_torch._private.cluster import Cluster
    from ray_tpu_torch.scheduler import torch_backend
    entered, release = threading.Event(), threading.Event()

    def stuck_solve(self, view, specs):
        entered.set()
        assert release.wait(30), "the test never released the tick"
        return [None] * len(specs)
    monkeypatch.setattr(torch_backend.DeviceRuntimeSolver, "solve",
                        stuck_solve)
    cluster = Cluster(device="cpu")
    try:
        raylet = cluster.add_node({"CPU": 1.0}, node_name="victim")
        replies = []
        owner = ids.WorkerID.from_random()
        for _ in range(2):
            spec = task_spec.make_spec(
                job_id=ids.JobID.from_int(1), owner_id=owner,
                function_id=ids.FunctionID.from_random(),
                function_name="noop", args=[], num_returns=1,
                resources={"CPU": 1.0})
            raylet.request_worker_lease(spec, replies.append)
        assert entered.wait(10), "no batched tick started"
        cluster.kill_node(raylet)
        release.set()
        wait_until(lambda: len(replies) == 2, 10, "both replies")
    finally:
        release.set()
        cluster.shutdown()
    assert replies == [{"rejected": True, "reason": "node dead"}] * 2


def _seven():
    return 7


def test_a_task_submitted_on_a_killed_nodes_thread_runs_in_the_port():
    """A worker thread of a killed node (finishing its task, or failing
    its queued ones) submits or re-leases a task: its local raylet is
    dead, so the lease is rejected "node dead" and bounces.  The bounce's
    retry is scheduled on a live raylet's loop, and the task runs on the
    head (ROADMAP C.33); before, it was scheduled on the dead raylet's
    stopped loop, and the task was lost."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch._private.worker import global_worker
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        cluster = global_worker().cluster
        victim = cluster.add_node({"CPU": 1.0}, node_name="victim")
        cluster.kill_node(victim)
        seven = ray_tpu_torch.remote(_seven)
        refs = []

        def on_the_dead_node():
            worker_context.set_context(
                worker_context.ExecutionContext(node=victim))
            refs.append(seven.remote())
        thread = threading.Thread(target=on_the_dead_node)
        thread.start()
        thread.join(10)
        assert not thread.is_alive() and len(refs) == 1
        assert ray_tpu_torch.get(refs[0], timeout=20) == 7
    finally:
        ray_tpu_torch.shutdown()


def test_a_beat_sent_before_the_kill_is_no_sign_of_life_in_the_port(
        monkeypatch):
    """A beat the victim sent just before its kill lands half a timeout
    after it: the death still comes within ``(timeout + 2) x period`` of
    the kill, H1's bound (ROADMAP C.33).  Before the beats were stamped,
    the late beat reset the count when it landed, and the death came a
    whole timeout after that."""
    from ray_tpu_torch._private.cluster import Cluster
    from ray_tpu_torch.gcs.pubsub import NODE_CHANNEL
    cfg = port_config()
    period, timeout = 0.1, 10
    monkeypatch.setattr(cfg, "raylet_heartbeat_period_milliseconds",
                        int(period * 1e3))
    monkeypatch.setattr(cfg, "num_heartbeats_timeout", timeout)
    monkeypatch.setattr(cfg, "num_heartbeats_suspect", 5)
    cluster = Cluster(device="cpu")
    held, release = threading.Event(), threading.Event()
    try:
        cluster.add_node({"CPU": 1.0}, node_name="head")
        victim = cluster.add_node({"CPU": 1.0}, node_name="victim")
        key = victim.node_id.binary()
        dead_at = []
        cluster.gcs.publisher.subscribe(
            NODE_CHANNEL, None, lambda k, msg: dead_at.append(
                time.monotonic()) if k == key and msg["state"] == "DEAD"
            else None)
        manager = cluster.gcs.heartbeat_manager
        land = manager.heartbeat

        def late(node_id, *args, **kwargs):
            if node_id == victim.node_id and not held.is_set():
                held.set()
                assert release.wait(30), "the test never released the beat"
            return land(node_id, *args, **kwargs)
        manager.heartbeat = late
        assert held.wait(5), "the victim sent no beat"
        killed = time.monotonic()
        cluster.kill_node(victim)
        time.sleep(timeout * period / 2)
        release.set()
        wait_until(lambda: dead_at, 10, "the victim's death")
    finally:
        release.set()
        cluster.shutdown()
    assert dead_at[0] - killed <= (timeout + 2) * period, dead_at[0] - killed


def test_a_check_after_lost_checks_reads_the_clock_in_the_port(
        quiet_gcs_timers):
    """ROADMAP C.33: checks the grid lost (a loop held past its catch-up)
    do not delay a death.  A node whose last stamped beat is a timeout of
    periods old is dead at the next check that counted all but
    ``HEARTBEAT_LOST_CHECKS`` of the timeout's checks; a node as silent
    by count but not by the clock is not."""
    from ray_tpu_torch._private.event_loop import EventLoop
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch.gcs.server import (HEARTBEAT_LOST_CHECKS,
                                          GcsHeartbeatManager)
    loop = EventLoop("gcs-lost-checks")
    dead = []
    node = NodeID(b"\x09" * NodeID.SIZE)
    try:
        hb = GcsHeartbeatManager(loop, dead.append)
        hb._period_s = 0.05              # the clock's period; no timer runs
        silent_s = port_config().num_heartbeats_timeout * hb._period_s
        hb.register(node)
        sent = time.monotonic()
        hb.heartbeat(node, sent)
        counted = port_config().num_heartbeats_timeout - HEARTBEAT_LOST_CHECKS
        for _ in range(counted - 1):
            run_on(loop, hb._tick)
        assert time.monotonic() - sent < silent_s and not dead
        time.sleep(max(0.0, sent + silent_s - time.monotonic()))
        run_on(loop, hb._tick)
    finally:
        loop.stop()
    assert dead == [node]


def test_a_late_beat_does_not_restart_the_count_in_the_port(
        quiet_gcs_timers):
    """ROADMAP C.34: the same beats to both managers, one of them sent
    after the second check and delivered after the fifth.  The reference
    resets the count when it arrives (the node recovers, and dies six
    checks after the delivery); the port counts the three checks since
    it was sent (the node stays SUSPECT and dies three checks later)."""
    def case(pkg):
        ids = mod(pkg, "_private.ids")
        loop = mod(pkg, "_private.event_loop").EventLoop(f"gcs-late-{pkg}")
        events = []
        node = ids.NodeID(b"\x07" * ids.NodeID.SIZE)
        stamped = pkg == "ray_tpu_torch"

        def beat(sent_at):
            return hb.heartbeat(node, sent_at) if stamped \
                else hb.heartbeat(node)
        try:
            hb = mod(pkg, "gcs.server").GcsHeartbeatManager(
                loop, lambda n: events.append("dead"),
                on_node_suspect=lambda n: events.append("suspect"),
                on_node_recovered=lambda n: events.append("recovered"))
            hb.register(node)
            beat(time.monotonic())
            for _ in range(2):
                run_on(loop, hb._tick)
            sent_at = time.monotonic()
            for _ in range(3):
                run_on(loop, hb._tick)
            events.append(("landed", beat(sent_at)))
            after = 0
            while "dead" not in events:
                run_on(loop, hb._tick)
                after += 1
            return events, after
        finally:
            loop.stop()
    jax, port = both_packages(case)
    assert jax == (["suspect", "recovered", ("landed", True), "suspect",
                    "dead"], 6)
    assert port == (["suspect", ("landed", True), "dead"], 3)


class _StoppedWorker:
    """A leased worker its node's kill stopped: it finished its task and
    is idle, and records what is pushed to it."""
    state = "DEAD"
    node_id = worker_id = None

    def __init__(self):
        self.pushed = []

    def push_task(self, spec, on_done):
        self.pushed.append(spec.name)


class _LeaseHolder:
    def __init__(self):
        self.returned = []

    def return_worker(self, worker, disconnect=False):
        self.returned.append(disconnect)


def test_a_stopped_workers_lease_takes_no_task_in_the_port():
    """ROADMAP C.36: a worker stopped by its node's kill finishes its task
    and goes idle with the class's next task queued.  The reference's
    submitter pushes that task to it (where it would wait unanswered);
    the port's gives the lease back, keeps the task at the head of its
    queue and leases anew, so the task spends no retry.  Before, the
    task failed unrun with ``WorkerCrashedError``, spending a retry,
    and a task that four stopped workers took in turn failed H1."""
    from types import SimpleNamespace

    def case(pkg):
        sub = mod(pkg, "_private.direct_task_submitter").DirectTaskSubmitter(
            SimpleNamespace(cluster=None, local_raylet=None))
        pumped = []
        sub._pump = pumped.append
        key = 7
        for name in ("next", "after"):
            sub._keys[key].queue.append(SimpleNamespace(
                name=name, task_id=None, scheduling_class=key))
        worker, holder = _StoppedWorker(), _LeaseHolder()
        sub._on_worker_idle(worker, holder, key)
        return (worker.pushed, holder.returned,
                [s.name for s in sub._keys[key].queue], pumped)
    jax, port = both_packages(case)
    assert jax == (["next"], [], ["after"], [])
    assert port == ([], [True], ["next", "after"], [7])


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_heartbeat")
