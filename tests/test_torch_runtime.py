"""The port's raylet scheduling plane (``ray_tpu_torch._private``) against
the JAX package's, on the CPU.

The port's ``ClusterTaskManager`` and the reference's run on stub
raylets over views of the same nodes (ids as bytes), and see the same
lease requests in the same order, tick by tick
(``tests/torch_runtime_util.py``).  Every lease must get the same reply
from both (grant, spillback to the same node, backlog, infeasible), and
the tick counters, the pending load and the rendered scheduler series
must be equal.  The port's raylets also run for real in a ``Cluster``
with ``device="cpu"``.  Tests marked ``gpu`` run the tick on the card and
skip without one.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_runtime_util as rt
from ray_tpu._private.config import get_config as jax_config
from ray_tpu.scheduler import jax_backend as jb
from ray_tpu_torch._private import cluster_task_manager as tctm
from ray_tpu_torch._private import raylet as traylet
from ray_tpu_torch._private.cluster import Cluster
from ray_tpu_torch._private.config import get_config as port_config
from ray_tpu_torch._private.event_loop import EventLoop
from ray_tpu_torch._private.metrics_agent import get_metrics_registry
from ray_tpu_torch.autoscaler import resource_demand_scheduler as trds
from ray_tpu_torch.ops import class_fill as cf
from ray_tpu_torch.scheduler import torch_backend as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Twelve classes: nine hybrid shapes, a GPU class, one no node's totals
# fit, and a hard affinity to the sixth node.
SHAPES = [{"CPU": 0.5}, {"CPU": 1}, {"CPU": 2}, {"CPU": 4},
          {"CPU": 1, "memory": 2}, {"CPU": 2, "memory": 8},
          {"CPU": 1, "custom_a": 1}, {"CPU": 0.5, "memory": 1},
          {"memory": 4}, {"CPU": 1, "GPU": 1}, {"CPU": 64}, {"CPU": 1}]
AFFINITY_CLASS, AFFINITY_NODE = 11, 5


@pytest.fixture
def tick_knobs(monkeypatch):
    """Both packages' ticks run only when a test posts one."""
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "scheduler_wakeup_debounce_ms", rt.NEVER_MS)
        monkeypatch.setattr(cfg, "event_loop_tick_ms", int(rt.NEVER_MS))


@pytest.fixture
def stubs():
    made = []

    def make(*args, **kw):
        pair = rt.make_pair(*args, **kw)
        made.extend(pair)
        return pair
    yield make
    for stub in made:
        stub.shutdown()


def _fields(rng, node_ids, cls):
    strategy = None
    if cls == AFFINITY_CLASS:
        strategy = {"scheduling_type": "node_affinity",
                    "node_affinity_node_id": node_ids[AFFINITY_NODE],
                    "node_affinity_soft": False}
    return rt.spec_fields(rng, SHAPES[cls], strategy)


def _submit_round(rng, pair, replies, node_ids, rnd, n=120):
    """``n`` leases of random classes: runs of 1 go as single leases,
    longer runs as batches; both stubs get the same calls in the same
    order."""
    classes = rng.choice(len(SHAPES), size=n)
    fields = [_fields(rng, node_ids, int(c)) for c in classes]
    i = 0
    while i < n:
        size = int(rng.choice([1, 1, 4, 10, 25]))
        keys = [(rnd, j) for j in range(i, min(i + size, n))]
        chunk = fields[i:i + len(keys)]
        for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec),
                                   replies):
            specs = [make(f) for f in chunk]
            if len(specs) == 1:
                stub.request_worker_lease(specs[0], rep.single(keys[0]))
            else:
                stub.request_worker_lease_batch(specs, rep.batch(keys))
        i += len(keys)


def _broadcast_delta(rng, pair, node_ids, total_q):
    """The same delta broadcast to both: three remote rows get a new
    availability."""
    rows = rng.choice(np.arange(1, len(node_ids)), size=3, replace=False)
    usage = {}
    for r in rows:
        avail = np.floor(total_q[r] * rng.uniform(0, 1) / 5000) * 5000
        usage[node_ids[r]] = {
            "available": {c: v / 1e4 for c, v in zip(rt.COLUMNS, avail)},
            "total": {c: v / 1e4 for c, v in zip(rt.COLUMNS, total_q[r])
                      if v > 0}}
    for stub in pair:
        nid = type(stub.node_id)
        stub.update_resource_usage(
            {"rows": {nid(k): v for k, v in usage.items()}, "full": False})


def _return_half(pair, replies, returned):
    """Return the first half (by lease key) of the granted workers not
    yet returned, on both stubs."""
    keys = sorted(k for k in replies[1].workers if k not in returned)
    assert keys == sorted(k for k in replies[0].workers
                          if k not in returned)
    for key in keys[:len(keys) // 2]:
        for stub, rep in zip(pair, replies):
            stub.return_worker(rep.workers[key])
        returned.add(key)
    for stub in pair:
        rt.settle(stub.loop)


def _tick_both(pair, replies):
    for stub in pair:
        rt.tick(stub)
    assert replies[0].by_lease == replies[1].by_lease


# tick_stats keys only the port has (its divergences), each 0 while the
# reference's behaviour is what is compared.
PORT_ONLY_TICK_STATS = ("device_errors", "spillback_rejections")


def _assert_same_state(pair):
    jstub, tstub = pair
    jm, tm = jstub.cluster_task_manager, tstub.cluster_task_manager
    port_stats = dict(tm.tick_stats)
    for key in PORT_ONLY_TICK_STATS:
        assert port_stats.pop(key) == 0
    assert port_stats == jm.tick_stats
    assert tm.resource_load() == jm.resource_load()
    assert tm.num_queued() == jm.num_queued()
    label = jm._node_label
    assert tm._node_label == label
    want, got = rt.jax_series(label), rt.port_series(label)
    for key in PORT_ONLY_TICK_STATS:
        extra = {k for k in got if k[0] == f"ray_tpu_scheduler_tick_{key}"}
        assert len(extra) == 1 and got.pop(extra.pop()) == 0.0
    assert got == want
    return want


def _run_parity(rng, make_stubs, rounds=5, n_nodes=40, labels=None,
                local=(32, 64, 4, 4)):
    node_ids, total_q, avail_q = rt.random_nodes(rng, n_nodes)
    # The local node idle at the start (large by default): grants and
    # returned workers move its row from tick to tick.
    total_q[0] = avail_q[0] = np.array(local) * 10_000
    pair = make_stubs(node_ids, total_q, avail_q, labels)
    replies = (rt.Replies(), rt.Replies())
    returned = set()
    for rnd in range(rounds):
        _submit_round(rng, pair, replies, node_ids, rnd)
        _tick_both(pair, replies)
        _return_half(pair, replies, returned)
        _broadcast_delta(rng, pair, node_ids, total_q)
    _tick_both(pair, replies)
    return pair, replies, _assert_same_state(pair)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_task_manager_matches_jax(seed, tick_knobs, stubs):
    pair, replies, series = _run_parity(np.random.default_rng(seed), stubs)
    kinds = {r[0] for rs in replies[1].by_lease.values() for r in rs}
    assert {"grant", "spill", "infeasible"} <= kinds
    jsolver = pair[0].cluster_task_manager._jax_solver
    tsolver = pair[1].cluster_task_manager._solver
    assert tsolver.stats == jsolver.stats
    assert tsolver.stats["ticks"] >= 5 and tsolver.stats["fallbacks"] == 0
    assert pair[1].cluster_task_manager.tick_stats["jnp_fallbacks"] == 0
    # C.3: the solver's series ride the same registry, by node.
    names = {name for name, _ in series}
    assert {"ray_tpu_scheduler_full_syncs", "ray_tpu_scheduler_sharded_ticks",
            "ray_tpu_scheduler_interned_classes",
            "ray_tpu_scheduler_tick_spillbacks",
            "ray_tpu_scheduler_lease_batch_entries",
            "ray_tpu_scheduler_pending_queue_depth",
            "ray_tpu_scheduler_tick_latency_count"} <= names


def test_cost_aware_spillbacks_match_jax(tick_knobs, stubs):
    """Throughput labels make the heterogeneity cost live: the slow local
    node's locally runnable tasks move to faster nodes
    (``locality_override``), judged after this tick's local grants, which
    fill the small local node."""
    rng = np.random.default_rng(3)
    rates = [{"ray_tpu.throughput": "1.0"}] + [
        {"ray_tpu.throughput": str(r)} for r in rng.choice([1.0, 4.0], 7)]
    pair, replies, _ = _run_parity(rng, stubs, rounds=3, n_nodes=8,
                                   labels=rates, local=(8, 16, 0, 0))
    ts = pair[1].cluster_task_manager.tick_stats
    assert ts["spillbacks_locality_override"] > 0
    assert ts["spillbacks_no_capacity"] > 0
    assert pair[1].cluster_task_manager._solver.stats["cost_ticks"] > 0


def test_greedy_fallback_under_class_row_cap_matches_jax(
        monkeypatch, tick_knobs, stubs):
    """Past the class-row cap the device solve returns None: the work is
    requeued and the same tick goes greedy, in both packages."""
    monkeypatch.setattr(jb.DeviceRuntimeSolver, "_MAX_CLASS_ROWS", 4)
    monkeypatch.setattr(tb.DeviceRuntimeSolver, "_MAX_CLASS_ROWS", 4)
    pair, replies, _ = _run_parity(np.random.default_rng(5), stubs,
                                   rounds=2)
    tm = pair[1].cluster_task_manager
    assert tm.tick_stats["jnp_fallbacks"] >= 2
    assert tm._solver.stats["fallbacks"] >= 2
    assert any(r[0] == "grant" for rs in replies[1].by_lease.values()
               for r in rs)


def test_native_backend_matches_jax(monkeypatch, tick_knobs, stubs):
    monkeypatch.setattr(jax_config(), "scheduler_backend", "native")
    monkeypatch.setattr(port_config(), "scheduler_backend", "native")
    pair, replies, _ = _run_parity(np.random.default_rng(6), stubs,
                                   rounds=2)
    assert pair[1].cluster_task_manager._solver is None
    assert pair[0].cluster_task_manager._jax_solver is None
    kinds = {r[0] for rs in replies[1].by_lease.values() for r in rs}
    assert {"grant", "spill"} <= kinds


def _two_node_pair(make_stubs, rng, cpus=(2.0, 4.0)):
    # Fresh ids: a node label shared with a dead manager would lose its
    # series when the registry prunes the dead one's.
    ids = [rng.bytes(16) for _ in cpus]
    total = np.array([[c, 8.0, 0.0, 0.0] for c in cpus]) * 1e4
    return ids, make_stubs(ids, total.astype(np.int64),
                           total.astype(np.int64))


def test_batch_leftovers_swept_into_backlog(tick_knobs, stubs):
    rng = np.random.default_rng(7)
    _, pair = _two_node_pair(stubs, rng)
    replies = (rt.Replies(), rt.Replies())
    fields = [rt.spec_fields(rng, {"CPU": 1}) for _ in range(10)]
    keys = list(range(10))
    for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec), replies):
        stub.request_worker_lease_batch([make(f) for f in fields],
                                        rep.batch(keys))
    _tick_both(pair, replies)
    got = [replies[1].by_lease[k][0][0] for k in keys]
    assert got.count("grant") == 2 and got.count("spill") == 4
    assert got.count("backlog") == 4
    assert pair[1].cluster_task_manager.num_queued() == 0
    _assert_same_state(pair)


def test_infeasible_lease_parked_and_retried_on_cluster_change(
        tick_knobs, stubs):
    rng = np.random.default_rng(8)
    _, pair = _two_node_pair(stubs, rng)
    replies = (rt.Replies(), rt.Replies())
    fields = [rt.spec_fields(rng, {"CPU": 16}) for _ in range(2)]
    for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec), replies):
        for i, f in enumerate(fields):
            stub.request_worker_lease(make(f), rep.single(i))
    _tick_both(pair, replies)
    assert replies[1].by_lease == {}
    assert pair[1].cluster_task_manager.debug_state()["infeasible"]
    assert pair[1].cluster_task_manager.resource_load() == [{"CPU": 16.0}] * 2
    big = rng.bytes(16)
    for stub in pair:
        nid = type(stub.node_id)
        stub.update_resource_usage({"rows": {nid(big): {
            "available": {"CPU": 32.0}, "total": {"CPU": 32.0}}},
            "full": False})
    _tick_both(pair, replies)
    assert replies[1].by_lease == {0: [("spill", big.hex())],
                                   1: [("spill", big.hex())]}
    _assert_same_state(pair)


def test_device_error_requeues_and_raises_without_greedy(
        monkeypatch, tick_knobs, stubs):
    """ROADMAP C.2: a raising solve puts the popped work back, counts
    device_errors and surfaces on the loop; that tick places nothing."""
    rng = np.random.default_rng(9)
    _, (_, stub) = _two_node_pair(stubs, rng)
    replies = rt.Replies()
    for i in range(3):
        stub.request_worker_lease(rt.port_spec(rt.spec_fields(
            rng, {"CPU": 1})), replies.single(i))
    stub.request_worker_lease_batch(
        [rt.port_spec(rt.spec_fields(rng, {"CPU": 1})) for _ in range(2)],
        replies.batch([3, 4]))
    real_solve = tb.DeviceRuntimeSolver.solve

    def lost(self, view, specs):
        raise RuntimeError("device lost")
    monkeypatch.setattr(tb.DeviceRuntimeSolver, "solve", lost)
    before = stub.cluster_view.snapshot()[2].copy()
    rt.tick(stub)
    mgr = stub.cluster_task_manager
    assert mgr.tick_stats["device_errors"] == 1
    assert mgr.tick_stats["jnp_fallbacks"] == 0
    assert stub.loop.handler_stats["cluster.schedule"]["errors"] == 1
    # The singles are queued again; the batch's entries came back as
    # backlog (the submitter resends them); nothing was placed.
    assert mgr.num_queued() == 3
    assert replies.by_lease == {3: [("backlog",)], 4: [("backlog",)]}
    np.testing.assert_array_equal(stub.cluster_view.snapshot()[2], before)
    monkeypatch.setattr(tb.DeviceRuntimeSolver, "solve", real_solve)
    rt.tick(stub)
    assert mgr.num_queued() == 0
    placed = [replies.by_lease[k] for k in range(3)]
    assert all(len(r) == 1 and r[0][0] in ("grant", "spill") for r in placed)
    assert mgr.tick_stats["device_errors"] == 1


def _ping_pong_raylets(rng):
    """Two raylets of each package, on a 4-CPU node A and a 64-CPU node B,
    each viewing the cluster with its own row first and the other's at
    index 81 of 82 (the 80 rows between have nothing free).  Two leases of
    another class go first on each, so that the class under test is the
    second demand row of every solver, whose fill order is rotated to
    start at node index 81: each solve ranks the other node first.
    Returns ({A, B: (JAX stub, port stub)}, A, B)."""
    a, b, *fill = [rng.bytes(16) for _ in range(82)]
    shapes = {a: [4, 16, 0, 0], b: [64, 256, 0, 0]}
    raylets = {}
    for own, other in ((a, b), (b, a)):
        order = [own] + fill + [other]
        total = np.array([shapes.get(n, [4, 16, 0, 0]) for n in order]) * 1e4
        avail = np.array([shapes.get(n, [0, 0, 0, 0]) for n in order]) * 1e4
        raylets[own] = rt.make_pair(order, total.astype(np.int64),
                                    avail.astype(np.int64))
    for pair in raylets.values():
        replies = (rt.Replies(), rt.Replies())
        warm = [rt.spec_fields(rng, {"CPU": 1}) for _ in range(2)]
        for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec),
                                   replies):
            stub.request_worker_lease_batch([make(f) for f in warm],
                                            rep.batch([0, 1]))
        _tick_both(pair, replies)
        assert replies[1].by_lease == {0: [("grant",)], 1: [("grant",)]}
        for stub, rep in zip(pair, replies):
            for worker in rep.workers.values():
                stub.return_worker(worker)
            rt.settle(stub.loop)
    return raylets, a, b


def test_spillback_ping_pong_matches_jax(tick_knobs):
    """The livelock of a burst across raylets, pinned on two nodes: 7
    leases of [0.5 CPU, 2 memory] re-leased at once at each raylet a
    spillback names, as the reference submitter does, are spilled from A
    to B and back for as long as neither view changes, both nodes idle.
    The JAX package does the same, lease for lease."""
    rng = np.random.default_rng(12)
    raylets, a, b = _ping_pong_raylets(rng)
    try:
        fields = [rt.spec_fields(rng, {"CPU": 0.5, "memory": 2})
                  for _ in range(7)]
        specs = [[make(f) for f in fields]
                 for make in (rt.jax_spec, rt.port_spec)]
        replies = (rt.Replies(), rt.Replies())
        at, other = a, b
        for rnd in range(6):
            for stub, pkg_specs, rep in zip(raylets[at], specs, replies):
                for k, spec in enumerate(pkg_specs):
                    stub.request_worker_lease(spec, rep.single((rnd, k)))
            _tick_both(raylets[at], replies)
            assert [replies[1].by_lease[(rnd, k)] for k in range(7)] == \
                [[("spill", other.hex())]] * 7
            at, other = other, at
        for pair in raylets.values():
            assert all(r.cluster_task_manager.num_queued() == 0
                       for r in pair)
            _assert_same_state(pair)
    finally:
        for pair in raylets.values():
            for stub in pair:
                stub.shutdown()


def test_grant_or_reject_ends_the_ping_pong(tick_knobs):
    """The port's divergence: the same 7 leases re-sent to B with
    ``grant_or_reject`` are granted there; re-sent so to a node that
    cannot run them now, they are rejected, not spilled again."""
    rng = np.random.default_rng(13)
    raylets, a, b = _ping_pong_raylets(rng)
    try:
        port_a, port_b = raylets[a][1], raylets[b][1]
        specs = [rt.port_spec(rt.spec_fields(rng, {"CPU": 0.5, "memory": 2}))
                 for _ in range(7)]
        replies = rt.Replies()
        for k, spec in enumerate(specs):
            port_a.request_worker_lease(spec, replies.single(("a", k)))
        rt.tick(port_a)
        assert all(replies.by_lease[("a", k)] == [("spill", b.hex())]
                   for k in range(7))
        for k, spec in enumerate(specs):
            port_b.request_worker_lease(spec, replies.single(("b", k)),
                                        grant_or_reject=True)
        assert port_b.cluster_task_manager.num_queued() == 7
        rt.tick(port_b)
        assert all(replies.by_lease[("b", k)] == [("grant",)]
                   for k in range(7))
        mgr = port_b.cluster_task_manager
        assert mgr.num_queued() == 0
        assert mgr.tick_stats["spillbacks"] == 0
        assert mgr.tick_stats["spillback_rejections"] == 0
        # A holds 4 CPUs: 8 such leases fit, the ninth is rejected.
        more = [rt.port_spec(rt.spec_fields(rng, {"CPU": 0.5, "memory": 2}))
                for _ in range(9)]
        for k, spec in enumerate(more):
            port_a.request_worker_lease(spec, replies.single(("r", k)),
                                        grant_or_reject=True)
        rt.tick(port_a)
        got = [replies.by_lease[("r", k)][0] for k in range(9)]
        assert got == [("grant",)] * 8 + [("rejected",)]
        ts = port_a.cluster_task_manager.tick_stats
        assert ts["spillback_rejections"] == 1
        assert ts["spillbacks"] == 7 and ts["busy_ticks"] == 3
        assert port_a.cluster_task_manager.num_queued() == 0
    finally:
        for pair in raylets.values():
            for stub in pair:
                stub.shutdown()


def test_event_loop_counts_handler_errors():
    loop = EventLoop("errloop-test")
    try:
        ran = threading.Event()

        def boom():
            raise ValueError("boom")
        loop.post(boom, "boom")
        loop.post(ran.set, "after")
        assert ran.wait(10)
        rt.settle(loop)
        assert loop.handler_stats["boom"] == {
            "count": 1, "total_s": loop.handler_stats["boom"]["total_s"],
            "max_s": loop.handler_stats["boom"]["max_s"], "errors": 1}
        assert loop.handler_stats["after"]["errors"] == 0
        text = get_metrics_registry().render_prometheus()
        labels = '{handler="boom",loop="errloop-test"}'
        assert f"ray_tpu_event_loop_handler_errors{labels} 1" in text
        assert f"ray_tpu_event_loop_handler_count{labels} 1" in text
    finally:
        loop.stop()


def test_event_loop_timers_run_in_order():
    loop = EventLoop("timerloop-test")
    try:
        seen, done, ticked = [], threading.Event(), threading.Event()

        def tick():
            seen.append("tick")
            if seen.count("tick") == 3:
                ticked.set()
        loop.schedule_after(0.05, lambda: seen.append("late"), "late")
        loop.schedule_after(0.0, lambda: seen.append("soon"), "soon")
        loop.schedule_every(0.01, tick, "tick")
        loop.schedule_after(0.08, lambda: (seen.append("done"), done.set()),
                            "done")
        assert done.wait(10) and ticked.wait(10)
        assert seen[0] == "soon"
        assert seen.index("late") < seen.index("done")
    finally:
        loop.stop()


def test_actor_lifetime_resources_handed_back(tick_knobs, stubs):
    """An actor placed with CPU 1 that holds nothing for life hands the
    CPU back at dispatch, in both packages."""
    rng = np.random.default_rng(10)
    _, pair = _two_node_pair(stubs, rng)
    fields = dict(rt.spec_fields(rng, {"CPU": 1, "memory": 2}),
                  task_type="ACTOR_CREATION_TASK",
                  lifetime_resources={"memory": 2})
    replies = (rt.Replies(), rt.Replies())
    for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec), replies):
        spec = make(fields)
        assert stub.cluster_view.subtract(stub.node_id, spec.resources)
        stub.local_task_manager.queue_and_schedule(spec, rep.single(0))
        rt.settle(stub.loop)
        local = stub.cluster_view.node_resources(stub.node_id)
        assert local.to_float_dict() == {"CPU": 2.0, "memory": 6.0}
        worker = rep.workers[0]
        assert stub.local_task_manager.allocated_for(
            worker.worker_id).to_dict() == {"memory": 2.0}
        stub.return_worker(worker)
        rt.settle(stub.loop)
        assert local.to_float_dict() == {"CPU": 2.0, "memory": 8.0}
    assert replies[0].by_lease == replies[1].by_lease == {0: [("grant",)]}


def test_object_ref_argument_waits_in_the_owners_memory_store(
        tick_knobs, stubs):
    """Two leases whose task passes an object by reference, through
    each package's raylet: one argument already sealed in its owner's
    memory store dispatches on the first tick; the other, sealed only
    after its lease arrived, waits in ``get_async`` and dispatches when
    the owner seals it.  Each stub's object manager is the memory-store
    half of both packages' (``is_local_or_inline``, ``pull_async``)."""
    import types

    from ray_tpu._private import object_store as jstore
    from ray_tpu._private import serialization as jser
    from ray_tpu_torch._private import object_store as tstore
    from ray_tpu_torch._private import serialization as tser
    rng = np.random.default_rng(11)
    _, pair = _two_node_pair(stubs, rng, cpus=(4.0, 2.0))
    oids = [rng.bytes(24), rng.bytes(24)]
    fields = [dict(rt.spec_fields(rng, {"CPU": 1}),
                   args=[{"is_inline": False, "object_id": oid}])
              for oid in oids]
    replies = (rt.Replies(), rt.Replies())
    for stub, make, rep, store_mod, ser, idtype in zip(
            pair, (rt.jax_spec, rt.port_spec), replies,
            (jstore, tstore), (jser, tser),
            (rt.jids.ObjectID, rt.tids.ObjectID)):
        store = store_mod.MemoryStore()
        stub.core_worker = types.SimpleNamespace(memory_store=store)
        stub.object_manager = types.SimpleNamespace(
            is_local_or_inline=store.contains,
            pull_async=lambda oid, cb, store=store: store.get_async(
                oid, lambda _e: cb(True)))
        store.put(idtype(oids[0]), ser.serialize("sealed before"))
        specs = [make(f) for f in fields]
        for key, spec in enumerate(specs):
            stub.request_worker_lease(spec, rep.single(key))
        rt.tick(stub)
        assert rep.by_lease == {0: [("grant",)]}
        deps = stub.local_task_manager.dependency_manager
        assert deps.num_waiting() == 1
        # Sealed from another thread, as a worker seals a return.
        sealer = threading.Thread(target=store.put, args=(
            idtype(oids[1]), ser.serialize("sealed after")))
        sealer.start()
        sealer.join()
        rt.settle(stub.loop)
        assert deps.num_waiting() == 0
    assert replies[0].by_lease == replies[1].by_lease == \
        {0: [("grant",)], 1: [("grant",)]}
    for stub in pair:
        ts = stub.cluster_task_manager.tick_stats
        assert ts["dispatch_errors"] == 0
        # The reference's loop prints a handler's error; the port's
        # counts it too.
        assert all(h.get("errors", 0) == 0
                   for h in stub.loop.handler_stats.values())


def _view_state(view):
    ids, total, avail, cols = view.snapshot()
    return ([n.hex() for n in ids], total, avail, cols,
            sorted(n.hex() for n in view.masked_nodes()))


def test_update_resource_usage_matches_jax(tick_knobs, stubs):
    """Full, delta, removed and suspect rows, batch after batch."""
    rng = np.random.default_rng(12)
    node_ids, total_q, avail_q = rt.random_nodes(rng, 10)
    pair = stubs(node_ids[:6], total_q[:6], avail_q[:6])

    def usage(i, frac):
        return {"available": {c: float(np.floor(v / 1e4 * frac))
                              for c, v in zip(rt.COLUMNS, total_q[i])},
                "total": {c: v / 1e4 for c, v in zip(rt.COLUMNS, total_q[i])
                          if v > 0}}
    batches = [
        # Full: nodes 6-8 join, node 5 is absent (pruned).
        ("full", {i: usage(i, 0.5) for i in (0, 1, 2, 3, 4, 6, 7, 8)}, (),
         None),
        ("delta", {2: usage(2, 0.25), 9: usage(9, 1.0)}, (), None),
        ("delta", {}, (3,), [0, 7]),
        ("delta", {1: usage(1, 0.0)}, (), []),
    ]
    for kind, rows, removed, suspect in batches:
        for stub in pair:
            nid = type(stub.node_id)
            batch = {"rows": {nid(node_ids[i]): u for i, u in rows.items()},
                     "full": kind == "full",
                     "removed": [nid(node_ids[i]) for i in removed]}
            if suspect is not None:
                batch["suspect"] = [nid(node_ids[i]) for i in suspect]
            stub.update_resource_usage(batch)
        want, got = (_view_state(s.cluster_view) for s in pair)
        assert got[0] == want[0] and got[3] == want[3] and got[4] == want[4]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert len(want[0]) == 8


def test_demand_for_a_new_resource_widens_the_view():
    """ROADMAP C.10: a demand naming a resource the view has no column
    for (a task for a node type the autoscaler has not launched yet)
    adds the column and packs the demand; the reference raises
    ``IndexError`` there, which its tick turns into a greedy pass and
    the port's into a device error."""
    from ray_tpu.scheduler import resources as jres
    from ray_tpu_torch.scheduler import resources as tres
    got = {}
    for name, res in (("ray_tpu", jres), ("ray_tpu_torch", tres)):
        view = res.ClusterResourceView()
        view.add_node(b"n" * 16, res.NodeResources({"CPU": 2}))
        reqs = [res.ResourceRequest({"CPU": 1}),
                res.ResourceRequest({"bigmem": 0.5, "CPU": 0.25})]
        try:
            got[name] = (view.demand_matrix(reqs).tolist(),
                         dict(view.columns))
        except IndexError as e:
            got[name] = ("IndexError", str(e))
    assert got["ray_tpu"][0] == "IndexError"
    mat, columns = got["ray_tpu_torch"]
    assert columns["bigmem"] == len(columns) - 1
    assert mat[1][columns["bigmem"]] == 0.5 and mat[1][columns["CPU"]] == 0.25
    assert mat[0][columns["CPU"]] == 1.0 and sum(mat[0]) == 1.0


def test_raylet_report_and_update_on_a_real_raylet(monkeypatch):
    monkeypatch.setattr(port_config(), "event_loop_tick_ms", 10)
    r = traylet.Raylet(None, {"CPU": 4, "memory": 8}, device="cpu",
                       labels={"zone": "a"})
    try:
        info = r.node_info()
        assert info["resources"] == {"CPU": 4.0, "memory": 8.0}
        assert info["labels"] == {"zone": "a"} and info["alive"]
        assert r.get_resource_report() == {
            "available": {"CPU": 4.0, "memory": 8.0},
            "total": {"CPU": 4.0, "memory": 8.0},
            "load": {"queued": 0, "dispatch": 0}}
        other = rt.tids.NodeID(b"\x07" * 16)
        r.update_resource_usage({"rows": {other: {
            "available": {"CPU": 1.0}, "total": {"CPU": 2.0}}},
            "full": True})
        assert r.cluster_view.num_nodes() == 2
        r.update_resource_usage({"rows": {}, "full": True})
        assert r.cluster_view.node_ids() == [r.node_id]
        assert "Raylet" in r.debug_string()
    finally:
        r.shutdown()
    assert not r.loop._thread.is_alive()
    replies = rt.Replies()
    r.request_worker_lease_batch([None, None], replies.batch([0, 1]))
    assert replies.by_lease == {0: [("rejected",)], 1: [("rejected",)]}


def _drive_burst(cluster, specs, wall_s=30.0):
    """The lessee: submit a batch to the head, re-send every spillback to
    the named raylet with ``grant_or_reject``, resubmit backlog and
    rejections to the head, return each granted worker at once.  Returns
    {task_id: grants}, {node_id: grants} and the rejection count."""
    import queue as queue_mod
    inbox = queue_mod.Queue()

    def submit(raylet, batch):
        raylet.request_worker_lease_batch(
            batch, lambda rep: inbox.put((batch, rep)))

    def follow(raylet, spec):
        raylet.request_worker_lease(
            spec, lambda res: inbox.put(([spec], {"results": [res]})),
            grant_or_reject=True)
    grants, by_node, rejected = {}, {}, 0
    pending = {s.task_id for s in specs}
    submit(cluster.head_node, specs)
    deadline = time.monotonic() + wall_s
    while pending:
        batch, rep = inbox.get(timeout=max(0.1, deadline - time.monotonic()))
        assert time.monotonic() < deadline, f"{len(pending)} leases left"
        for spec, res in zip(batch, rep["results"]):
            if "worker" in res:
                grants[spec.task_id] = grants.get(spec.task_id, 0) + 1
                pending.discard(spec.task_id)
                nid = res["raylet"].node_id
                by_node[nid] = by_node.get(nid, 0) + 1
                res["raylet"].return_worker(res["worker"])
            elif "retry_at" in res:
                follow(cluster.raylet(res["retry_at"]), spec)
            elif res.get("grant_or_reject"):
                rejected += 1
                submit(cluster.head_node, [spec])
            else:
                assert res.get("backlog") and not res.get("infeasible"), res
                submit(cluster.head_node, [spec])
    return grants, by_node, rejected


def test_local_cluster_burst_end_to_end():
    """A burst through four raylets (mirrors the reference's
    ``test_batch_spreads_across_cluster``): every lease granted once,
    spread over at least 3 nodes, the head's device session engaged and
    never falling back."""
    from ray_tpu_torch._private import ids, task_spec
    cluster = Cluster(device="cpu")
    try:
        for _ in range(4):
            cluster.add_node({"CPU": 2})
        assert all(r.cluster_view.num_nodes() == 4
                   for r in cluster.raylets())
        job, owner = ids.JobID.from_int(1), ids.WorkerID.from_random()
        fn = ids.FunctionID.from_random()
        specs = [task_spec.make_spec(job_id=job, owner_id=owner,
                                     function_id=fn, function_name="where",
                                     args=[], num_returns=1,
                                     resources={"CPU": 1})
                 for _ in range(24)]
        grants, by_node, _ = _drive_burst(cluster, specs)
        assert sorted(grants.values()) == [1] * 24
        assert len(by_node) >= 3
        solver = cluster.head_node.cluster_task_manager._solver
        assert solver is not None and solver.stats["ticks"] >= 1
        assert solver.stats["fallbacks"] == 0
        victim = cluster.raylets()[-1]
        cluster.remove_node(victim)
        assert all(r.cluster_view.num_nodes() == 3
                   for r in cluster.raylets())
        assert not victim.loop._thread.is_alive()
    finally:
        cluster.shutdown()
    assert cluster.raylets() == []


def test_r3_burst_on_the_cpu():
    """R3's lessee and cluster (``tools.profile_cluster``) at a small
    count: every feasible lease granted once (checked inside), each
    spillback re-sent with ``grant_or_reject``, so only the head solves
    in batches, and its solver never falls back."""
    from ray_tpu_torch.tools import profile_cluster as pc
    out = pc.cluster_burst(400, "cpu")
    assert out["granted"] + out["infeasible"] == 400
    assert out["spillbacks"] > 0
    assert out["raylets_with_batched_ticks"] == 1
    assert out["solver"]["ticks"] >= 1 and out["solver"]["fallbacks"] == 0


def test_worker_pool_cap_and_prestart(monkeypatch, tick_knobs, stubs):
    monkeypatch.setattr(port_config(), "max_workers_per_node", 3)
    _, (_, stub) = _two_node_pair(stubs, np.random.default_rng(14))
    from ray_tpu_torch._private.worker_pool import WorkerPool
    pool = WorkerPool(stub)
    assert pool.prestart_for_backlog(5, 2) == 2 and pool.num_idle() == 2
    got = [pool.pop_worker() for _ in range(4)]
    assert got[3] is None and pool.num_total() == 3
    pool.push_worker(got[0])
    assert pool.num_idle() == 1 and pool.pop_worker() is got[0]
    got[1].stop()
    assert pool.num_total() == 2
    pool.shutdown()
    assert pool.num_total() == 0


def test_prestart_warms_workers_from_submit_and_dispatch(
        monkeypatch, tick_knobs, stubs):
    """``num_prestart_workers`` with ``prestart_on_submit``: a queued
    burst warms idle slots before the tick, up to the bound; the grants
    then take them."""
    cfg = port_config()
    monkeypatch.setattr(cfg, "num_prestart_workers", 3)
    monkeypatch.setattr(cfg, "prestart_on_submit", True)
    rng = np.random.default_rng(15)
    _, (_, stub) = _two_node_pair(stubs, rng, cpus=(8.0, 2.0))
    replies = rt.Replies()
    stub.request_worker_lease_batch(
        [rt.port_spec(rt.spec_fields(rng, {"CPU": 1})) for _ in range(5)],
        replies.batch(list(range(5))))
    pool = stub.worker_pool
    assert pool.num_idle() == pool.num_total() == 3
    rt.tick(stub)
    grants = [k for k, r in replies.by_lease.items() if r[0][0] == "grant"]
    assert len(grants) >= 3
    assert pool.num_total() == len(grants) and pool.num_idle() == 0


def test_metrics_registry_prunes_a_dead_owners_series():
    import gc

    from ray_tpu_torch._private.metrics_agent import (MetricsRegistry,
                                                      observe_internal)

    class Owner:
        pass
    reg = MetricsRegistry()
    owner = Owner()

    def collect(o):
        reg.register("x.gauge", "gauge")
        reg.set("x.gauge", 3.0, (("node", "a"),))
    reg.register_collector(owner, collect)
    text = reg.render_prometheus()
    assert 'x_gauge{node="a"} 3.0' in text
    del owner
    gc.collect()
    reg.run_collectors()
    assert reg.get_value("x.gauge", (("node", "a"),)) is None
    observe_internal("x.test_latency", 0.002, buckets=(0.001, 0.01), n="1")
    text = get_metrics_registry().render_prometheus()
    assert 'x_test_latency_bucket{n="1",le="0.01"} 1' in text


def test_import_pulls_in_no_jax_and_no_reference_package():
    modules = ["ray_tpu_torch", "ray_tpu_torch._private.cluster",
               "ray_tpu_torch._private.cluster_task_manager",
               "ray_tpu_torch._private.config",
               "ray_tpu_torch._private.convert",
               "ray_tpu_torch._private.core_worker",
               "ray_tpu_torch._private.direct_task_submitter",
               "ray_tpu_torch._private.event_loop",
               "ray_tpu_torch._private.executor",
               "ray_tpu_torch._private.function_manager",
               "ray_tpu_torch._private.ids",
               "ray_tpu_torch._private.local_task_manager",
               "ray_tpu_torch._private.metrics_agent",
               "ray_tpu_torch._private.object_ref",
               "ray_tpu_torch._private.object_store",
               "ray_tpu_torch._private.raylet",
               "ray_tpu_torch._private.reference_counter",
               "ray_tpu_torch._private.serialization",
               "ray_tpu_torch._private.task_manager",
               "ray_tpu_torch._private.task_spec",
               "ray_tpu_torch._private.thread_registry",
               "ray_tpu_torch._private.worker",
               "ray_tpu_torch._private.worker_context",
               "ray_tpu_torch._private.worker_pool",
               "ray_tpu_torch.exceptions",
               "ray_tpu_torch.remote_function",
               "ray_tpu_torch.runtime_context",
               "ray_tpu_torch.autoscaler",
               "ray_tpu_torch.autoscaler.resource_demand_scheduler",
               "ray_tpu_torch.util",
               "ray_tpu_torch.util.scheduling_strategies",
               "ray_tpu_torch.tools.profile_cluster"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "assert not bad, bad\n"
        "import threading\n"
        "assert threading.active_count() == 1, threading.enumerate()\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_raylet_and_autoscaler_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        traylet.Raylet(None, {"CPU": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        trds.ResourceDemandScheduler({}, max_workers=1)
    cluster = Cluster()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            cluster.add_node({"CPU": 1})
    finally:
        cluster.shutdown()
    assert trds.ResourceDemandScheduler(
        {}, max_workers=1, device="cpu").device.type == "cpu"
    r = traylet.Raylet(None, {"CPU": 1}, device="cpu")
    r.shutdown()
    assert r.device.type == "cpu"
    # The greedy backend runs no device solve, so it needs no card.
    monkeypatch.setattr(port_config(), "scheduler_backend", "native")
    r = traylet.Raylet(None, {"CPU": 1})
    r.shutdown()
    assert r.device is None


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tick's kernel runs only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_runtime_tick_on_card_matches_cpu(cuda_device, tick_knobs):
    """R1 at a small size: the card's raylet gives every lease the CPU
    raylet's reply, one class_fill launch per batched tick, no fallback
    and no error."""
    rng = np.random.default_rng(13)
    node_ids, total_q, avail_q = rt.random_nodes(rng, 200)
    pair = [rt.PortStubRaylet(node_ids[0], rt.port_view(
        node_ids, total_q, avail_q), device=dev) for dev in (cuda_device,
                                                          "cpu")]
    try:
        replies = (rt.Replies(), rt.Replies())
        before = cf.class_fill.launches
        for rnd in range(3):
            fields = [rt.spec_fields(rng, SHAPES[int(c)])
                      for c in rng.choice(AFFINITY_CLASS, size=400)]
            for stub, rep in zip(pair, replies):
                for i in range(0, 400, 100):
                    stub.request_worker_lease_batch(
                        [rt.port_spec(f) for f in fields[i:i + 100]],
                        rep.batch([(rnd, j) for j in range(i, i + 100)]))
            for stub in pair:
                rt.tick(stub)
            assert replies[0].by_lease == replies[1].by_lease
        mgr = pair[0].cluster_task_manager
        assert cf.class_fill.launches - before == \
            mgr._solver.stats["ticks"] == 3
        for stub in pair:
            ts = stub.cluster_task_manager.tick_stats
            assert ts["jnp_fallbacks"] == ts["device_errors"] == 0
            assert all(st["errors"] == 0
                       for st in stub.loop.handler_stats.values())
    finally:
        for stub in pair:
            stub.shutdown()
