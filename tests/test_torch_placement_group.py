"""The port's placement groups (``ray_tpu_torch.util.placement_group``,
the GCS-side ``GcsPlacementGroupManager`` on ``LocalCluster`` and the
raylet's bundle two-phase commit) against the JAX package's, on the CPU.

Each end-to-end case runs once on a JAX ``Cluster`` under
``ray_tpu.init(_cluster=...)`` and once on a ``LocalCluster(device="cpu")``
under ``ray_tpu_torch.init(_cluster=...)``, each with a fresh
``temp_dir``, on nodes of the same totals and names; the two outcomes
(values with node ids read as node names, or the error's type and
message) must be equal.  The cases are those of
``tests/test_placement_group.py`` but ``test_actor_in_placement_group``
(actors: ROADMAP A.4b.5), a refused prepare rolled back, the device
bundle solve forced on the CPU, and a task submitted at a raylet that
knew the bundle's node before the commit (the late columns; ROADMAP
C.9: the reference never places it).  The two-phase commit also runs on
bare raylets of both packages, ledger by ledger; and a raylet's batched
tick over a view that seven groups widened past 64 columns gives the
JAX package's replies (the port raised there before ``class_fill``
took any ``R_pad``).  The manager's collector renders the bundle
solve's counters.  The last test checks that no thread of the port
outlives ``shutdown``.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
import torch_runtime_util as rt
from ray_tpu._private.config import get_config as jax_config
from ray_tpu_torch._private.config import get_config as port_config
from torch_cluster_util import PORT, both, Env, outcome


# -- tests/test_placement_group.py -------------------------------------------

def case_pack_pg_created(env):
    pg = env.util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ok = pg.wait(5)
    info = env.util.placement_group_table(pg)
    return ok, info["state"], env.bundle_nodes(pg), pg.bundle_count, \
        pg.bundle_specs


def case_strict_spread_needs_distinct_nodes(env):
    pg = env.util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                  strategy="STRICT_SPREAD")
    alone = pg.wait(0.5)
    env.add_node("second", 2)
    return alone, pg.wait(5), sorted(env.bundle_nodes(pg).values())


def case_strict_pack_single_node(env):
    env.add_node("second", 2)
    pg = env.util.placement_group([{"CPU": 2}, {"CPU": 2}],
                                  strategy="STRICT_PACK")
    before = pg.wait(0.5)
    env.add_node("big", 8)
    return before, pg.wait(5), env.bundle_nodes(pg)


def case_task_in_placement_group(env):
    env.add_node("target", 4)
    pg = env.util.placement_group([{"CPU": 3}], strategy="PACK")
    assert pg.wait(5)
    node, group = env.pkg.get(
        env.in_bundle(pg, 0, num_cpus=1).remote(env.name), timeout=10)
    return env.node_of(node), group == pg.id.hex(), env.bundle_nodes(pg)


def case_remove_placement_group_frees_resources(env):
    pg = env.util.placement_group([{"CPU": 3}], strategy="PACK")
    assert pg.wait(5)
    during = env.available_cpu()
    env.util.remove_placement_group(pg)
    time.sleep(0.3)
    return during, env.available_cpu(), \
        env.util.placement_group_table(pg)["state"], \
        sorted(env.pkg.available_resources())


def case_pg_ready_api(env):
    pg = env.util.placement_group([{"CPU": 1}], strategy="PACK")
    return env.pkg.get(pg.ready(), timeout=10)


def case_invalid_bundles(env):
    return [outcome(lambda: env.util.placement_group(b))
            for b in ([], [{"CPU": 0}], [{"CPU": -1}])]


def case_pg_reschedules_on_node_death(env):
    extra = env.add_node("extra", 4, {"big": 1})
    pg = env.util.placement_group([{"CPU": 4}], strategy="PACK")
    assert pg.wait(5)
    first = env.bundle_nodes(pg)
    env.add_node("spare", 4)
    env.cluster.remove_node(extra)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        info = env.util.placement_group_table(pg)
        if info["state"] == "CREATED" and \
                list(env.bundle_nodes(pg).values()) == ["spare"]:
            break
        time.sleep(0.05)
    return first, env.util.placement_group_table(pg)["state"], \
        env.bundle_nodes(pg)


def case_named_group_and_table(env):
    pg = env.util.placement_group([{"CPU": 1}], strategy="SPREAD",
                                  name="named")
    assert pg.wait(5)
    same = env.util.get_placement_group("named") == pg
    missing = outcome(lambda: env.util.get_placement_group("absent"))
    taken = outcome(lambda: env.util.placement_group(
        [{"CPU": 1}], name="named"))
    table = env.util.placement_group_table()
    return same, missing, taken, len(table), \
        table[pg.id.hex()]["name"], env.util.get_current_placement_group()


CASES = {
    "pack_pg_created": (case_pack_pg_created, 4),
    "strict_spread_needs_distinct_nodes": (
        case_strict_spread_needs_distinct_nodes, 2),
    "strict_pack_single_node": (case_strict_pack_single_node, 2),
    "task_in_placement_group": (case_task_in_placement_group, 2),
    "remove_placement_group_frees_resources": (
        case_remove_placement_group_frees_resources, 4),
    "pg_ready_api": (case_pg_ready_api, 4),
    "invalid_bundles": (case_invalid_bundles, 4),
    "pg_reschedules_on_node_death": (case_pg_reschedules_on_node_death, 1),
    "named_group_and_table": (case_named_group_and_table, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_group_case_matches_jax(case):
    fn, head_cpus = CASES[case]
    want, got = both(fn, head_cpus)
    assert want[0] == "value", want
    assert got == want


# -- the two-phase commit ------------------------------------------------------

def case_refused_prepare_rolls_back(env):
    """The GCS view lags the raylets (no broadcast round in the case): a
    bundle the view sees room for is refused at its raylet's prepare,
    the bundles prepared before it are returned, and the group retries
    on the manager's tick until the room is real."""
    ids = importlib.import_module(f"{env.name}._private.ids")
    res = importlib.import_module(f"{env.name}.scheduler.resources")
    second = env.add_node("second", 2)
    blocker = ids.PlacementGroupID(b"\x05" * 16)
    assert second.prepare_bundle_resources(blocker, 0,
                                           res.ResourceRequest({"CPU": 2}))
    pg = env.util.placement_group([{"CPU": 2}, {"CPU": 2}],
                                  strategy="STRICT_SPREAD")
    refused = pg.wait(0.5)
    second.cancel_resource_reserve(blocker, 0)
    # Placed only if every refused attempt returned the head's bundle.
    placed = pg.wait(5)
    nodes = sorted(env.bundle_nodes(pg).values())
    env.util.remove_placement_group(pg)
    time.sleep(0.3)
    return refused, placed, nodes, env.available_cpu()


def test_refused_prepare_rolls_back_matches_jax():
    held_off = {"gcs_resource_broadcast_period_milliseconds": 3_600_000}
    want, got = both(case_refused_prepare_rolls_back, 2, held_off)
    assert want == ("value", (False, True, ["head", "second"], 4.0))
    assert got == want


def _bare_raylets():
    """A raylet of each package, the same totals, outside any driver."""
    from ray_tpu._private.cluster import Cluster
    from ray_tpu_torch._private.cluster import LocalCluster
    jax = Cluster(initialize_head=True, head_node_args=dict(
        num_cpus=4, num_gpus=1, resources={"custom": 2}))
    port = LocalCluster(device="cpu")
    port.add_node(Env._totals(4, {"GPU": 1, "custom": 2}))
    return (jax, jax.head_node), (port, port.head_node)


def _ledger(raylet):
    lr = raylet.local_resources
    return lr.to_float_dict("total"), lr.to_float_dict("available")


def test_two_phase_commit_on_bare_raylets_matches_jax():
    """Prepare, a refused prepare, commit, cancel of a prepared and of a
    committed bundle: the ledgers (with the formatted resources) equal
    step by step, and back to the start at the end."""
    (jc, jr), (tc, tr) = _bare_raylets()
    try:
        steps = {"ray_tpu": [], PORT: []}
        for name, raylet in (("ray_tpu", jr), (PORT, tr)):
            ids = importlib.import_module(f"{name}._private.ids")
            res = importlib.import_module(f"{name}.scheduler.resources")
            pg = ids.PlacementGroupID(b"\x0a" * 16)
            other = ids.PlacementGroupID(b"\x0b" * 16)
            req = res.ResourceRequest
            log = steps[name]
            log.append(_ledger(raylet))
            log.append(raylet.prepare_bundle_resources(
                pg, 0, req({"CPU": 2, "GPU": 1})))
            log.append(raylet.prepare_bundle_resources(
                pg, 0, req({"CPU": 2, "GPU": 1})))   # idempotent
            log.append(raylet.prepare_bundle_resources(
                pg, 1, req({"CPU": 4})))             # refused
            log.append(raylet.prepare_bundle_resources(
                other, 0, req({"CPU": 1, "custom": 2})))
            log.append(_ledger(raylet))
            raylet.commit_bundle_resources(pg, 0, req({"CPU": 2, "GPU": 1}))
            log.append(_ledger(raylet))
            raylet.cancel_resource_reserve(other, 0)   # rolled back
            log.append(_ledger(raylet))
            raylet.cancel_resource_reserve(pg, 0)      # returned
            raylet.cancel_resource_reserve(pg, 1)      # never prepared
            log.append(_ledger(raylet))
        assert steps[PORT] == steps["ray_tpu"]
        assert steps[PORT][-1] == steps[PORT][0]
        total = steps[PORT][6][0]
        assert total[f"CPU_group_0_{'0a' * 16}"] == 2.0
        assert total[f"bundle_group_{'0a' * 16}"] == 1000.0
        # The commit rebuilt the local row of the port's view.
        row = tr.cluster_view.node_resources(tr.node_id)
        assert row.to_float_dict("total") == steps[PORT][-1][0]
    finally:
        jc.shutdown()
        tc.shutdown()


def case_forced_device_bundle_solve(env):
    """``pg_kernel_backend="force"``: every group goes through the device
    bundle solve (the plain PyTorch program in the port, the JAX
    program in the reference), on six nodes, under each strategy."""
    bp = importlib.import_module(f"{env.name}.scheduler.bundle_packing")
    for i, cpus in enumerate((6, 4, 8, 5, 4)):
        env.add_node(f"n{i}", cpus)
    before = dict(bp.kernel_stats)
    out = []
    for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        pg = env.util.placement_group([{"CPU": 1}] * 3 + [{"CPU": 2}],
                                      strategy=strategy)
        assert pg.wait(10), strategy
        out.append((strategy, env.bundle_nodes(pg)))
        env.broadcast()    # the GCS view takes the reservations
    delta = {k: bp.kernel_stats[k] - before.get(k, 0)
             for k in bp.kernel_stats}
    return out, delta


def test_forced_device_bundle_solve_matches_jax():
    want, got = both(case_forced_device_bundle_solve, 4,
                      {"pg_kernel_backend": "force"})
    assert want[0] == "value" and want[1][1]["kernel_placements"] == 4
    assert got == want


def case_late_columns(env):
    """The head raylet knows the target node before the group commits
    there; a task for the bundle is submitted at the head right after
    ``wait``.  The port's head takes the bundle's columns from the next
    broadcast (ROADMAP C.9) and spills the task to the target; the
    reference's head only updates availability of a node it knows, so
    the task never becomes feasible there."""
    target = env.add_node("target", 4)
    env.broadcast()       # the head knows the target
    head = env.cluster.head_node
    assert head.cluster_view.node_resources(target.node_id) is not None
    pg = env.util.placement_group([{"CPU": 3}], strategy="PACK")
    assert pg.wait(5)
    ref = env.in_bundle(pg, 0, num_cpus=1).remote(env.name)
    node, _group = env.pkg.get(ref, timeout=3)
    return env.node_of(node)


def test_late_columns_reach_the_head_in_the_port_only():
    want, got = both(case_late_columns, 2)
    assert want[:2] == ("raise", "GetTimeoutError")
    assert got == ("value", "target")


# -- a batched tick over a view seven groups widened ---------------------------

@pytest.fixture
def tick_knobs(monkeypatch):
    """Both packages' ticks run only when a test posts one."""
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "scheduler_wakeup_debounce_ms", rt.NEVER_MS)
        monkeypatch.setattr(cfg, "event_loop_tick_ms", int(rt.NEVER_MS))


def _widened_view(pkg, node_ids, rows):
    res = importlib.import_module(f"{pkg}.scheduler.resources")
    ids = importlib.import_module(f"{pkg}._private.ids")
    view = res.ClusterResourceView()
    for nid, (total, avail) in zip(node_ids, rows):
        nr = res.NodeResources(total)
        nr.available = {k: res._quantize(v) for k, v in avail.items()}
        view.add_node(ids.NodeID(nid), nr)
    return view


def test_batched_tick_after_seven_groups_matches_jax(tick_knobs):
    """Seven groups of four ``{"CPU": 1}`` bundles over eight nodes widen
    the view to 75 columns (R_pad 80).  A batch of leases, one into each
    bundle and some plain ones, goes through one batched tick of each
    package's raylet: the same replies, every bundle's lease granted on
    or spilled to its bundle's node, and the port's ``class_fill`` ran at
    R_pad 80 (the parent raised ``ValueError`` there)."""
    from ray_tpu_torch.scheduler.bundle_packing import (
        bundle_resource_names, rewrite_resources_for_bundle)
    rng = np.random.default_rng(21)
    node_ids = [rng.bytes(16) for _ in range(8)]
    rows = [({"CPU": 8.0, "memory": 16.0}, {"CPU": 6.0, "memory": 16.0})
            for _ in node_ids]
    bundles = []
    for g in range(7):
        pg = type("PG", (), {"hex": lambda self, h=rng.bytes(16).hex(): h})()
        for b in range(4):
            node = (3 * g + b) % len(node_ids)
            for name, v in bundle_resource_names(
                    pg, b, _port_request({"CPU": 1})).items():
                for d in rows[node]:
                    d[name] = d.get(name, 0.0) + v
            bundles.append((pg, b, node))
    jax_view = _widened_view("ray_tpu", node_ids, rows)
    port_view = _widened_view(PORT, node_ids, rows)
    assert len(port_view.columns) == 75
    pair = (rt.JaxStubRaylet(node_ids[0], jax_view),
            rt.PortStubRaylet(node_ids[0], port_view))
    try:
        fields = [rt.spec_fields(rng, rewrite_resources_for_bundle(
            {"CPU": 1}, pg, b)) for pg, b, _ in bundles]
        fields += [rt.spec_fields(rng, {"CPU": 1}) for _ in range(6)]
        replies = (rt.Replies(), rt.Replies())
        keys = list(range(len(fields)))
        for stub, make, rep in zip(pair, (rt.jax_spec, rt.port_spec),
                                   replies):
            stub.request_worker_lease_batch([make(f) for f in fields],
                                            rep.batch(keys))
            rt.tick(stub)
        assert replies[1].by_lease == replies[0].by_lease
        for k, (_pg, _b, node) in enumerate(bundles):
            (reply,) = replies[1].by_lease[k]
            want = ("grant",) if node == 0 else \
                ("spill", node_ids[node].hex())
            assert reply == want
        tm = pair[1].cluster_task_manager
        assert tm.tick_stats["device_errors"] == 0
        assert tm._solver.stats["ticks"] == 1
        assert tm._solver.pads()[1] == 80
    finally:
        for stub in pair:
            stub.shutdown()


def _port_request(d):
    from ray_tpu_torch.scheduler.resources import ResourceRequest
    return ResourceRequest(d)


def test_bundle_packing_counters_are_exported():
    """The manager's collector renders the bundle solve's counters
    (``ray_tpu.pg.bundle_packing.*``), and the GCS loop's handler
    counts its retry tick."""
    from ray_tpu_torch._private.metrics_agent import get_metrics_registry
    from ray_tpu_torch.scheduler import bundle_packing
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        pg = ray_tpu_torch.util.placement_group([{"CPU": 1}])
        assert pg.wait(10)
        text = get_metrics_registry().render_prometheus()
        w = importlib.import_module("ray_tpu_torch._private.worker")
        loop = w.global_worker().cluster.loop
        assert loop.handler_stats["pg.schedule"]["errors"] == 0
    finally:
        ray_tpu_torch.shutdown()
    lines = text.splitlines()
    for key, value in bundle_packing.kernel_stats.items():
        assert f"ray_tpu_pg_bundle_packing_{key} {value}" in lines
    assert bundle_packing.kernel_stats["greedy_placements"] >= 1


def test_no_port_thread_survives_shutdown():
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert left == []
    assert not ray_tpu_torch.is_initialized()
