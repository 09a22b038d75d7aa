"""The port's autoscaler loop (``ray_tpu_torch.autoscaler``:
``StandardAutoscaler``, ``LoadMetrics``, ``MockProvider``,
``FakeMultiNodeProvider``, ``Monitor``, ``request_resources``) against
the JAX package's, on the CPU.

The cases of ``tests/test_autoscaler.py:161-235``: launch for demand,
idle termination and max-workers termination on a ``MockProvider``
(no cluster), and the fake multi-node and ``request_resources`` cases
end to end, each once under each package's ``init`` with a fresh
``temp_dir`` (``torch_cluster_util``); then ``LoadMetrics`` itself and
``Monitor.update_load_metrics`` with a pending placement group and
infeasible demand, node ids read as node names.  The port's autoscaler
solves on ``device="cpu"``.  The last test checks that the monitor's
thread and every thread of the port end with ``stop`` and ``shutdown``.
"""

import importlib
import threading
import time

import pytest

import ray_tpu_torch
from torch_cluster_util import PORT, both, outcome, wait_until

TYPES = {
    "head": {"resources": {"CPU": 2}, "max_workers": 0},
    "m4.large": {"resources": {"CPU": 2}, "min_workers": 0,
                 "max_workers": 10},
    "m4.4xlarge": {"resources": {"CPU": 16}, "min_workers": 0,
                   "max_workers": 8},
    "p2.xlarge": {"resources": {"CPU": 4, "TPU": 4}, "min_workers": 0,
                  "max_workers": 4},
}
FAKE_TYPES = {
    "head": {"resources": {"CPU": 1}, "max_workers": 0},
    "worker": {"resources": {"CPU": 4, "bigmem": 1}, "min_workers": 0,
               "max_workers": 4},
}


def _modules(name):
    auto = importlib.import_module(f"{name}.autoscaler")
    provider = importlib.import_module(f"{name}.autoscaler.node_provider")
    return auto, provider


def _device(name):
    return {"device": "cpu"} if name == PORT else {}


def _mock_autoscaler(name, **kw):
    auto, np_ = _modules(name)
    provider = np_.MockProvider()
    lm = auto.LoadMetrics()
    scaler = auto.StandardAutoscaler(provider, lm, TYPES,
                                     head_node_type="head", **kw,
                                     **_device(name))
    return np_, provider, lm, scaler


def _workers(np_, provider):
    return provider.non_terminated_nodes(
        {np_.TAG_NODE_KIND: np_.NODE_KIND_WORKER})


def case_launches_for_demand(name):
    np_, provider, lm, scaler = _mock_autoscaler(name, max_workers=10)
    lm.update("h", {"CPU": 2}, {"CPU": 0}, pending_demands=[{"CPU": 16}])
    launched = scaler.update()
    workers = _workers(np_, provider)
    return launched, len(workers), \
        provider.node_tags(workers[0])[np_.TAG_NODE_TYPE], scaler.summary()


def case_idle_termination(name):
    np_, provider, lm, scaler = _mock_autoscaler(
        name, max_workers=10, idle_timeout_minutes=0.0)
    lm.update("h", {"CPU": 2}, {"CPU": 0}, pending_demands=[{"CPU": 16}])
    scaler.update()
    (worker,) = _workers(np_, provider)
    ip = provider.internal_ip(worker)
    lm.update("h", {"CPU": 2}, {"CPU": 2}, pending_demands=[])
    lm.update(ip, {"CPU": 16}, {"CPU": 16})
    scaler.last_used_time_by_node[worker] = time.time() - 10
    launched = scaler.update()
    return launched, provider.is_terminated(worker), \
        scaler.num_terminations, ip in lm.static_resources_by_ip


def case_max_workers_termination(name):
    np_, provider, lm, scaler = _mock_autoscaler(name, max_workers=1)
    provider.create_node({}, {np_.TAG_NODE_KIND: np_.NODE_KIND_WORKER,
                              np_.TAG_NODE_TYPE: "m4.large"}, 3)
    launched = scaler.update()
    return launched, len(_workers(np_, provider)), scaler.num_terminations


MOCK_CASES = {
    "launches_for_demand": case_launches_for_demand,
    "idle_termination": case_idle_termination,
    "max_workers_termination": case_max_workers_termination,
}


@pytest.mark.parametrize("case", sorted(MOCK_CASES))
def test_autoscaler_case_matches_jax(case):
    want, got = (outcome(lambda n=n: MOCK_CASES[case](n))
                 for n in ("ray_tpu", PORT))
    assert want[0] == "value", want
    assert got == want


# -- end to end: FakeMultiNodeProvider on each package's cluster -------------

def _bigmem_node(pkg_name):
    pkg = importlib.import_module(pkg_name)
    return pkg.get_runtime_context().get_node_id()


def _monitor(env, types=FAKE_TYPES):
    auto, _ = _modules(env.name)
    return auto.Monitor(env.cluster, types, max_workers=4,
                        idle_timeout_minutes=60, **_device(env.name))


def _node_names(env, monitor, nids):
    return sorted(monitor.provider.node_tags(n)["user-node-type"]
                  for n in nids)


def _wait_for_demand(env):
    """Until the submitted task's lease waits at the head."""
    tm = env.cluster.head_node.cluster_task_manager
    wait_until(lambda: tm.resource_load(), what="a demand at the head")


def case_fake_multinode_autoscales(env):
    monitor = _monitor(env)
    try:
        task = env.pkg.remote(num_cpus=0, resources={"bigmem": 0.5})(
            _bigmem_node)
        ref = task.remote(env.name)
        _wait_for_demand(env)
        launched = monitor.update_all()
        grew = env.cluster.wait_for_nodes(2)
        node = env.pkg.get(ref, timeout=10)
        return launched, grew, node != env.cluster.head_node.node_id.hex(), \
            len(env.cluster.raylets()), _node_names(
                env, monitor, monitor.provider.non_terminated_nodes({}))
    finally:
        monitor.stop()


def case_request_resources(env):
    auto, _ = _modules(env.name)
    monitor = _monitor(env, dict(FAKE_TYPES, worker={
        "resources": {"CPU": 8}, "min_workers": 0, "max_workers": 4}))
    try:
        auto.request_resources(bundles=[{"CPU": 8}, {"CPU": 8}])
        launched = monitor.update_all()
        grew = env.cluster.wait_for_nodes(3)
        again = monitor.update_all()
        return launched, grew, again, \
            monitor.load_metrics.get_resource_requests()
    finally:
        monitor.stop()


def case_update_load_metrics(env):
    """A group no node can hold (STRICT_SPREAD over one node) and a task
    no node fits: both reach the load metrics, with every node's totals
    and availability by its name."""
    auto, _ = _modules(env.name)
    pg = env.util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                  strategy="STRICT_SPREAD")
    task = env.pkg.remote(num_cpus=0, resources={"bigmem": 0.5})(
        _bigmem_node)
    ref = task.remote(env.name)
    _wait_for_demand(env)
    monitor = _monitor(env)
    try:
        monitor.update_load_metrics()
        lm = monitor.load_metrics
        by_name = {env.node_of(r.node_id.hex()): r.node_id.hex()[:12]
                   for r in env.cluster.raylets()}
        out = {
            "demands": lm.get_resource_demand_vector(),
            "groups": lm.get_pending_placement_groups(),
            "static": {n: lm.static_resources_by_ip[ip]
                       for n, ip in by_name.items()},
            "dynamic": {n: lm.dynamic_resources_by_ip[ip]
                        for n, ip in by_name.items()},
            "summary": lm.resources_avail_summary(),
            "active": sorted(n for n, ip in by_name.items()
                             if lm.is_active(ip)),
        }
        # A worker brings bigmem and a second node: both resolve.
        launched = monitor.update_all()
        out["launched"] = launched
        out["placed"] = pg.wait(10)
        out["ran_on_worker"] = env.pkg.get(ref, timeout=10) != \
            env.cluster.head_node.node_id.hex()
        monitor.update_load_metrics()
        out["groups_after"] = lm.get_pending_placement_groups()
        return out
    finally:
        monitor.stop()


E2E_CASES = {
    "fake_multinode_autoscales": (case_fake_multinode_autoscales, 1),
    "request_resources": (case_request_resources, 1),
    "update_load_metrics": (case_update_load_metrics, 1),
}


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_autoscaler_loop_case_matches_jax(case):
    fn, head_cpus = E2E_CASES[case]
    want, got = both(fn, head_cpus)
    assert want[0] == "value", want
    assert got == want


def test_load_metrics_matches_jax():
    """Updates, pruning, requests and the summary, step by step."""
    out = {}
    for name in ("ray_tpu", PORT):
        auto, _ = _modules(name)
        lm = auto.LoadMetrics()
        steps = []
        lm.update("a", {"CPU": 4, "GPU": 1}, {"CPU": 1},
                  pending_demands=[{"CPU": 2}] * 3,
                  pending_placement_groups=[{"strategy": "PACK",
                                             "bundles": [{"CPU": 1}]}])
        lm.update("b", {"CPU": 8}, {"CPU": 8})
        steps.append((lm.get_node_resources(),
                      lm.get_resource_demand_vector(max_len=2),
                      lm.get_resource_demand_vector(clip=False),
                      lm.get_pending_placement_groups(),
                      lm.resources_avail_summary(), lm.is_active("b")))
        lm.set_resource_requests([{"CPU": 3}, {}, {"GPU": 1}])
        lm.prune_active_ips(["b"])
        steps.append((lm.get_static_node_resources_by_ip(),
                      lm.get_resource_requests(), lm.is_active("a"),
                      lm.resources_avail_summary()))
        out[name] = steps
    assert out[PORT] == out["ray_tpu"]


def test_monitor_thread_stops_and_no_port_thread_survives():
    from ray_tpu_torch.autoscaler import Monitor
    ray_tpu_torch.init(num_cpus=1, device="cpu")
    try:
        w = importlib.import_module("ray_tpu_torch._private.worker")
        monitor = Monitor(w.global_worker().cluster, FAKE_TYPES,
                          max_workers=4, device="cpu")
        monitor.start(interval_s=0.01)
        deadline = time.monotonic() + 10
        while monitor.rounds < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        monitor.stop()
        assert monitor.rounds >= 3 and monitor.round_errors == 0
        assert "ray_tpu_torch::autoscaler_monitor" not in [
            t.name for t in threading.enumerate()]
        with pytest.raises(RuntimeError, match="No autoscaler monitor"):
            importlib.import_module(
                "ray_tpu_torch.autoscaler").request_resources(num_cpus=1)
    finally:
        ray_tpu_torch.shutdown()
    assert [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")] == []
