"""A GCS restart over its file store, the port against the JAX package,
on the CPU: the cases of ``tests/test_gcs_fault_tolerance.py`` that need
no actor and no remote node, each run on a cluster of each package with
a file-backed GCS (``gcs_storage_path``) under that package's ``init``,
with the outcomes (values with node ids read as node names) compared
exactly:

* a placement group survives the restart, CREATED on the same nodes and
  usable (``:93``);
* a group whose table row the outage ate has its bundles released on
  its raylet (``:116``, ReleaseUnusedBundles);
* tasks flow after the restart and the resources converge (``:207``),
  with the exported function read back from the reloaded KV;
* a node killed while the GCS is down is declared dead by the
  reconcile, the survivors keep their incarnations, and the restart
  keeps the job table.
"""

import importlib
import shutil
import tempfile
import time

import pytest

from torch_cluster_util import PORT, outcome, wait_until

GIB = 1024 ** 3


class _Persistent:
    """One package's cluster with a file-backed GCS, a 4-CPU head named
    "head", under that package's ``init``."""

    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.util = importlib.import_module(f"{name}.util")
        self.strategies = importlib.import_module(
            f"{name}.util.scheduling_strategies")
        self.temp_dir = tempfile.mkdtemp(prefix=f"{name}-restart-")
        config = {"temp_dir": self.temp_dir}
        path = f"{self.temp_dir}/gcs.bin"
        self._config().initialize_config(config)
        if name == PORT:
            from ray_tpu_torch._private.cluster import Cluster
            self.cluster = Cluster(device="cpu", gcs_storage_path=path)
            self.cluster.add_node(self.totals(4), node_name="head")
        else:
            from ray_tpu._private.cluster import Cluster
            config["use_native_object_store"] = False
            self._config().initialize_config(config)
            self.cluster = Cluster(initialize_head=True,
                                   head_node_args={"num_cpus": 4,
                                                   "node_name": "head"},
                                   gcs_storage_path=path)
        self.names = {self.cluster.head_node.node_id.hex(): "head"}
        self.pkg.init(_cluster=self.cluster, _system_config=config)

    def _config(self):
        return importlib.import_module(f"{self.name}._private.config")

    @staticmethod
    def totals(cpus):
        return {"CPU": float(cpus), "memory": float(4 * GIB),
                "object_store_memory": float(2 * GIB)}

    def add_node(self, name, cpus):
        if self.name == PORT:
            node = self.cluster.add_node(self.totals(cpus), node_name=name)
        else:
            node = self.cluster.add_node(num_cpus=cpus, node_name=name)
        self.names[node.node_id.hex()] = name
        return node

    def bundle_nodes(self, pg):
        info = self.util.placement_group_table(pg)
        return {int(i): self.names.get(n, n)
                for i, n in info["bundle_nodes"].items()}

    def shutdown(self):
        try:
            self.pkg.shutdown()
        finally:
            self._config().initialize_config()
            shutil.rmtree(self.temp_dir, ignore_errors=True)


def both(case):
    out = []
    for name in ("ray_tpu", PORT):
        env = _Persistent(name)
        try:
            out.append(outcome(lambda: case(env)))
        finally:
            env.shutdown()
    return out


def _double(x):
    return 2 * x


def _placed():
    return "placed"


def case_placement_group_survives_restart(env):
    pg = env.util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK",
                                  name="pg-live")
    assert env.pkg.get(pg.ready(), timeout=15)
    before = env.bundle_nodes(pg)
    env.cluster.restart_gcs()
    record = env.cluster.gcs.placement_group_manager.get(pg.id)
    strategy = env.strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    inside = env.pkg.remote(num_cpus=1)(_placed).options(
        scheduling_strategy=strategy)
    return (before, record.state, len(record.bundle_nodes),
            env.bundle_nodes(pg), record.name,
            env.pkg.get(inside.remote(), timeout=30))


def case_leaked_bundles_released_on_restart(env):
    head = env.cluster.head_node
    pg = env.util.placement_group([{"CPU": 2}], strategy="PACK")
    assert env.pkg.get(pg.ready(), timeout=15)
    held_before = any(key[0] == pg.id for key in head._committed_bundles)
    cpu_held = head.local_resources.to_float_dict("available")["CPU"]
    env.cluster.gcs.storage.placement_group_table.delete(pg.id)
    env.cluster.restart_gcs()
    wait_until(lambda: not any(key[0] == pg.id
                               for key in head._committed_bundles),
               10, "the leaked bundle's release")
    return (held_before, cpu_held,
            head.local_resources.to_float_dict("available")["CPU"],
            env.cluster.gcs.placement_group_manager.get(pg.id))


def case_tasks_flow_after_restart(env):
    double = env.pkg.remote(_double)
    first = env.pkg.get(double.remote(4), timeout=30)
    env.cluster.restart_gcs()
    after = env.pkg.get([double.remote(i) for i in range(8)], timeout=30)
    # A function first exported after the restart, and one read back
    # from the reloaded KV by a fresh load.
    fresh = env.pkg.get(env.pkg.remote(_placed).remote(), timeout=30)
    view = env.cluster.gcs.resource_manager.view
    wait_until(lambda: view.available_cluster_resources().get("CPU") == 4.0,
               10, "the CPUs back in the GCS view")
    return first, after, fresh, view.available_cluster_resources()["CPU"]


def case_reconcile_declares_the_lost_node_dead(env):
    survivor = env.add_node("survivor", 2)
    lost = env.add_node("lost", 2)
    incarnations = (survivor.incarnation, lost.incarnation)
    job_before = {k: v["state"]
                  for k, v in env.cluster.gcs.job_manager.jobs.items()}
    env.cluster.gcs.shutdown()
    env.cluster.kill_node(lost)
    env.cluster.restart_gcs()
    nm = env.cluster.gcs.node_manager
    jobs = {k: v["state"] for k, v in
            env.cluster.gcs.storage.job_table.get_all()}
    return (incarnations, nm.current_incarnation(survivor.node_id),
            nm.is_alive(survivor.node_id),
            nm.dead_nodes[lost.node_id]["death_reason"],
            sorted(env.names[n.node_id.hex()]
                   for n in env.cluster.raylets()),
            list(job_before.values()), sorted(jobs.values()))


@pytest.mark.parametrize("case", [
    case_placement_group_survives_restart,
    case_leaked_bundles_released_on_restart,
    case_tasks_flow_after_restart,
    case_reconcile_declares_the_lost_node_dead,
], ids=lambda c: c.__name__)
def test_gcs_restart_case_matches_jax(case):
    jax, port = both(case)
    assert port == jax
    assert port[0] == "value", port


def test_restart_needs_a_file_store():
    from ray_tpu_torch._private.cluster import Cluster
    cluster = Cluster(device="cpu")
    try:
        with pytest.raises(ValueError, match="gcs_storage_path"):
            cluster.restart_gcs()
    finally:
        cluster.shutdown()


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_gcs_restart")
