"""Running one case on each package's cluster, for the port's
placement-group, autoscaler and actor parity tests: ``Env`` (a cluster with
named nodes of the same totals under each package's ``init``, its
``temp_dir`` fresh), ``run_case`` and ``both``, and outcomes as comparable
data (``outcome``: the value, or the error's type and message with ids
masked and the package's name read as one)."""

import importlib
import re
import shutil
import tempfile
import threading
import time

PORT = "ray_tpu_torch"
GIB = 1024 ** 3


def where(pkg_name):
    """(node id, placement group id or None) of the running task; the
    runtime context's group id must be the same."""
    pkg = importlib.import_module(pkg_name)
    util = importlib.import_module(f"{pkg_name}.util")
    pg = util.get_current_placement_group()
    group = pg.id.hex() if pg is not None else None
    ctx = pkg.get_runtime_context()
    assert ctx.get_placement_group_id() == group
    return ctx.get_node_id(), group


def normalize(message):
    message = message.replace("ray_tpu_torch", "ray_tpu")
    return re.sub(r"[0-9a-f]{12,}", "<id>", message)


def outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("raise", type(e).__name__, normalize(str(e)))


class Env:
    """One package's cluster with named nodes of the same totals in
    both (the JAX package's defaults: 4 GiB of ``memory``, 2 GiB of
    ``object_store_memory``), its ``temp_dir`` fresh and removed after."""

    def __init__(self, name, head_cpus, system_config=None, device="cpu"):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.util = importlib.import_module(f"{name}.util")
        self.strategies = importlib.import_module(
            f"{name}.util.scheduling_strategies")
        self.temp_dir = tempfile.mkdtemp(prefix=f"{name}-")
        system_config = {"temp_dir": self.temp_dir, **(system_config or {})}
        self._config_module().initialize_config(system_config)
        self.names = {}
        if name == PORT:
            from ray_tpu_torch._private.cluster import Cluster
            self.cluster = Cluster(device=device)
            head = self.cluster.add_node(self._totals(head_cpus, None),
                                         node_name="head")
        else:
            from ray_tpu._private.cluster import Cluster
            system_config["use_native_object_store"] = False
            self._config_module().initialize_config(system_config)
            self.cluster = Cluster(initialize_head=True, head_node_args=dict(
                num_cpus=head_cpus, node_name="head"))
            head = self.cluster.head_node
        self.names[head.node_id.hex()] = "head"
        self.pkg.init(_cluster=self.cluster, _system_config=system_config)

    def _config_module(self):
        return importlib.import_module(f"{self.name}._private.config")

    @staticmethod
    def _totals(cpus, resources):
        return {"CPU": float(cpus), "memory": float(4 * GIB),
                "object_store_memory": float(2 * GIB), **(resources or {})}

    def add_node(self, name, cpus, resources=None):
        if self.name == PORT:
            node = self.cluster.add_node(self._totals(cpus, resources),
                                         node_name=name)
        else:
            node = self.cluster.add_node(num_cpus=cpus, resources=resources,
                                         node_name=name)
        self.names[node.node_id.hex()] = name
        return node

    def broadcast(self):
        """One resource poll-and-broadcast round, done when this
        returns: every view (the GCS's and the raylets') up to date."""
        if self.name == PORT:
            self.cluster.broadcast_now()
            return
        done = threading.Event()
        loop = self.cluster.gcs.loop
        loop.post(self.cluster.gcs.resource_manager._poll_and_broadcast,
                  "test.broadcast")
        loop.post(done.set, "test.broadcast_done")
        assert done.wait(30), "the GCS loop did not answer"

    def node_of(self, hex_id):
        return self.names.get(hex_id, hex_id)

    def bundle_nodes(self, pg):
        info = self.util.placement_group_table(pg)
        return {int(i): self.node_of(n)
                for i, n in info["bundle_nodes"].items()}

    def in_bundle(self, pg, idx, fn=where, **options):
        strategy = self.strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=idx)
        return self.pkg.remote(**options)(fn).options(
            scheduling_strategy=strategy)

    def available_cpu(self):
        return self.pkg.available_resources().get("CPU", 0.0)

    def shutdown(self):
        try:
            self.pkg.shutdown()
        finally:
            self._config_module().initialize_config()
            shutil.rmtree(self.temp_dir, ignore_errors=True)


def wait_until(predicate, timeout=30.0, what="the condition"):
    """Poll ``predicate`` until it holds; raise after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} never held")
        time.sleep(0.01)


def run_case(name, case, head_cpus, system_config=None, device="cpu"):
    """``case(env)``'s outcome on ``name``'s cluster; the port's raylets
    tick on ``device`` (the card with None)."""
    env = Env(name, head_cpus, system_config, device=device)
    try:
        return outcome(lambda: case(env))
    finally:
        env.shutdown()


def both(case, head_cpus, system_config=None):
    return [run_case(name, case, head_cpus, system_config)
            for name in ("ray_tpu", PORT)]


