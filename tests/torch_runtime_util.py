"""Stub raylets that run the JAX package's and the port's scheduling
plane side by side, tick by tick, on the CPU.

Each stub holds what a ``ClusterTaskManager`` reads from its raylet: a
node id, the dirty cluster view, an event loop named ``raylet-...`` (so
that ``@loop_only("raylet")`` passes on its thread), a worker pool, the
``LocalTaskManager`` and the lease counters.  Its lease protocol is the
raylet's own code: the reference ``Raylet``'s methods on the JAX stub,
the port ``Raylet``'s on the port stub.  The JAX stub's pool hands out
bare worker ids and its object plane reports every argument inline;
the port stub runs the port's ``WorkerPool``.

Ticks are made deterministic with the reference's own knobs: a huge
``scheduler_wakeup_debounce_ms`` (no periodic tick is scheduled on a
stub), then ``tick(stub)`` posts one ``schedule_and_dispatch`` to the
loop and waits until the loop is idle.
"""

import threading
import types

import numpy as np
import torch

from ray_tpu._private import cluster_task_manager as jctm
from ray_tpu._private import event_loop as jloop
from ray_tpu._private import ids as jids
from ray_tpu._private import local_task_manager as jltm
from ray_tpu._private import raylet as jraylet
from ray_tpu._private import task_spec as jts
from ray_tpu.scheduler import resources as jres
from ray_tpu_torch._private import cluster_task_manager as tctm
from ray_tpu_torch._private import convert as tconv
from ray_tpu_torch._private import event_loop as tloop
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import local_task_manager as tltm
from ray_tpu_torch._private import raylet as traylet
from ray_tpu_torch._private import worker_pool as twp
from ray_tpu_torch._private.metrics_agent import \
    get_metrics_registry as t_registry
from ray_tpu._private.metrics_agent import \
    get_metrics_registry as j_registry

# A tick that never fires on its own: the test posts every tick.
NEVER_MS = 1e9


def _lease_stats():
    return {"lease_requests": 0, "lease_batch_requests": 0,
            "lease_batch_entries": 0}


class _JaxPool:
    """The JAX stub's worker slots: a fresh id per lease."""

    def pop_worker(self, runtime_env=None):
        return types.SimpleNamespace(worker_id=jids.WorkerID.from_random(),
                                     stop=lambda: None)

    def push_worker(self, worker):
        pass

    def prestart_for_backlog(self, depth, bound):
        return 0


class JaxStubRaylet:
    request_worker_lease = jraylet.Raylet.request_worker_lease
    request_worker_lease_batch = jraylet.Raylet.request_worker_lease_batch
    return_worker = jraylet.Raylet.return_worker
    update_resource_usage = jraylet.Raylet.update_resource_usage

    def __init__(self, node_id: bytes, view):
        self.node_id = jids.NodeID(node_id)
        self.cluster_view = view
        self.cluster = types.SimpleNamespace(
            gcs=types.SimpleNamespace(task_events=None))
        self.core_worker = None
        self.object_manager = types.SimpleNamespace(
            is_local_or_inline=lambda oid: True)
        self.object_store = types.SimpleNamespace(pin=lambda oid: None,
                                                  unpin=lambda oid: None)
        self.lease_stats = _lease_stats()
        self._dead = False
        self.worker_pool = _JaxPool()
        self.loop = jloop.EventLoop(f"raylet-{self.node_id.hex()[:6]}")
        self.local_task_manager = jltm.LocalTaskManager(self)
        self.cluster_task_manager = jctm.ClusterTaskManager(self)

    def shutdown(self):
        self._dead = True
        self.loop.stop()


class PortStubRaylet:
    request_worker_lease = traylet.Raylet.request_worker_lease
    request_worker_lease_batch = traylet.Raylet.request_worker_lease_batch
    return_worker = traylet.Raylet.return_worker
    update_resource_usage = traylet.Raylet.update_resource_usage

    def __init__(self, node_id: bytes, view, device="cpu"):
        self.node_id = tids.NodeID(node_id)
        self.cluster_view = view
        self.cluster = None
        self.device = torch.device(device)
        self.lease_stats = _lease_stats()
        self._dead = False
        self.loop = tloop.EventLoop(f"raylet-{self.node_id.hex()[:6]}")
        self.worker_pool = twp.WorkerPool(self)
        self.local_task_manager = tltm.LocalTaskManager(self)
        self.cluster_task_manager = tctm.ClusterTaskManager(self)

    def shutdown(self):
        self._dead = True
        self.worker_pool.shutdown()
        self.loop.stop()


# -- the cluster state: nodes and views ---------------------------------------

COLUMNS = ["CPU", "memory", "GPU", "custom_a"]


def random_nodes(rng, n):
    """``n`` node ids (16 bytes each) with [n, R] quantized total and
    available rows over ``COLUMNS``: CPU nodes of 2-16 cores, a fifth
    with GPUs, a third with a custom resource, 0-60% in use."""
    ids = [rng.bytes(16) for _ in range(n)]
    total = np.zeros((n, len(COLUMNS)))
    total[:, 0] = rng.choice([2, 4, 8, 16], size=n)
    total[:, 1] = rng.choice([4, 8, 16, 64], size=n)
    total[:, 2] = np.where(rng.random(n) < 0.2, rng.choice([1, 4], size=n), 0)
    total[:, 3] = np.where(rng.random(n) < 0.33, rng.integers(1, 5, size=n), 0)
    used = np.floor(rng.uniform(0, 0.6, size=total.shape) * 4) / 4
    avail = np.floor(total * (1 - used) * 2) / 2
    q = lambda x: np.rint(x * jres.FP_SCALE).astype(np.int64)  # noqa: E731
    return ids, q(total), q(avail)


def jax_view(node_ids, total_q, avail_q, labels=None):
    view = jres.ClusterResourceView()
    for i, (nid, tq, aq) in enumerate(zip(node_ids, total_q, avail_q)):
        nr = jres.NodeResources({c: int(v) / jres.FP_SCALE
                                 for c, v in zip(COLUMNS, tq) if v > 0},
                                labels=dict(labels[i]) if labels else None)
        nr.available = {c: int(v) for c, v in zip(COLUMNS, aq) if v > 0}
        view.add_node(jids.NodeID(nid), nr)
    return view


def port_view(node_ids, total_q, avail_q, labels=None):
    return tconv.view_from_quantized(node_ids, COLUMNS, total_q, avail_q,
                                     labels)


def make_pair(node_ids, total_q, avail_q, labels=None):
    """(JAX stub, port stub) on views of the same nodes (``labels``: one
    dict a node, or None); the first node is the local one."""
    return (JaxStubRaylet(node_ids[0], jax_view(node_ids, total_q, avail_q,
                                                labels)),
            PortStubRaylet(node_ids[0], port_view(node_ids, total_q,
                                                  avail_q, labels)))


# -- specs --------------------------------------------------------------------

def spec_fields(rng, resources, strategy=None):
    """A TaskSpec's fields with fresh ids (bytes), no arguments."""
    return {"task_id": rng.bytes(16), "job_id": b"\x01\x00\x00\x00",
            "task_type": "NORMAL_TASK", "function_id": rng.bytes(16),
            "function_name": "f", "args": [], "num_returns": 1,
            "resources": dict(resources), "owner_id": rng.bytes(16),
            "scheduling_options": strategy or {"scheduling_type": "hybrid"}}


def jax_spec(fields):
    """The JAX package's TaskSpec for ``fields`` (its own interning)."""
    from ray_tpu.scheduler import policy as jpolicy
    f = dict(fields)
    id_types = {"task_id": jids.TaskID, "job_id": jids.JobID,
                "function_id": jids.FunctionID, "owner_id": jids.WorkerID,
                "actor_id": jids.ActorID}
    for name, cls in id_types.items():
        if f.get(name) is not None:
            f[name] = cls(f[name])
    f["resources"] = jres.ResourceRequest(f["resources"])
    if f.get("lifetime_resources") is not None:
        f["lifetime_resources"] = jres.ResourceRequest(
            f["lifetime_resources"])
    opts = dict(f["scheduling_options"])
    opts["scheduling_type"] = jpolicy.SchedulingType(opts["scheduling_type"])
    if opts.get("node_affinity_node_id") is not None:
        opts["node_affinity_node_id"] = jids.NodeID(
            opts["node_affinity_node_id"])
    f["scheduling_options"] = jpolicy.SchedulingOptions(**opts)
    f["args"] = [jts.TaskArg(**a) for a in f["args"]]
    f["scheduling_class"] = jts.scheduling_class_of(f["resources"],
                                                    f["scheduling_options"])
    return jts.TaskSpec(**f)


def port_spec(fields):
    return tconv.task_spec_from_fields(fields)


# -- driving ------------------------------------------------------------------

def settle(loop, timeout=30.0):
    """Wait until ``loop`` has run everything posted to it, including
    what its handlers posted."""
    for _ in range(1000):
        done, idle = threading.Event(), []

        def probe():
            idle.append(not loop._queue)
            done.set()
        loop.post(probe, "test.settle")
        assert done.wait(timeout), f"loop {loop.name} did not answer"
        if idle[0]:
            return
    raise AssertionError(f"loop {loop.name} never went idle")


def tick(stub):
    stub.loop.post(stub.cluster_task_manager.schedule_and_dispatch,
                   "cluster.schedule")
    settle(stub.loop)


def classify(result):
    """A lease reply as comparable data: the spillback target by hex."""
    if "worker" in result:
        return ("grant",)
    if "retry_at" in result:
        return ("spill", result["retry_at"].hex())
    if result.get("rejected"):
        return ("rejected",)
    if result.get("infeasible"):
        return ("infeasible",)
    if result.get("backlog"):
        return ("backlog",)
    raise AssertionError(f"unknown reply {result}")


class Replies:
    """Every reply per lease key, and the worker of each grant."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_lease = {}
        self.workers = {}

    def record(self, key, result):
        with self._lock:
            self.by_lease.setdefault(key, []).append(classify(result))
            if "worker" in result:
                self.workers[key] = result["worker"]

    def single(self, key):
        return lambda result: self.record(key, result)

    def batch(self, keys):
        def reply(rep):
            for key, result in zip(keys, rep["results"]):
                self.record(key, result)
        return reply


def scheduler_series(registry, label,
                     skip=("ray_tpu_scheduler_tick_latency",)):
    """{(name, labels): value} of the rendered ``ray_tpu_scheduler_*``
    series labelled ``node=label``; histogram values under ``skip``
    (timings) read None."""
    out = {}
    tag = f'node="{label}"'
    for line in registry.render_prometheus().splitlines():
        if not line.startswith("ray_tpu_scheduler_") or tag not in line:
            continue
        key, value = line.rsplit(" ", 1)
        name, labels = key.split("{", 1)
        out[(name, labels)] = None if name.startswith(skip) else float(value)
    return out


def jax_series(label):
    return scheduler_series(j_registry(), label)


def port_series(label):
    return scheduler_series(t_registry(), label)
