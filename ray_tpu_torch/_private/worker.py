"""Driver bootstrap: the global worker + init/shutdown.

A port of ``ray_tpu._private.worker`` for the PyTorch port (reference
``python/ray/worker.py``): ``init`` starts an in-process cluster (a
``Cluster`` with one head raylet, whose node store holds
``object_store_memory`` bytes) or attaches to the caller's, attaches the
driver's ``CoreWorker`` and registers the job with the GCS's job
manager; ``shutdown`` marks the job finished and stops every worker
thread, raylet loop, heartbeat, pull thread and spill thread, the GCS
and the reference counter's release thread; and the public
``get``/``put``/``wait``/``nodes`` (the GCS node manager's table, dead
nodes included)/``cluster_resources``/``available_resources`` (the
resource manager's)/``kill``/``get_actor`` bodies that ``ray_tpu_torch``
re-exports.  ``init`` takes the driver's ``namespace`` (an anonymous one
per job by default), where ``get_actor`` and a named actor without a
namespace of its own look.

The raylets' batched ticks run on ``device``: the card unless the caller
passes ``device="cpu"``, so ``init`` raises without a card.  The head's
GPU count is the caller's ``num_gpus``, else the cards that
``torch.cuda.device_count()`` sees when the cluster is on the card (0 on
the CPU): the counterpart of the reference's ``_detect_tpu_chips``,
which creates no device context either; ``get_gpu_ids`` is its
``get_tpu_ids``.

With ``worker_process_mode="process"`` the head's pool prestarts
``min(CPUs, 8)`` worker processes at ``init`` (reference
PrestartWorkers on driver start, worker_pool.h:350), and, with
``log_to_driver``, the driver mirrors their log lines onto its terminal;
``shutdown`` terminates every child.  Left out until its item: the
remote-driver (client) path, ``init(address=...)`` (ROADMAP A.4b.10).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import List, Optional, Sequence, Tuple

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.cluster import Cluster
from ray_tpu_torch._private.config import get_config, initialize_config
from ray_tpu_torch._private.core_worker import CoreWorker
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.object_ref import ObjectRef


class Worker:
    """The per-process global worker (driver side)."""

    def __init__(self):
        self.connected = False
        self.cluster = None
        self.core_worker: Optional[CoreWorker] = None
        self.job_id: Optional[JobID] = None
        self.namespace: str = ""
        #: The driver's subscription to the worker_logs channel.
        self.log_mirror_sub: Optional[int] = None


_global_worker: Optional[Worker] = None
_init_lock = threading.RLock()


def global_worker() -> Worker:
    global _global_worker
    with _init_lock:
        if _global_worker is None:
            _global_worker = Worker()
        return _global_worker


def global_worker_or_none() -> Optional[Worker]:
    return _global_worker


def init(*, num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None, resources: Optional[dict] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "", ignore_reinit_error: bool = False,
         _system_config: Optional[dict] = None, _cluster=None,
         device=None):
    """Start an in-process cluster and attach this driver.

    The head raylet gets ``num_cpus`` CPUs (the host's count by default,
    as the reference), ``num_gpus`` GPUs and ``resources``, and a node
    store of ``object_store_memory`` bytes (``Config.object_store_memory``,
    2 GiB, by default); its batched tick runs on ``device`` (the card
    unless ``"cpu"``).  ``_cluster``
    attaches to the caller's ``Cluster`` instead, whose device
    holds; ``shutdown`` stops it as well, as the reference does.
    """
    w = global_worker()
    with _init_lock:
        if w.connected:
            if ignore_reinit_error:
                return RuntimeContextInfo(w)
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to ignore.")
        initialize_config(_system_config)
        mode = get_config().worker_process_mode
        if mode not in ("thread", "process"):
            raise ValueError(f"worker_process_mode={mode!r}: 'thread' or "
                             "'process'")
        if _cluster is not None:
            cluster = _cluster
        else:
            head = dict(resources or {})
            head["CPU"] = float(os.cpu_count() or 1) if num_cpus is None \
                else float(num_cpus)
            if num_gpus is None:
                num_gpus = _detect_gpus(device)
            if num_gpus:
                head["GPU"] = float(num_gpus)
            cluster = Cluster(device=device)
            try:
                cluster.add_node({k: v for k, v in head.items() if v},
                                 node_name="head",
                                 object_store_memory=object_store_memory)
            except BaseException:
                cluster.shutdown()
                raise
        w.cluster = cluster
        w.job_id = JobID.next()
        w.namespace = namespace or f"anon_ns_{w.job_id.hex()}"
        w.core_worker = CoreWorker(cluster, w.job_id)
        cluster.attach_core_worker(w.core_worker)
        cluster.gcs.job_manager.add_job(w.job_id)
        w.connected = True
        atexit.register(_atexit_shutdown)
        try:
            if get_config().log_to_driver:
                # print()s inside process workers reach this terminal.
                from ray_tpu_torch._private.log_monitor import \
                    mirror_worker_logs
                w.log_mirror_sub = mirror_worker_logs(cluster.gcs.publisher)
            if mode == "process" and cluster.head_node is not None:
                # Worker start-up hides behind init.
                head = cluster.head_node
                cpus = head.local_resources.to_float_dict("total").get(
                    "CPU", 1)
                head.worker_pool.prestart_workers(min(int(cpus), 8))
        except BaseException:
            shutdown()
            raise
        return RuntimeContextInfo(w)


def shutdown():
    """Detach the driver and stop the cluster: every worker thread and
    worker process, raylet loop, pull and spill thread, and the
    reference counter's release thread."""
    w = global_worker_or_none()
    if w is None or not w.connected:
        return
    with _init_lock:
        core, cluster, job_id = w.core_worker, w.cluster, w.job_id
        sub, w.log_mirror_sub = w.log_mirror_sub, None
        w.connected = False
        w.cluster = None
        w.core_worker = None
        worker_context.clear_context()
        if sub is not None:
            from ray_tpu_torch._private.log_monitor import LOG_CHANNEL
            cluster.gcs.publisher.unsubscribe(LOG_CHANNEL, None, sub)
        cluster.gcs.job_manager.mark_job_finished(job_id)
        core.reference_counter.close()
        cluster.shutdown()


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def is_initialized() -> bool:
    w = global_worker_or_none()
    return bool(w and w.connected)


def _detect_gpus(device) -> float:
    """The cards of this host when the cluster runs on the card, else 0.
    ``torch.cuda.device_count`` creates no context."""
    import torch
    if torch.device("cuda" if device is None else device).type != "cuda":
        return 0.0
    return float(torch.cuda.device_count())


def _require_connected() -> Worker:
    """get/put/wait require an initialized cluster; no auto-init here (a
    background thread touching the API after shutdown() must not boot a
    fresh cluster)."""
    w = global_worker()
    if not w.connected:
        raise RuntimeError(
            "ray_tpu_torch.init() has not been called yet (or the cluster "
            "was shut down); call ray_tpu_torch.init() first.")
    return w


class RuntimeContextInfo:
    """Return value of init(): address info (client context parity)."""

    def __init__(self, worker: Worker):
        head = worker.cluster.head_node
        self.address_info = {
            "node_id": head.node_id.hex() if head is not None else None}

    def __getitem__(self, k):
        return self.address_info[k]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()


# ---------------------------------------------------------------------------
# Public API bodies (re-exported by ray_tpu_torch/__init__.py).
# ---------------------------------------------------------------------------

def get(refs, timeout: Optional[float] = None):
    w = _require_connected()
    if isinstance(refs, ObjectRef):
        return w.core_worker.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(
            f"get() expects an ObjectRef or list, got {type(refs)}")
    return w.core_worker.get(list(refs), timeout)


def put(value) -> ObjectRef:
    w = _require_connected()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    return w.core_worker.put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List, List]:
    w = _require_connected()
    refs = list(refs)
    if any(not isinstance(r, ObjectRef) for r in refs):
        raise TypeError("wait() expects a list of ObjectRefs")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() expects unique ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > number of refs")
    return w.core_worker.wait(refs, num_returns, timeout, fetch_local)


def get_gpu_ids() -> List[int]:
    """The GPU ids of the running task: ``range`` of its ``"GPU"``
    demand (the reference's ``get_tpu_ids`` with ``"TPU"``); empty on
    the driver."""
    spec = worker_context.current_task_spec()
    if spec is None:
        return []
    return list(range(int(spec.resources.get("GPU"))))


def nodes() -> List[dict]:
    w = _require_connected()
    out = []
    for node_id, info in \
            w.cluster.gcs.node_manager.get_all_node_info().items():
        entry = dict(info)
        entry["NodeID"] = node_id.hex()
        entry["Alive"] = info.get("state") == "ALIVE"
        entry["Resources"] = info.get("resources", {})
        out.append(entry)
    return out


def cluster_resources() -> dict:
    w = _require_connected()
    return w.cluster.gcs.resource_manager.view.total_cluster_resources()


def available_resources() -> dict:
    w = _require_connected()
    return w.cluster.gcs.resource_manager.live_available_resources()


def kill(actor, *, no_restart: bool = True):
    """Kill ``actor``: its worker stops after its current methods, and
    the actor is DEAD, or restarts when ``no_restart`` is False and it
    has restarts left."""
    from ray_tpu_torch.actor import ActorHandle
    w = _require_connected()
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    w.cluster.gcs.actor_manager.destroy_actor(actor._actor_id,
                                              no_restart=no_restart)


def get_actor(name: str, namespace: Optional[str] = None):
    """The handle of the live actor named ``name`` in ``namespace`` (the
    driver's by default); ``ValueError`` when there is none."""
    from ray_tpu_torch.actor import ActorHandle
    w = _require_connected()
    ns = namespace if namespace is not None else w.namespace
    actor = w.cluster.gcs.actor_manager.get_named_actor(name, ns)
    if actor is None:
        raise ValueError(f"Failed to look up actor {name!r} in namespace "
                         f"{ns!r}")
    return ActorHandle._from_gcs_actor(actor)
