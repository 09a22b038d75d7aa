"""Driver bootstrap: the global worker + init/shutdown.

A port of ``ray_tpu._private.worker`` for the PyTorch port (reference
``python/ray/worker.py``): ``init`` starts an in-process cluster (a
``LocalCluster`` with one head raylet, whose node store holds
``object_store_memory`` bytes) or attaches to the caller's, attaches the
driver's ``CoreWorker``; ``shutdown`` stops every worker thread, raylet
loop, pull thread and spill thread and the reference counter's release
thread; and the
public ``get``/``put``/``wait``/``nodes``/``cluster_resources``/
``available_resources`` bodies that ``ray_tpu_torch`` re-exports.

The raylets' batched ticks run on ``device``: the card unless the caller
passes ``device="cpu"``, so ``init`` raises without a card.  Left out
until their items: the remote-driver (client) path, jobs and namespaces
in a GCS (ROADMAP A.4b.4), worker log mirroring, process workers
(``worker_process_mode="process"`` raises), and the actor entry points
(``kill``, ``get_actor``; the actors item, A.4b.5).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import List, Optional, Sequence, Tuple

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.cluster import LocalCluster
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
         ignore_reinit_error: bool = False,
         _system_config: Optional[dict] = None, _cluster=None,
         device=None):
    """Start an in-process cluster and attach this driver.

    The head raylet gets ``num_cpus`` CPUs (the host's count by default,
    as the reference), ``num_gpus`` GPUs and ``resources``, and a node
    store of ``object_store_memory`` bytes (``Config.object_store_memory``,
    2 GiB, by default); its batched tick runs on ``device`` (the card
    unless ``"cpu"``).  ``_cluster``
    attaches to the caller's ``LocalCluster`` instead, whose device
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
        if get_config().worker_process_mode != "thread":
            raise NotImplementedError(
                "worker_process_mode="
                f"{get_config().worker_process_mode!r}: the port runs "
                "thread workers only; process workers are not ported")
        if _cluster is not None:
            cluster = _cluster
        else:
            head = dict(resources or {})
            head["CPU"] = float(os.cpu_count() or 1) if num_cpus is None \
                else float(num_cpus)
            if num_gpus:
                head["GPU"] = float(num_gpus)
            cluster = LocalCluster(device=device)
            try:
                cluster.add_node({k: v for k, v in head.items() if v},
                                 node_name="head",
                                 object_store_memory=object_store_memory)
            except BaseException:
                cluster.shutdown()
                raise
        w.cluster = cluster
        w.job_id = JobID.next()
        w.core_worker = CoreWorker(cluster, w.job_id)
        cluster.attach_core_worker(w.core_worker)
        w.connected = True
        atexit.register(_atexit_shutdown)
        return RuntimeContextInfo(w)


def shutdown():
    """Detach the driver and stop the cluster: every worker thread,
    raylet loop, pull and spill thread, and the reference counter's
    release thread."""
    w = global_worker_or_none()
    if w is None or not w.connected:
        return
    with _init_lock:
        core, cluster = w.core_worker, w.cluster
        w.connected = False
        w.cluster = None
        w.core_worker = None
        worker_context.clear_context()
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


def nodes() -> List[dict]:
    w = _require_connected()
    out = []
    for info in w.cluster.nodes():
        entry = dict(info)
        entry["NodeID"] = info["node_id"]
        entry["Alive"] = info["alive"]
        entry["Resources"] = info["resources"]
        out.append(entry)
    return out


def cluster_resources() -> dict:
    return _require_connected().cluster.cluster_resources()


def available_resources() -> dict:
    return _require_connected().cluster.available_resources()
