"""The public API inside a process worker, proxied through its host.

A port of the in-worker half of ``ray_tpu._private.client_runtime`` for
the PyTorch port (the reference's in-worker CoreWorker: every worker
process runs its own submission client talking to its raylet and the
GCS, ``core_worker.cc`` in non-driver mode).  The child builds real
task specs with the same machinery as the driver and ships them to the
host, whose core worker owns the objects that result: nested
``.remote`` calls, ``put``/``get``/``wait``, actor creation and method
calls, named-actor lookup and ``kill`` all work inside a process worker.

``worker_main`` calls ``install(host_client)`` before it registers, so
user code just calls ``ray_tpu_torch.*``.  A tensor ``put`` or passed
from here crosses as its host form (ROADMAP C.20, C.37).  Left out until
the remote-driver path (A.4b.10): ``init(address=...)``, which installs
the same client in a driver of another process.  Left out until the
tracing plane (A.4b.7a): the submit span stamped onto each spec.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.serialization import (deserialize,
                                                  from_received, serialize)
from ray_tpu_torch._private.task_spec import TaskArg

#: Slack on a host round trip beyond the caller's own deadline.
_RPC_SLACK_S = 30.0


class _ClientKV:
    """The GCS KV slice the function table and the runtime-env
    packaging read and write from a child."""

    def __init__(self, client):
        self._client = client

    def get(self, key: bytes, namespace=None):
        return self._client.call("kv_get", key, timeout=30.0)

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace=None) -> bool:
        return self._client.call(
            "kv_put", {"key": key, "value": value, "overwrite": overwrite},
            timeout=60.0)


class _ClientActorRecord:
    """The slice of ``GcsActor`` that ``actor.py`` reads (the creation
    spec, the class name)."""

    def __init__(self, record: dict):
        self.actor_id = record["actor_id"]
        self.state = record.get("state")
        self.num_restarts = record.get("num_restarts", 0)
        self._info = {"class_name": record.get("class_name", "")}
        self.creation_spec = pickle.loads(record["spec_blob"]) \
            if record.get("spec_blob") else None

    def info(self):
        return dict(self._info)


class _ClientActorManager:
    def __init__(self, client):
        self._client = client

    def get_actor(self, actor_id):
        record = self._client.call("actor_info", {"actor_id": actor_id},
                                   timeout=30.0)
        return None if record is None else _ClientActorRecord(record)

    def get_named_actor(self, name: str, namespace: str = ""):
        record = self._client.call(
            "named_actor_info", {"name": name, "namespace": namespace},
            timeout=30.0)
        return None if record is None else _ClientActorRecord(record)

    def destroy_actor(self, actor_id, no_restart: bool = True):
        self._client.call("kill_actor",
                          {"actor_id": actor_id, "no_restart": no_restart},
                          timeout=30.0)


class _ClientGcs:
    def __init__(self, client):
        self.kv = _ClientKV(client)
        self.actor_manager = _ClientActorManager(client)


class _NodeStub:
    __slots__ = ("node_id",)

    def __init__(self, node_id):
        self.node_id = node_id


class _ClientCluster:
    """The cluster surface the public API touches in a child."""

    def __init__(self, client, info: dict):
        self.gcs = _ClientGcs(client)
        # runtime_context reads head_node.node_id outside a task: from a
        # worker, "here" is its host's node.
        self.head_node = _NodeStub(info.get("node_id"))


class _NullReferenceCounter:
    """Ownership lives on the host, so a child's handles count nothing
    (a deserialized ref registers here, and its destructor releases
    here)."""

    def add_local_ref(self, _oid):
        pass

    def remove_local_ref(self, _oid):
        pass

    def release_local_ref_async(self, _oid):
        pass

    def has_reference(self, _oid) -> bool:
        return True


class ClientCoreWorker:
    """The CoreWorker methods the API layer calls, proxied to the host's
    core worker."""

    def __init__(self, client, info: dict, client_worker_id: str = ""):
        from ray_tpu_torch._private.function_manager import FunctionManager
        self._client = client
        self.job_id = info["job_id"]
        self.worker_id = info["owner_id"]     # ownership stays host-side
        self.client_worker_id = client_worker_id  # pin scope on the host
        self.driver_task_id = TaskID.for_driver(self.job_id)
        self.cluster = _ClientCluster(client, info)
        # The real function table over the client KV.
        self.function_manager = FunctionManager(self.cluster)
        self.reference_counter = _NullReferenceCounter()

    # ---- args and submission ---------------------------------------------
    def build_args(self, flat_args):
        limit = get_config().task_args_inline_bytes_limit
        out: List[TaskArg] = []
        dep_ids = []
        holders: List[ObjectRef] = []
        borrowed = []
        for a in flat_args:
            if isinstance(a, ObjectRef):
                out.append(TaskArg(is_inline=False,
                                   object_id=a.object_id(),
                                   owner_id=a.owner_id()))
                dep_ids.append(a.object_id())
                continue
            s = serialize(a)
            if s.total_bytes > limit:
                ref = self._put_serialized(s)
                holders.append(ref)
                out.append(TaskArg(is_inline=False,
                                   object_id=ref.object_id(),
                                   owner_id=ref.owner_id()))
                dep_ids.append(ref.object_id())
            else:
                borrowed.extend(r.object_id() for r in s.contained_refs)
                out.append(TaskArg(is_inline=True, value=s))
        return out, dep_ids, holders, borrowed

    def _submit(self, verb: str, spec) -> List[ObjectRef]:
        # worker_id scopes the host-side pin of the results to this
        # client (released with it, like a put's pin).
        self._client.call(verb, {"spec": spec,
                                 "worker_id": self.client_worker_id},
                          timeout=60.0)
        return [ObjectRef(oid, owner_id=self.worker_id,
                          skip_adding_local_ref=True)
                for oid in spec.return_ids]

    def submit_task(self, spec, holders=()) -> List[ObjectRef]:
        return self._submit("submit_task", spec)

    def submit_actor_task(self, spec, holders=()) -> List[ObjectRef]:
        return self._submit("submit_actor_task", spec)

    def create_actor(self, creation_spec, name: str = "",
                     namespace: str = "", detached: bool = False):
        self._client.call("create_actor", {
            "spec": creation_spec, "name": name, "namespace": namespace,
            "detached": detached}, timeout=60.0)

    # ---- objects ---------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        return self._put_serialized(serialize(value))

    def _put_serialized(self, serialized) -> ObjectRef:
        reply = self._client.call(
            "put_object", {"blob": serialized.to_bytes(),
                           "worker_id": self.client_worker_id},
            timeout=300.0)
        return ObjectRef(reply["object_id"], owner_id=reply["owner_id"],
                         skip_adding_local_ref=True)

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        """One deadline across all refs (the reference's ``get``), the
        host round trips issued at once."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        futures = [self._client.call_future(
            "get_value", {"object_id": ref.object_id(), "timeout": timeout})
            for ref in refs]
        out = []
        for ref, fut in zip(refs, futures):
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic()) + _RPC_SLACK_S
            try:
                result = fut.result(timeout=remaining)
            except TimeoutError:
                result = None
            if result is None:
                raise exceptions.GetTimeoutError(
                    f"Get timed out for {ref.object_id()}")
            kind, blob = result
            if kind == "error":
                err = pickle.loads(blob)
                if isinstance(err, exceptions.TaskError):
                    raise err.as_instanceof_cause()
                raise err
            if kind == "chunked":
                from ray_tpu_torch.rpc.chunked import fetch_session
                blob = fetch_session(self._client, blob, timeout=600.0)
                if blob is None:
                    raise exceptions.ObjectLostError(
                        ref.object_id(), "chunked client fetch failed")
            out.append(deserialize(from_received(blob)))
        return out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List, List]:
        reply = self._client.call(
            "wait_refs",
            {"object_ids": [r.object_id() for r in refs],
             "num_returns": num_returns, "timeout": timeout},
            timeout=None if timeout is None else timeout + _RPC_SLACK_S)
        by_id = {r.object_id(): r for r in refs}
        return ([by_id[oid] for oid in reply["ready"]],
                [by_id[oid] for oid in reply["not_ready"]])

    def get_async(self, ref: ObjectRef, callback):
        def run():
            try:
                callback(self.get([ref])[0], None)
            except BaseException as e:    # noqa: BLE001
                callback(None, e)

        threading.Thread(target=run, daemon=True,
                         name="ray_tpu_torch::client::get_async").start()


def install(host_client, client_worker_id: str = "") -> ClientCoreWorker:
    """Connect this process's global worker to its host: after this,
    ``ray_tpu_torch.*`` works inside the process worker."""
    info = host_client.call("runtime_info", None, timeout=30.0)
    core = ClientCoreWorker(host_client, info,
                            client_worker_id=client_worker_id)
    w = worker_mod.global_worker()
    w.core_worker = core
    w.cluster = core.cluster
    w.job_id = core.job_id
    w.namespace = info.get("namespace", "")
    w.connected = True
    return core
