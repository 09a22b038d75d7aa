"""The host-side surface that process workers call.

A port of ``ray_tpu._private.client_service`` for the PyTorch port
(reference Ray Client, ``src/ray/protobuf/ray_client.proto:300``
``RayletDriver``, and ``python/ray/util/client/server/``): a process
worker drives the cluster through these handlers.  It ships the task
specs it builds, and ownership stays with the host's core worker.  A
big ``get_value`` reply hands back a chunk session instead of one
oversized frame.

A spec built in a worker process carries that process's scheduling
class, an id of its own interning table: the host interns the spec's
shape again (``_host_spec``), so that its raylets queue and solve it
under the host's id for that shape (ROADMAP C.38; the reference keeps
the worker's id).  A ``get_value`` or ``wait_refs`` without a deadline
waits in slices of
a second and gives up when ``stopped()`` turns true, so that no handler
outlives its server's stop (the reference's waits until the object
comes).  Left out until the remote-driver path (ROADMAP A.4b.10): the
head service that serves the same surface to drivers in other
processes.
"""

from __future__ import annotations

import pickle
import time
from typing import Callable, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.serialization import (SerializedObject,
                                                  deserialize, serialize)
from ray_tpu_torch._private.task_spec import scheduling_class_of

#: Longest wait of one slice of a host-side get or wait.
_SLICE_S = 1.0


def _host_spec(spec):
    """``spec`` with this process's scheduling class for its shape."""
    spec.scheduling_class = scheduling_class_of(spec.resources,
                                                spec.scheduling_options)
    return spec


def register_client_surface(server, *, core: Callable, kv: Callable,
                            actor_manager: Callable, node_id_fn: Callable,
                            namespace_fn: Callable, stopped: Callable,
                            chunk_server=None,
                            pin_cb: Optional[Callable] = None):
    """Register the client API on ``server``.  ``core``, ``kv``,
    ``actor_manager``, ``node_id_fn`` and ``namespace_fn`` are
    zero-argument callables (late-bound: the objects behind them can be
    swapped, as a restarted GCS's are).  ``pin_cb(worker_id_hex,
    object_id)`` scopes a put's (and a submission's results') pin to a
    client's life."""

    def runtime_info(_payload) -> dict:
        c = core()
        return {"job_id": c.job_id, "owner_id": c.worker_id,
                "namespace": namespace_fn(), "node_id": node_id_fn()}

    def kv_put(payload) -> bool:
        return kv().put(payload["key"], payload["value"],
                        overwrite=payload.get("overwrite", True))

    def kv_get(key: bytes):
        return kv().get(key)

    def _pin(object_ids, payload):
        """Pin objects for the client: the host-side handles die when the
        handler returns, and the client's interest must not ride on
        their destructors racing the task's completion (a release
        applied after the result lands would delete it under the
        client)."""
        c = core()
        for oid in object_ids:
            c.reference_counter.add_local_ref(oid)
            if pin_cb is not None and payload.get("worker_id"):
                pin_cb(payload["worker_id"], oid)

    def submit_task(payload) -> bool:
        refs = core().submit_task(_host_spec(payload["spec"]))
        _pin([r.object_id() for r in refs], payload)
        return True

    def submit_actor_task(payload) -> bool:
        refs = core().submit_actor_task(_host_spec(payload["spec"]))
        _pin([r.object_id() for r in refs], payload)
        return True

    def create_actor(payload) -> bool:
        core().create_actor(_host_spec(payload["spec"]),
                            name=payload.get("name", ""),
                            namespace=payload.get("namespace", ""),
                            detached=payload.get("detached", False))
        return True

    def _actor_record(actor):
        if actor is None:
            return None
        return {"actor_id": actor.actor_id,
                "class_name": actor.info().get("class_name", ""),
                "state": actor.state,
                "num_restarts": actor.num_restarts,
                "spec_blob": pickle.dumps(actor.creation_spec, protocol=5)}

    def actor_info(payload):
        return _actor_record(actor_manager().get_actor(payload["actor_id"]))

    def named_actor_info(payload):
        return _actor_record(actor_manager().get_named_actor(
            payload["name"], payload.get("namespace", "")))

    def kill_actor(payload) -> bool:
        actor_manager().destroy_actor(
            payload["actor_id"], no_restart=payload.get("no_restart", True))
        return True

    def put_object(payload):
        value = deserialize(SerializedObject.from_bytes(payload["blob"]))
        ref = core().put(value)
        _pin([ref.object_id()], payload)
        return {"object_id": ref.object_id(), "owner_id": ref.owner_id()}

    def _slices(timeout):
        """The timeouts of successive waits: slices of ``_SLICE_S`` that
        end at the deadline (never, for None) or at the server's stop."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            yield _SLICE_S if left is None else min(left, _SLICE_S)
            if stopped() or (left is not None and left <= _SLICE_S):
                return

    def get_value(payload):
        ref = ObjectRef(payload["object_id"], skip_adding_local_ref=True)
        try:
            for t in _slices(payload.get("timeout")):
                try:
                    value = core().get([ref], timeout=t)[0]
                    break
                except exceptions.GetTimeoutError:
                    continue
            else:
                return None
        except Exception as e:   # noqa: BLE001 — the user's error ships
            try:
                return ("error", pickle.dumps(e))
            except Exception:
                return ("error", pickle.dumps(
                    exceptions.RayTpuError(str(e))))
        # A CUDA tensor crosses as its host form (ROADMAP C.20, C.37).
        blob = serialize(value).to_bytes()
        if chunk_server is not None and \
                len(blob) > get_config().object_manager_chunk_size:
            meta = chunk_server.open_session(blob)
            if meta is not None:
                return ("chunked", meta)
        return ("ok", blob)

    def wait_refs(payload):
        refs = [ObjectRef(oid, skip_adding_local_ref=True)
                for oid in payload["object_ids"]]
        num = payload.get("num_returns", 1)
        for t in _slices(payload.get("timeout")):
            ready, rest = core().wait(refs, num_returns=num, timeout=t)
            if len(ready) >= num:
                break
        return {"ready": [r.object_id() for r in ready],
                "not_ready": [r.object_id() for r in rest]}

    for name, fn in (("runtime_info", runtime_info), ("kv_put", kv_put),
                     ("kv_get", kv_get), ("submit_task", submit_task),
                     ("submit_actor_task", submit_actor_task),
                     ("create_actor", create_actor),
                     ("actor_info", actor_info),
                     ("named_actor_info", named_actor_info),
                     ("kill_actor", kill_actor),
                     ("put_object", put_object), ("get_value", get_value),
                     ("wait_refs", wait_refs)):
        server.register(name, fn)
