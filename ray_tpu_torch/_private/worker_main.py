"""A worker process: ``python -m ray_tpu_torch._private.worker_main``.

A port of ``ray_tpu._private.worker_main`` for the PyTorch port
(reference worker processes started by the raylet's pool,
``src/ray/raylet/worker_pool.h:428`` StartWorkerProcess spawning
``default_worker.py``, which registers over the raylet socket and then
serves ``CoreWorkerService.PushTask``, ``core_worker.proto:353``).

Protocol (framed RPC, ``ray_tpu_torch.rpc``):

  1. start an RpcServer on an ephemeral port serving ``push``, ``ping``
     and ``stop``;
  2. install the client runtime (``client_runtime.install``) over a
     connection to its node's host service, so that a task can use the
     whole public API the moment it is pushed, then ``register_worker``
     with (worker_id, port, pid): the handshake the pool's
     ``ProcessWorker`` waits on;
  3. each ``push`` runs one task: inline arguments arrive as serialized
     blobs, object arguments are fetched from the host's chunk server
     (``fetch_meta``: inline up to a chunk, else a session of 5 MiB
     frames; the reference reads them in one ``get_object`` frame),
     functions from the GCS KV (``kv_get``, cached); the serialized
     returns ride back in the reply and the host stores them with owner
     semantics.  A CUDA tensor crosses both ways as its host form
     (ROADMAP C.20, C.37).

An orphan watchdog pings the host every 5 s and exits when it is gone.
The process never imports JAX or ``ray_tpu``.  Left out until their
items: the shared-memory return and argument paths (``_ShmReturnWriter``,
``AttachedSegment``; A.4b.2b) and the tracing drain onto each reply
(A.4b.7a).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import threading
import traceback
from typing import Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import runtime_env as runtime_env_mod
from ray_tpu_torch._private.serialization import (deserialize,
                                                  from_received,
                                                  loads_function, serialize)
from ray_tpu_torch.rpc import RpcClient, RpcServer
from ray_tpu_torch.rpc.chunked import fetch_chunked


class _CtxSpec:
    """The task context a child's ``runtime_context`` reads (the host
    ships these fields of the spec in the push payload)."""

    def __init__(self, payload):
        from ray_tpu_torch.scheduler.resources import ResourceRequest
        self.task_id = payload.get("task_id")
        self.actor_id = payload.get("actor_id")
        self.task_type = payload.get("task_type", "NORMAL_TASK")
        self.resources = ResourceRequest(payload.get("resources") or {})
        lr = payload.get("lifetime_resources")
        self.lifetime_resources = \
            ResourceRequest(lr) if lr is not None else None
        self.depth = payload.get("depth", 0)
        self.function_name = payload.get("function_name", "")
        self.placement_group_id = payload.get("placement_group_id")
        self.placement_group_bundle_index = \
            payload.get("placement_group_bundle_index", -1)

    def is_actor_creation(self) -> bool:
        return self.task_type == "ACTOR_CREATION_TASK"

    def is_actor_task(self) -> bool:
        return self.task_type == "ACTOR_TASK"


class _WorkerRuntime:
    def __init__(self, host: str, port: int, worker_id: str):
        self.worker_id = worker_id
        self.node_client = RpcClient((host, port))
        self.server = RpcServer(name=f"worker-{worker_id[:8]}")
        self.server.register_async("push", self._handle_push)
        self.server.register("ping", lambda _p: "pong")
        self.server.register("stop", self._handle_stop)
        self._fn_cache: Dict[bytes, object] = {}
        self._fn_lock = threading.Lock()
        self.actor_instance = None
        self._sema: Optional[threading.Semaphore] = None
        # Per-concurrency-group bounds (concurrency_group_manager.cc).
        self._group_semas: Dict[str, threading.Semaphore] = {}
        self._stop_event = threading.Event()

    def run(self):
        # The public API first: a task can be pushed the moment the
        # registration lands.
        from ray_tpu_torch._private import client_runtime
        client_runtime.install(self.node_client,
                               client_worker_id=self.worker_id)
        self.node_client.call("register_worker", {
            "worker_id": self.worker_id,
            "port": self.server.address[1],
            "pid": os.getpid(),
        })

        # Orphan watchdog: a host that died without a "stop" takes its
        # workers with it (reference: workers die with their raylet).
        def watchdog():
            while not self._stop_event.is_set():
                try:
                    self.node_client.call("ping", None, timeout=10.0)
                except Exception:
                    self._stop_event.set()
                    return
                self._stop_event.wait(timeout=5.0)

        threading.Thread(target=watchdog, daemon=True,
                         name="ray_tpu_torch::worker::watchdog").start()
        self._stop_event.wait()

    # ---- execution -----------------------------------------------------
    def _handle_stop(self, _payload):
        self._stop_event.set()
        return True

    def _handle_push(self, payload, reply):
        sema = None
        if payload["kind"] == "actor_task":
            group = payload.get("concurrency_group") or ""
            sema = self._group_semas.get(group, self._sema)
        if sema is None:
            reply(self._execute(payload))
            return
        with sema:
            reply(self._execute(payload))

    def _execute(self, payload) -> dict:
        from ray_tpu_torch._private import worker_context
        prev_ctx = worker_context.get_context()
        worker_context.set_context(worker_context.ExecutionContext(
            task_spec=_CtxSpec(payload)))
        try:
            kind = payload["kind"]
            args, kwargs = self._resolve_args(payload["args"])
            if kind == "create_actor":
                cls = self._load_function(payload["function_key"])
                self.actor_instance = cls(*args, **kwargs)
                self._sema = threading.Semaphore(
                    max(1, int(payload.get("max_concurrency", 1))))
                for gname, gsize in (payload.get("concurrency_groups")
                                     or {}).items():
                    self._group_semas[gname] = threading.Semaphore(
                        max(1, int(gsize)))
                return {"error": None, "returns": []}
            if kind == "actor_task":
                if self.actor_instance is None:
                    raise exceptions.RayTpuError("actor not initialized")
                result = getattr(self.actor_instance,
                                 payload["actor_method_name"])(*args,
                                                               **kwargs)
            else:
                result = self._load_function(payload["function_key"])(
                    *args, **kwargs)
            return {"error": None,
                    "returns": self._pack_returns(payload, result)}
        except Exception as e:  # noqa: BLE001 — user errors cross the wire
            err = exceptions.TaskError(
                e, task_desc=f"{payload.get('function_name', '?')}"
                             f"[process-worker]")
            try:
                blob = pickle.dumps(err)
            except Exception:
                blob = pickle.dumps(exceptions.RayTpuError(
                    "".join(traceback.format_exception(e))))
            return {"error": blob, "returns": []}
        finally:
            worker_context.set_context(prev_ctx)

    def _resolve_args(self, packed):
        from ray_tpu_torch._private.executor import _split_args
        flat = []
        for kind, data in packed:
            if kind == "ref":
                blob = fetch_chunked(self.node_client, data, timeout=30.0)
                if blob is None:
                    raise exceptions.ObjectLostError(
                        data.hex(), "arg not available on host node")
                data = blob
            flat.append(deserialize(from_received(data)))
        return _split_args(flat)

    def _pack_returns(self, payload, result):
        num = payload["num_returns"]
        if num == 0:
            return []
        values = [result] if num == 1 else list(result)
        if len(values) != num:
            raise ValueError(
                f"task returned {len(values)} values, expected {num}")
        return [(oid_bin, serialize(value).to_bytes())
                for oid_bin, value in zip(payload["return_ids"], values)]

    def _load_function(self, key: bytes):
        with self._fn_lock:
            fn = self._fn_cache.get(key)
        if fn is None:
            blob = self.node_client.call("kv_get", key, timeout=30.0)
            if blob is None:
                raise KeyError(f"function blob missing for {key!r}")
            fn = loads_function(blob)
            with self._fn_lock:
                self._fn_cache[key] = fn
        return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--worker-id", required=True)
    args = parser.parse_args(argv)
    # The runtime env's working_dir: the spawner materialized it and
    # names it here (reference: a worker starts inside its env's
    # directory).
    cwd = os.environ.get(runtime_env_mod.WORKER_CWD_ENV)
    if cwd:
        os.chdir(cwd)
        sys.path.insert(0, cwd)
    _WorkerRuntime(args.host, args.port, args.worker_id).run()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Exit at once: a task's threads (a train session's, a process
    # group's) must not hold the process after its host let it go.
    os._exit(code)
