"""Replica actor: wraps the user's deployment callable.

A copy of ``ray_tpu.serve.replica`` for the PyTorch port: a plain
``threading.Lock`` where the reference takes ``diag_lock``, and
``handle.noted`` where it calls ``swallow.noted``.  A CUDA tensor
deployed as weights (an ``ObjectRef`` init argument) arrives as the
port's device object: on the object's node with no host copy, from
another node as its host form (ROADMAP C.19, C.20).

Parity: reference ``python/ray/serve/replica.py`` — ``RayServeReplica``
wraps the user class/function, counts in-flight requests (the router's
backpressure signal), runs reconfigure, reports health.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

import ray_tpu_torch


class ReplicaActor:
    def __init__(self, serialized_init, deployment_name: str = ""):
        deployment_def, init_args, init_kwargs, user_config = serialized_init
        # ObjectRef init args materialize HERE, in the replica (cold
        # start): model weights deploy as `Model.deploy(weights_ref)`
        # and each replica pulls the object through the data plane —
        # N replicas starting concurrently on different nodes form a
        # relay chain (transfer.relay), so the origin serves ~one copy
        # instead of N head pulls.
        from ray_tpu_torch._private.object_ref import ObjectRef
        init_args = tuple(ray_tpu_torch.get(a) if isinstance(a, ObjectRef)
                          else a for a in (init_args or ()))
        init_kwargs = {k: ray_tpu_torch.get(v) if isinstance(v, ObjectRef)
                       else v for k, v in (init_kwargs or {}).items()}
        if isinstance(deployment_def, type):
            self._callable = deployment_def(*init_args, **(init_kwargs or {}))
        else:
            self._callable = deployment_def
        self._is_function = not isinstance(deployment_def, type)
        self._deployment = deployment_name
        self._inflight = 0
        self._lock = threading.Lock()
        self.num_requests = 0
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def handle_request(self, method_name: str, args, kwargs) -> Any:
        with self._lock:
            self._inflight += 1
            self.num_requests += 1
        started = time.monotonic()
        try:
            if self._is_function:
                target = self._callable
            elif method_name in ("__call__", "", None):
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            # ObjectRef args resolve before the user callable sees them
            # (reference serve handle semantics; the pipeline DAG wires
            # upstream deployment outputs through as refs — the
            # zero-copy object-id handoff: the payload materializes
            # HERE, straight off the data plane, never in the router).
            from ray_tpu_torch._private.object_ref import ObjectRef
            args = [ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a
                    for a in args]
            kwargs = {k: ray_tpu_torch.get(v) if isinstance(v, ObjectRef)
                      else v for k, v in (kwargs or {}).items()}
            # Label @serve.batch flush metrics with this deployment for
            # the duration of the user call (thread-local).
            from ray_tpu_torch.serve import batching
            batching.set_batch_context(self._deployment or None)
            try:
                return target(*args, **kwargs)
            finally:
                batching.set_batch_context(None)
        finally:
            with self._lock:
                self._inflight -= 1
            try:
                from ray_tpu_torch._private.metrics_agent import observe_internal
                observe_internal(
                    "ray_tpu_serve_request_seconds",
                    time.monotonic() - started,
                    deployment=self._deployment or "?",
                    method=method_name or "__call__")
            except Exception as e:
                from ray_tpu_torch.serve.handle import noted
                noted("serve.replica.metrics", e)

    def get_num_inflight(self) -> int:
        return self._inflight

    def get_metrics(self) -> Dict[str, float]:
        return {"num_requests": self.num_requests,
                "inflight": self._inflight}

    def prepare_shutdown(self) -> bool:
        """Best-effort teardown ahead of the controller's kill: fail any
        requests still parked in @serve.batch queues instead of leaving
        their callers to time out."""
        from ray_tpu_torch.serve import batching
        try:
            if not self._is_function:
                batching.close_instance_queues(self._callable)
        except Exception as e:
            from ray_tpu_torch.serve.handle import noted
            noted("serve.replica.prepare_shutdown", e)
        return True

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True
