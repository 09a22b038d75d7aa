"""DeploymentHandle: Python-side entry to a deployment.

A copy of ``ray_tpu.serve.handle`` for the PyTorch port (reference
``python/ray/serve/handle.py``, ``RayServeHandle``):
``handle.remote(*args)`` routes through the Router and returns an
ObjectRef; ``handle.method_name.remote(...)`` targets a method
(``.options(method_name=...)`` in the reference).  A handle pickles by
its deployment's name and is rebuilt from it where it lands.

``noted`` stands in for the reference's ``swallow.noted`` (its debug
plane, ROADMAP A.4b.7b) across ``ray_tpu_torch.serve``: a failure the
reference notes and goes on from is logged as a warning and counted in
``noted_errors`` by site.
"""

from __future__ import annotations

import collections
import logging

logger = logging.getLogger(__name__)

#: Failures serve went on from, by site (the stand-in for the
#: reference's ``swallow.noted``).
noted_errors: collections.Counter = collections.Counter()


def noted(site: str, exc: BaseException) -> None:
    noted_errors[site] += 1
    logger.warning("serve: %s: %s: %s", site, type(exc).__name__, exc)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method = method_name

    def remote(self, *args, **kwargs):
        return self._handle._router.assign_request(self._method, args,
                                                   kwargs)


def _rebuild_handle(deployment_name: str) -> "DeploymentHandle":
    from ray_tpu_torch import serve
    return serve.get_deployment(deployment_name).get_handle()


class DeploymentHandle:
    def __init__(self, deployment_name: str, router):
        self.deployment_name = deployment_name
        self._router = router

    def __reduce__(self):
        # Handles travel inside task args / deployment init args
        # (pipeline composition); the router is process-local state, so
        # reconstruct from the name on the receiving side (reference
        # RayServeHandle serialization).
        return (_rebuild_handle, (self.deployment_name,))

    def remote(self, *args, **kwargs):
        return self._router.assign_request("__call__", args, kwargs)

    def options(self, method_name: str = "__call__") -> _MethodCaller:
        return _MethodCaller(self, method_name)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_name!r})"
