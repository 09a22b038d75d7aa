"""Public serve API: ``@serve.deployment``, start/run/delete/shutdown.

A copy of ``ray_tpu.serve.api`` for the PyTorch port.  Divergence
(ROADMAP C.31): ``Deployment.deploy`` (and so ``serve.run`` and a
pipeline's HTTP ingress) returns only once a running HTTP proxy's route
table holds the controller's config version of the deploy
(``HTTPProxyActor.route_version``); the reference returns once a replica
runs, and its proxy learns the route later through its long poll, so a
first request can get a 404.

Parity: reference ``python/ray/serve/api.py`` — ``@serve.deployment``
(:1032), ``serve.start`` (:468), ``serve.run`` (:1437),
``get_deployment``/``list_deployments`` (:1569,:1608).  The controller is
a named detached actor; deployment handles route through an in-process
``Router`` kept fresh by the controller's long-poll.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.router import Router

_PROXY_NAME = "SERVE_PROXY_ACTOR"

_controller = None
_proxy = None
# One live Router per deployment per process: handles share it, so
# repeated get_handle() calls don't each spawn a long-poll thread.
_handle_routers: Dict[str, Router] = {}


def start(detached: bool = True, http_options: Optional[dict] = None):
    """Start (or connect to) the serve instance: the controller actor
    plus, unless ``http_options`` is ``{"location": "NoServer"}``, an
    HTTP proxy actor (reference ``serve.start``, ``http_proxy.py``)."""
    global _controller, _proxy
    if _controller is None:
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            _controller = ray_tpu_torch.remote(
                num_cpus=0, name=CONTROLLER_NAME, lifetime="detached",
                max_concurrency=32)(ServeController).remote()
            ray_tpu_torch.get(_controller.list_deployments.remote())
    http_options = dict(http_options or {})
    if http_options.get("location") != "NoServer" and _proxy is None:
        from ray_tpu_torch.serve.http_proxy import HTTPProxyActor
        host = http_options.get("host", "127.0.0.1")
        port = http_options.get("port", 8000)
        try:
            _proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
        except Exception:
            _proxy = ray_tpu_torch.remote(
                num_cpus=0, name=_PROXY_NAME, lifetime="detached",
                max_concurrency=4)(HTTPProxyActor).remote(host, port)
        actual_port = ray_tpu_torch.get(_proxy.ready.remote())
        if port and actual_port != port:
            import warnings
            warnings.warn(
                f"serve HTTP proxy already running on port {actual_port}; "
                f"requested port {port} ignored", RuntimeWarning)
    return _controller


def _running_proxy():
    if _proxy is not None:
        return _proxy
    try:
        return ray_tpu_torch.get_actor(_PROXY_NAME)
    except Exception:
        return None


def _wait_for_proxy_routes(controller, deadline: float) -> None:
    """C.31: block until a running proxy's route table holds the
    controller's present config version (nothing to wait for without a
    proxy)."""
    proxy = _running_proxy()
    if proxy is None:
        return
    version = ray_tpu_torch.get(controller.listen_for_change.remote(-1, 0.0))
    while ray_tpu_torch.get(proxy.route_version.remote()) < version:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"the HTTP proxy never installed route version {version}")
        time.sleep(0.005)


def _get_controller():
    start(http_options={"location": "NoServer"})
    return _controller


class Deployment:
    """A configured (but not necessarily deployed) serve deployment.

    Reference ``python/ray/serve/api.py:786`` (class Deployment)."""

    def __init__(self, func_or_class, name: str,
                 num_replicas: int = 1,
                 init_args: Optional[tuple] = None,
                 init_kwargs: Optional[dict] = None,
                 route_prefix: Optional[str] = "__default__",
                 ray_actor_options: Optional[dict] = None,
                 user_config: Any = None,
                 max_concurrent_queries: int = 100,
                 autoscaling_config: Optional[dict] = None):
        self._func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.init_args = tuple(init_args or ())
        self.init_kwargs = dict(init_kwargs or {})
        if route_prefix == "__default__":
            route_prefix = f"/{name}"
        if route_prefix is not None and not route_prefix.startswith("/"):
            raise ValueError("route_prefix must start with '/'")
        self.route_prefix = route_prefix
        self.ray_actor_options = dict(ray_actor_options or {})
        self.user_config = user_config
        self.max_concurrent_queries = max_concurrent_queries
        self.autoscaling_config = autoscaling_config

    # -- lifecycle ------------------------------------------------------
    def deploy(self, *init_args, **init_kwargs) -> None:
        """Deploy (or redeploy) this deployment (reference
        ``Deployment.deploy``, api.py:888)."""
        controller = _get_controller()
        args = init_args or self.init_args
        kwargs = init_kwargs or self.init_kwargs
        serialized_init = (self._func_or_class, args, kwargs,
                          self.user_config)
        ray_tpu_torch.get(controller.deploy.remote(
            self.name, serialized_init, self.num_replicas,
            self.ray_actor_options, self.max_concurrent_queries,
            self.autoscaling_config, self.route_prefix))
        # Block until at least one replica is running (reference deploy
        # blocks on goal completion).
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            info = ray_tpu_torch.get(
                controller.get_deployment_info.remote(self.name))
            if info and info["num_running_replicas"] > 0:
                _wait_for_proxy_routes(controller,
                                       time.monotonic() + 30.0)
                return
            time.sleep(0.02)
        raise TimeoutError(f"deployment {self.name!r} failed to start")

    def delete(self) -> None:
        controller = _get_controller()
        ray_tpu_torch.get(controller.delete_deployment.remote(self.name))
        _evict_router(self.name)

    def get_handle(self) -> DeploymentHandle:
        controller = _get_controller()
        router = _handle_routers.get(self.name)
        if router is None or router._stopped.is_set():
            router = Router(
                controller, self.name,
                max_concurrent_queries=self.max_concurrent_queries)
            _handle_routers[self.name] = router
        return DeploymentHandle(self.name, router)

    # -- configuration --------------------------------------------------
    def options(self, **kwargs) -> "Deployment":
        """Return a copy with config overrides (api.py:941)."""
        cfg = dict(
            func_or_class=self._func_or_class, name=self.name,
            num_replicas=self.num_replicas, init_args=self.init_args,
            init_kwargs=self.init_kwargs, route_prefix=self.route_prefix,
            ray_actor_options=self.ray_actor_options,
            user_config=self.user_config,
            max_concurrent_queries=self.max_concurrent_queries,
            autoscaling_config=self.autoscaling_config)
        cfg.update(kwargs)
        return Deployment(**cfg)

    def bind(self, *args, **kwargs):
        """Author a deployment-DAG node (reference serve pipeline
        ``.bind``): class deployments yield a ClassNode whose methods
        are further bindable; function deployments yield a call node."""
        import inspect

        from ray_tpu_torch.serve import pipeline
        if inspect.isclass(self._func_or_class):
            return pipeline.ClassNode(self, args, kwargs)
        return pipeline.FunctionNode(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "Deployments cannot be called directly; use "
            "`deployment.deploy()` then `deployment.get_handle()` or HTTP.")

    def __repr__(self):
        return f"Deployment(name={self.name!r})"


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               init_args: Optional[tuple] = None,
               init_kwargs: Optional[dict] = None,
               route_prefix: Optional[str] = "__default__",
               ray_actor_options: Optional[dict] = None,
               user_config: Any = None,
               max_concurrent_queries: int = 100,
               autoscaling_config: Optional[dict] = None):
    """``@serve.deployment`` decorator (reference api.py:1032)."""

    def wrap(func_or_class):
        return Deployment(
            func_or_class, name or func_or_class.__name__,
            num_replicas=num_replicas, init_args=init_args,
            init_kwargs=init_kwargs, route_prefix=route_prefix,
            ray_actor_options=ray_actor_options, user_config=user_config,
            max_concurrent_queries=max_concurrent_queries,
            autoscaling_config=autoscaling_config)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def run(target, host: str = "127.0.0.1", port: int = 8000,
        route_prefix: str = "/"):
    """Deploy ``target`` with an HTTP ingress and return its handle
    (reference ``serve.run``, api.py:1437).  ``target`` may be a
    Deployment or a pipeline DAG node (``Deployment.bind(...)``) — the
    latter builds the whole graph behind the route."""
    from ray_tpu_torch.serve.pipeline import DAGNode, build
    start(http_options={"host": host, "port": port})
    if isinstance(target, DAGNode):
        return build(target, http_route=route_prefix)
    if route_prefix != target.route_prefix:
        target = target.options(route_prefix=route_prefix)
    target.deploy()
    return target.get_handle()


def get_deployment(name: str) -> Deployment:
    """Fetch a live deployment by name (reference api.py:1569)."""
    controller = _get_controller()
    spec = ray_tpu_torch.get(controller.get_deployment_spec.remote(name))
    if spec is None:
        raise KeyError(f"no deployment {name!r}")
    serialized_init, cfg = spec
    func_or_class, init_args, init_kwargs, user_config = serialized_init
    return Deployment(
        func_or_class, name, num_replicas=cfg["num_replicas"],
        init_args=init_args, init_kwargs=init_kwargs,
        route_prefix=cfg["route_prefix"],
        ray_actor_options=cfg["ray_actor_options"],
        user_config=user_config,
        max_concurrent_queries=cfg["max_concurrent_queries"],
        autoscaling_config=cfg["autoscaling_config"])


def list_deployments() -> Dict[str, Deployment]:
    """All live deployments by name (reference api.py:1608)."""
    controller = _get_controller()
    return {name: get_deployment(name)
            for name in ray_tpu_torch.get(controller.list_deployments.remote())}


def _evict_router(name: str) -> None:
    """Stop and drop the cached per-process Router for a deployment so a
    later ``get_handle()`` never reuses a stale replica set or the old
    ``max_concurrent_queries``."""
    router = _handle_routers.pop(name, None)
    if router is not None:
        router.stop()


def delete(name: str) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name))
    _evict_router(name)


def shutdown() -> None:
    """Tear down all deployments, the proxy, and the controller."""
    global _controller, _proxy
    controller, proxy = _controller, _proxy
    _controller = _proxy = None
    for router in _handle_routers.values():
        router.stop()
    _handle_routers.clear()
    if controller is None:
        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            controller = None
    if proxy is None:
        try:
            proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
        except Exception:
            proxy = None
    from ray_tpu_torch.serve.handle import noted
    if proxy is not None:
        try:
            ray_tpu_torch.get(proxy.stop.remote())
            ray_tpu_torch.kill(proxy)
        except Exception as e:
            noted("serve.api.shutdown_proxy", e)
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote())
            ray_tpu_torch.kill(controller)
        except Exception as e:
            noted("serve.api.shutdown_controller", e)
