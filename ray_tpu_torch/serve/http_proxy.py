"""HTTP ingress for serve deployments.

A copy of ``ray_tpu.serve.http_proxy`` for the PyTorch port: a plain
``threading.Lock`` where the reference takes ``diag_lock``, and
``handle.noted`` where it calls ``swallow.noted``.

Divergence (ROADMAP C.31): the proxy reports the controller's config
version its route table holds (``route_version``), and ``deploy`` waits
for it.  The reference installs a route through its long poll after
``deploy`` returned, so a first request right after ``deploy`` can get a
404.  The proxy records a version only once the table it fetched after
reading that version is installed.

Parity: reference ``python/ray/serve/http_proxy.py`` —
``HTTPProxyActor`` (:180) runs an HTTP server per node whose route table
is pushed from the controller via long-poll (:308 route updates); each
request is routed to a replica through a ``Router``.  The reference uses
uvicorn/starlette; here the server is a stdlib ``ThreadingHTTPServer``
living inside the proxy actor, and the request object handed to user
code is a plain :class:`HTTPRequest` (picklable, starlette-free).
"""

from __future__ import annotations

import json
import threading
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

import ray_tpu_torch
from ray_tpu_torch.serve.handle import noted


@dataclass
class HTTPRequest:
    """What a deployment's ``__call__`` receives for an HTTP request."""
    method: str
    path: str                      # path *below* the route prefix
    route_prefix: str
    query_params: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body) if self.body else None


class HTTPProxyActor:
    """Serves HTTP on (host, port); routes by longest matching prefix."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME
        self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        self._routes: Dict[str, str] = {}      # prefix -> deployment name
        self._routers: Dict[str, "Router"] = {}
        self._routes_lock = threading.Lock()
        # The controller's config version the installed table holds.
        self._version = self._refresh_routes(
            ray_tpu_torch.get(self._controller.listen_for_change.remote(
                -1, 0.0)))
        self._stopped = threading.Event()

        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):           # silence stderr spam
                pass

            def _dispatch(self):
                try:
                    status, payload, ctype = proxy._handle(self)
                except Exception:
                    status, payload, ctype = (
                        500, traceback.format_exc().encode(), "text/plain")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_PUT = do_DELETE = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._port = self._server.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serve-http-proxy")
        self._serve_thread.start()
        self._poll_thread = threading.Thread(
            target=self._long_poll_loop, daemon=True,
            name="serve-proxy-longpoll")
        self._poll_thread.start()

    # -- control --------------------------------------------------------
    def ready(self) -> int:
        return self._port

    def route_version(self) -> int:
        """The controller's config version the route table holds (C.31:
        ``deploy`` waits until it reaches the deploy's)."""
        return self._version

    def stop(self) -> bool:
        self._stopped.set()
        self._server.shutdown()
        with self._routes_lock:
            routers, self._routers = list(self._routers.values()), {}
        for router in routers:
            router.stop()
        return True

    # -- route table maintenance ---------------------------------------
    def _refresh_routes(self, version: int) -> int:
        """Install the controller's route table, read after ``version``
        was: the table holds that version (or a later one).  Returns
        ``version``."""
        table = ray_tpu_torch.get(self._controller.get_route_table.remote())
        with self._routes_lock:
            self._routes = table
            # Drop (and stop) routers for deployments that disappeared.
            for name in list(self._routers):
                if name not in table.values():
                    router = self._routers.pop(name, None)
                    if router is not None:
                        router.stop()
        return version

    def _long_poll_loop(self):
        # Retry transient failures with backoff — a single hiccup must not
        # freeze the route table; exit only on stop or controller death.
        from ray_tpu_torch.serve.router import controller_alive
        backoff = 0.05
        while not self._stopped.is_set():
            try:
                version = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._version, 5.0))
                backoff = 0.05
                if version != self._version:
                    self._version = self._refresh_routes(version)
            except Exception as e:
                if self._stopped.is_set() or not controller_alive():
                    return
                noted("serve.http_proxy.long_poll", e)
                self._stopped.wait(backoff)
                backoff = min(backoff * 2, 2.0)

    def _router_for(self, name: str):
        from ray_tpu_torch.serve.router import Router
        with self._routes_lock:
            router = self._routers.get(name)
        if router is None:
            # Honor the deployment's own backpressure limit — the router
            # is what enforces max_concurrent_queries.
            spec = ray_tpu_torch.get(
                self._controller.get_deployment_spec.remote(name))
            mcq = spec[1]["max_concurrent_queries"] if spec else 100
            router = Router(self._controller, name,
                            max_concurrent_queries=mcq)
            with self._routes_lock:
                existing = self._routers.setdefault(name, router)
            if existing is not router:
                router.stop()
                router = existing
        return router

    # -- request path ---------------------------------------------------
    def _match(self, path: str) -> Optional[Tuple[str, str]]:
        with self._routes_lock:
            routes = dict(self._routes)
        best = None
        for prefix, name in routes.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        return best

    def _handle(self, handler) -> Tuple[int, bytes, str]:
        split = urlsplit(handler.path)
        match = self._match(split.path)
        if match is None:
            return 404, b"no deployment for path", "text/plain"
        prefix, name = match
        length = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(length) if length else b""
        request = HTTPRequest(
            method=handler.command,
            path=split.path[len(prefix.rstrip("/")):] or "/",
            route_prefix=prefix,
            query_params=dict(parse_qsl(split.query)),
            headers={k.lower(): v for k, v in handler.headers.items()},
            body=body)
        router = self._router_for(name)
        # Router.call re-assigns on replica death (bounded by
        # serve_request_retries): an HTTP client whose replica is
        # SIGKILLed mid-request gets a survivor's response, or a 500
        # naming the deployment — never a silent hang.
        result = router.call("__call__", (request,), {})
        if isinstance(result, bytes):
            return 200, result, "application/octet-stream"
        if isinstance(result, str):
            return 200, result.encode(), "text/plain"
        return 200, json.dumps(result).encode(), "application/json"
