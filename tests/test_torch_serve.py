"""The port's Serve (``ray_tpu_torch.serve``) against the JAX package's, on
the CPU: deployments, handles, HTTP, batching, pipelines and the batch
queue.

Each case of ``tests/test_serve.py``'s ``TestDeployAndHandle``,
``TestHTTP``, ``TestBatching``, ``TestDeploymentPipeline``,
``TestBatchQueueEdgeCases``, ``TestZeroCopyServe`` and
``TestRelayColdStartWeights`` (its chunks slowed by each package's
transfer writer, not by a fault point) runs the same user
code once under each package's ``init`` (the port's with
``device="cpu"``) and ``serve.start`` with the HTTP proxy on loopback,
and the outcomes must be equal: values, HTTP status and body, the
router's stats, or the error's type and message.  The JAX side of each
HTTP case waits until its proxy holds the route: its ``deploy`` returns
before the proxy learns it (ROADMAP C.31), which the port's does not,
pinned below by a test that requests the route the moment ``deploy``
returns, many times over.  ROADMAP C.30 (a failed placement solve is
counted and raised, not placed by DEFAULT) is pinned with both packages'
outcomes.  The transformer served by the port's replicas at a small size
is held to ``forward`` (``profile_serve.serve_model``, S1's function).
The autoscaler, rolling updates, health checks, replica deaths, the
kernel placement and the soak are in ``tests/test_torch_serve_scaling.py``.
``TestServeRequestFaultPoint`` needs the fault points (ROADMAP
A.4b.7b).  A test checks that the new packages import neither JAX nor the
JAX package, and the last that no thread of the port outlives
``shutdown``.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.serve
from torch_cluster_util import PORT, outcome, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.serve
    import ray_tpu.serve.http_proxy
except ImportError:
    ray_tpu = None

# The JAX package's live HTTP proxies (its actors are threads of this
# process), recorded so that its HTTP cases can wait for their routes.
_JAX_PROXIES = []


@pytest.fixture(autouse=True)
def _record_jax_proxies(monkeypatch):
    if ray_tpu is None:
        return
    cls = ray_tpu.serve.http_proxy.HTTPProxyActor
    orig = cls.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        _JAX_PROXIES.append(self)
    monkeypatch.setattr(cls, "__init__", init)
    _JAX_PROXIES.clear()


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.serve = importlib.import_module(f"{name}.serve")
        self.batching = importlib.import_module(f"{name}.serve.batching")
        self.pipeline = importlib.import_module(f"{name}.serve.pipeline")
        self.config = importlib.import_module(f"{name}._private.config")

    def port(self):
        proxy = self.pkg.get_actor("SERVE_PROXY_ACTOR")
        return self.pkg.get(proxy.ready.remote())

    def await_route(self, path):
        """The JAX package: until its proxy routes ``path`` (C.31); the
        port's ``deploy`` already waited."""
        if self.name != PORT:
            wait_until(lambda: any(p._match(path) for p in _JAX_PROXIES),
                       timeout=10, what=f"the route of {path}")

    def controller(self):
        return self.serve.api._get_controller()


def http(port, path, data=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="POST" if data else "GET",
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, None


def run(name, case, *args, http_options=None):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=12, **kw)
    try:
        p.serve.start(http_options=http_options or {"host": "127.0.0.1",
                                                    "port": 0})
        try:
            return outcome(lambda: case(p, *args))
        finally:
            p.serve.shutdown()
    finally:
        p.pkg.shutdown()


def both(case, *args, **kwargs):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, *args, **kwargs) for name in ("ray_tpu", PORT)]


def both_off_runtime(case, *args):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [outcome(lambda: case(Pkg(name), *args))
            for name in ("ray_tpu", PORT)]


# -- TestDeployAndHandle --------------------------------------------------------

def case_function_deployment_handle(p):
    serve = p.serve

    @serve.deployment
    def double(req):
        return req * 2

    double.deploy()
    h = double.get_handle()
    return p.pkg.get(h.remote(21)), "double" in serve.list_deployments()


def case_class_deployment_methods(p):
    serve = p.serve

    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.x = start

        def __call__(self, req):
            return ("call", req)

        def add(self, n):
            return self.x + n

    Counter.deploy(10)
    h = Counter.get_handle()
    info = p.pkg.get(p.controller().get_deployment_info.remote("Counter"))
    return (p.pkg.get(h.remote("hi")), p.pkg.get(h.add.remote(5)),
            info["num_running_replicas"], info["version"])


def case_redeploy_new_version(p):
    serve = p.serve

    @serve.deployment
    def v(req):
        return "v1"

    v.deploy()
    first = p.pkg.get(v.get_handle().remote(None))

    @serve.deployment(name="v")
    def v2(req):
        return "v2"

    v2.deploy()
    time.sleep(0.3)  # the long poll pushes the new replica set
    h2 = serve.get_deployment("v").get_handle()
    info = p.pkg.get(p.controller().get_deployment_info.remote("v"))
    return first, p.pkg.get(h2.remote(None)), info["version"]


def case_route_prefix_collision_rejected(p):
    serve = p.serve

    @serve.deployment(name="a", route_prefix="/shared")
    def a(req):
        return 1

    @serve.deployment(name="b", route_prefix="/shared")
    def b(req):
        return 2

    a.deploy()
    return outcome(b.deploy), sorted(serve.list_deployments())


def case_delete_deployment(p):
    serve = p.serve

    @serve.deployment
    def gone(req):
        return 1

    gone.deploy()
    before = "gone" in serve.list_deployments()
    serve.delete("gone")
    return before, "gone" in serve.list_deployments(), outcome(
        lambda: serve.get_deployment("gone"))


# -- TestHTTP -------------------------------------------------------------------

def case_http_json_roundtrip(p):
    serve = p.serve

    @serve.deployment
    def echo(request):
        return {"got": request.json(), "path": request.path,
                "method": request.method}

    echo.deploy()
    p.await_route("/echo")
    status, body = http(p.port(), "/echo", json.dumps({"x": 1}).encode())
    return status, json.loads(body)


def case_http_query_params_and_subpath(p):
    serve = p.serve

    @serve.deployment(route_prefix="/api")
    def api(request):
        return {"q": request.query_params, "path": request.path}

    api.deploy()
    p.await_route("/api/users")
    status, body = http(p.port(), "/api/users?id=7")
    return status, json.loads(body)


def case_http_404(p):
    return http(p.port(), "/nothing-here")


def case_http_500_on_user_error(p):
    serve = p.serve

    @serve.deployment
    def boom(request):
        raise ValueError("kapow")

    boom.deploy()
    p.await_route("/boom")
    status, _ = http(p.port(), "/boom")
    return status


def case_http_bodies(p):
    """Bytes, text and JSON replies, and the longest prefix winning."""
    serve = p.serve

    @serve.deployment(route_prefix="/m")
    def short(request):
        return b"\x00raw"

    @serve.deployment(route_prefix="/m/long")
    def long_(request):
        return "text:" + request.path

    short.deploy()
    long_.deploy()
    p.await_route("/m")
    p.await_route("/m/long")
    port = p.port()
    return [http(port, path) for path in ("/m", "/m/x", "/m/long",
                                          "/m/long/y", "/mm")]


# -- TestBatching ---------------------------------------------------------------

def case_batch_collects_concurrent_requests(p):
    serve = p.serve

    @serve.deployment(max_concurrent_queries=16)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def __call__(self, requests):
            self.sizes.append(len(requests))
            return [r * 10 for r in requests]

        def get_sizes(self):
            return self.sizes

    Batched.deploy()
    h = Batched.get_handle()
    refs = [h.remote(i) for i in range(8)]
    values = sorted(p.pkg.get(refs))
    sizes = p.pkg.get(h.get_sizes.remote())
    router = p.serve.api._handle_routers["Batched"]
    return values, max(sizes) > 1, sum(sizes), router.stats["requests"]


# -- TestDeploymentPipeline -----------------------------------------------------

def case_ensemble_dag(p):
    serve, pipeline = p.serve, p.pipeline

    @serve.deployment
    class Model:
        def __init__(self, weight):
            self.weight = weight

        def forward(self, x):
            return x * self.weight

    @serve.deployment
    def ensemble(a, b):
        return a + b

    with pipeline.InputNode() as inp:
        m1 = Model.bind(2)
        m2 = Model.bind(3)
        dag = ensemble.bind(m1.forward.bind(inp), m2.forward.bind(inp))
    handle = pipeline.build(dag)
    return (p.pkg.get(handle.remote(10), timeout=60),
            p.pkg.get(handle.remote(1), timeout=60),
            sorted(d.name for d in handle.deployments))


def case_chained_methods_and_input_index(p):
    serve, pipeline = p.serve, p.pipeline

    @serve.deployment
    class Adder:
        def __init__(self, k):
            self.k = k

        def add(self, x):
            return x + self.k

    with pipeline.InputNode() as inp:
        a = Adder.bind(100)
        dag = a.add.bind(a.add.bind(inp[0]))
    handle = pipeline.build(dag)
    return p.pkg.get(handle.remote((5, "junk")), timeout=60)


def case_composition_and_rebuild_safety(p):
    serve, pipeline, pkg = p.serve, p.pipeline, p.pkg

    @serve.deployment
    class Inner:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    @serve.deployment
    class Outer:
        def __init__(self, inner_handle):
            self.inner = inner_handle

        def run(self, x):
            return pkg.get(self.inner.mul.remote(x)) + 1

    with pipeline.InputNode() as inp:
        inner = Inner.bind(10)
        dag1 = Outer.bind(inner).run.bind(inp)
    h1 = pipeline.build(dag1)
    first = pkg.get(h1.remote(4), timeout=60)
    with pipeline.InputNode() as inp2:
        dag2 = inner.mul.bind(inp2)
    h2 = pipeline.build(dag2)
    return first, pkg.get(h2.remote(5), timeout=60), \
        pkg.get(h1.remote(4), timeout=60)


def case_http_ingress_for_pipeline(p):
    serve, pipeline = p.serve, p.pipeline

    @serve.deployment
    class Doubler:
        def __init__(self):
            pass

        def run(self, x):
            return x * 2

    @serve.deployment
    def plus_one(x):
        return x + 1

    with pipeline.InputNode() as inp:
        dag = plus_one.bind(Doubler.bind().run.bind(inp))
    handle = pipeline.build(dag, http_route="/pipe")
    direct = p.pkg.get(handle.remote(20), timeout=60)
    p.await_route("/pipe")
    status, body = http(p.port(), "/pipe", json.dumps(5).encode())
    return handle.ingress is not None, direct, status, json.loads(body)


CASES = [case_function_deployment_handle, case_class_deployment_methods,
         case_redeploy_new_version, case_route_prefix_collision_rejected,
         case_delete_deployment, case_http_json_roundtrip,
         case_http_query_params_and_subpath, case_http_404,
         case_http_500_on_user_error, case_http_bodies,
         case_batch_collects_concurrent_requests, case_ensemble_dag,
         case_chained_methods_and_input_index,
         case_composition_and_rebuild_safety,
         case_http_ingress_for_pipeline]

EXPECTED = {
    "case_function_deployment_handle": (42, True),
    "case_class_deployment_methods": (("call", "hi"), 15, 2, 0),
    "case_redeploy_new_version": ("v1", "v2", 1),
    "case_delete_deployment": (True, False,
                               ("raise", "KeyError", "\"no deployment 'gone'\"")),
    "case_http_json_roundtrip": (200, {"got": {"x": 1}, "path": "/",
                                       "method": "POST"}),
    "case_http_query_params_and_subpath": (200, {"q": {"id": "7"},
                                                 "path": "/users"}),
    "case_http_404": (404, None),
    "case_http_500_on_user_error": 500,
    "case_batch_collects_concurrent_requests": (
        [i * 10 for i in range(8)], True, 8, 9),
    "case_ensemble_dag": (50, 5, ["Model", "Model_1", "ensemble"]),
    "case_chained_methods_and_input_index": 205,
    "case_composition_and_rebuild_safety": (41, 50, 41),
    "case_http_ingress_for_pipeline": (True, 41, 200, 11),
}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_serve_case_matches_jax(case):
    want, got = both(case)
    assert got == want
    assert got[0] == "value", got
    if case.__name__ in EXPECTED:
        assert got[1] == EXPECTED[case.__name__]


def test_route_prefix_collision_is_the_same_error():
    want, got = both(case_route_prefix_collision_rejected)
    assert got == want
    (kind, cls, message), names = got[1]
    assert (kind, cls, names) == ("raise", "ValueError", ["a"])
    assert "route_prefix" in message


# -- TestBatchQueueEdgeCases ----------------------------------------------------

def case_full_flush_cancels_stale_timer(p):
    def fn(xs):
        return [x * 2 for x in xs]

    q = p.batching._BatchQueue(fn, max_batch_size=2,
                               batch_wait_timeout_s=0.5)
    results = []
    threads = [threading.Thread(
        target=lambda i=i: results.append(q.submit(None, i)), daemon=True)
        for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
    full = q.stats["full_flushes"]
    time.sleep(0.3)
    started = time.monotonic()
    lone = q.submit(None, 10)
    waited_own_window = time.monotonic() - started >= 0.4
    return sorted(results), full, lone, waited_own_window, \
        q.stats["timer_flushes"]


def case_exception_element_fails_only_that_caller(p):
    def fn(xs):
        return [ValueError(f"bad {x}") if x == 1 else x * 10 for x in xs]

    q = p.batching._BatchQueue(fn, max_batch_size=3,
                               batch_wait_timeout_s=5.0)
    out = {}

    def call(i):
        try:
            out[i] = ("ok", q.submit(None, i))
        except Exception as e:  # noqa: BLE001
            out[i] = ("err", type(e).__name__, str(e))

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return out, q.stats["errors"]


def case_batch_wide_exception_fails_every_caller(p):
    def fn(xs):
        raise RuntimeError("whole batch down")

    q = p.batching._BatchQueue(fn, max_batch_size=2,
                               batch_wait_timeout_s=5.0)
    out = {}

    def call(i):
        try:
            out[i] = ("ok", q.submit(None, i))
        except Exception as e:  # noqa: BLE001
            out[i] = ("err", str(e))

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return out, q.stats["errors"]


def case_close_fails_pending_requests(p):
    def fn(xs):
        return xs

    q = p.batching._BatchQueue(fn, max_batch_size=10,
                               batch_wait_timeout_s=30.0)
    out = {}

    def call():
        try:
            out["r"] = ("ok", q.submit(None, 1))
        except Exception as e:  # noqa: BLE001
            out["r"] = ("err", type(e).__name__)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not q.stats["requests"] and time.monotonic() < deadline:
        time.sleep(0.01)
    q.close()
    t.join(timeout=5)
    return out, outcome(lambda: q.submit(None, 2))


def case_adaptive_budget_tracks_exec_latency(p):
    def fn(xs):
        time.sleep(0.05)
        return xs

    q = p.batching._BatchQueue(fn, max_batch_size=8,
                               batch_wait_timeout_s=9.9,
                               latency_budget_s=0.2)
    first_delay = q._flush_delay()
    value = q.submit(None, 1)
    return (abs(first_delay - 0.2) < 1e-6, value, q.stats["timer_flushes"],
            q._exec_ewma > 0.0, 0.0005 <= q._flush_delay() < 0.2)


def case_function_and_method_queues(p):
    """``@serve.batch`` on a bare function and on two instances'
    methods: one queue per function, one per instance."""
    batch = p.batching.batch

    @batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    def plus(xs):
        return [x + 1 for x in xs]

    class Holder:
        def __init__(self, k):
            self.k = k

        @batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def times(self, xs):
            return [x * self.k for x in xs]

    a, b = Holder(2), Holder(3)
    out = [plus(1), a.times(5), b.times(5)]
    queues = [sorted(h.__dict__[p.batching._INSTANCE_ATTR]) for h in (a, b)]
    p.batching.close_instance_queues(a)
    return out, queues, outcome(lambda: a.times(1)), b.times(2)


BATCH_QUEUE_CASES = [case_full_flush_cancels_stale_timer,
                     case_exception_element_fails_only_that_caller,
                     case_batch_wide_exception_fails_every_caller,
                     case_close_fails_pending_requests,
                     case_adaptive_budget_tracks_exec_latency,
                     case_function_and_method_queues]


@pytest.mark.parametrize("case", BATCH_QUEUE_CASES, ids=lambda c: c.__name__)
def test_batch_queue_matches_jax(case):
    want, got = both_off_runtime(case)
    assert got == want and got[0] == "value", (want, got)
    if case is case_full_flush_cancels_stale_timer:
        assert got[1] == ([0, 2], 1, 20, True, 1)
    if case is case_close_fails_pending_requests:
        assert got[1][0] == {"r": ("err", "RuntimeError")}
        assert got[1][1][:2] == ("raise", "RuntimeError")


# -- TestZeroCopyServe ----------------------------------------------------------

def case_pipeline_input_single_put(p, monkeypatch):
    serve, pipeline = p.serve, p.pipeline
    serialization = importlib.import_module(
        f"{p.name}._private.serialization")

    @serve.deployment
    class Head:
        def __init__(self, tag):
            self.tag = tag

        def run(self, x):
            return int(x[0]) + int(x[-1]) + self.tag

    @serve.deployment
    def join(a, b):
        return a + b

    with pipeline.InputNode() as inp:
        dag = join.bind(Head.bind(1).run.bind(inp),
                        Head.bind(2).run.bind(inp))
    handle = pipeline.build(dag)
    arr = np.ones(1024 * 1024, dtype=np.uint8)
    warm = p.pkg.get(handle.remote(np.ones(8, dtype=np.uint8)), timeout=60)

    def boom(self):
        raise AssertionError("SerializedObject.to_bytes() called on the "
                             "zero-copy pipeline path")
    with monkeypatch.context() as m:
        m.setattr(serialization.SerializedObject, "to_bytes", boom)
        before = serialization.copy_stats["bytes_copied"]
        value = p.pkg.get(handle.remote(arr), timeout=60)
        copied = serialization.copy_stats["bytes_copied"] - before
    return warm, value, copied <= arr.nbytes + 256 * 1024


def test_pipeline_input_single_put_matches_jax(monkeypatch):
    want, got = both(case_pipeline_input_single_put, monkeypatch)
    assert got == want == ("value", (7, 7, True))


# -- TestRelayColdStartWeights ---------------------------------------------------

def case_replica_weights_fetch_via_relay_chain(name, monkeypatch):
    """Three replicas start cold on three nodes and pull the weights
    object as a relay chain: the origin serves about one copy.  The
    reference test slows the chunks with its ``transfer.chunk`` fault
    point; here each package's transfer writer sleeps 20 ms a chunk
    (``test_torch_object_plane._slow_writers``), on the receiving side,
    as that delay does."""
    from test_torch_object_plane import MB, _Env, _slow_writers
    env = _Env(name, head_cpus=0, native=True)
    serve = importlib.import_module(f"{name}.serve")
    try:
        cfg = env.config()
        monkeypatch.setattr(cfg, "object_transfer_max_outbound_sessions", 1)
        monkeypatch.setattr(cfg, "object_manager_chunk_size", 256 * 1024)
        workers = [env.add_node(2, object_store_memory=64 * MB)
                   for _ in range(3)]
        serve.start(http_options={"location": "NoServer"})
        weights = np.arange(4 * MB, dtype=np.uint8) % 251
        ref = env.pkg.put(weights)
        oid = ref.object_id()
        head = env.head
        size = head.object_store.get(oid).size
        origin_before = head.object_store.stats["outbound_served_bytes"]

        @serve.deployment(name="model", num_replicas=3,
                          ray_actor_options={"num_cpus": 2})
        class Model:
            def __init__(self, w):
                assert isinstance(w, np.ndarray)
                self.checksum = int(w[:1024].sum())

            def __call__(self, req):
                return self.checksum

        with monkeypatch.context() as m:
            _slow_writers(m, name)
            Model.deploy(ref)
        h = Model.get_handle()
        value = env.pkg.get(h.remote(None), timeout=60)
        origin = head.object_store.stats["outbound_served_bytes"] - \
            origin_before
        relayed = sum(n.object_store.stats["relay_served_bytes"]
                      for n in workers)
        relay_pulls = sum(n.object_manager.stats["relay_pulls"]
                          for n in workers)
        return (value == int(weights[:1024].sum()), 0 < origin <= 2 * size,
                relayed > 0 and relay_pulls >= 1)
    finally:
        try:
            serve.shutdown()
        finally:
            env.shutdown()


def test_replica_weights_fetch_via_relay_chain_matches_jax(monkeypatch):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    want, got = [outcome(lambda n=name: case_replica_weights_fetch_via_relay_chain(
        n, monkeypatch)) for name in ("ray_tpu", PORT)]
    assert got == want == ("value", (True, True, True))


# -- the transformer served -----------------------------------------------------

def test_model_deployment_matches_forward():
    """S1's function at a small size on the CPU: two replicas placed by
    the pack solve, the weights as device objects with no host copy,
    half the requests over HTTP, each reply equal to ``forward`` on its
    batch's tokens."""
    import torch

    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.tools import profile_serve
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_layers=2,
                            n_heads=4, d_ff=256, max_seq_len=64,
                            dtype=torch.float32)
    out = profile_serve.serve_model("cpu", cfg=cfg, seq=32)
    assert out["kernel_placements"] == 2 and out["replicas_on_head"] == 2
    assert out["weights_host_bytes"] == 0
    assert out["max_abs_err"] == 0.0 and out["argmax_mismatched"] == 0
    assert out["launches"]["pack_solves"] == 1


# -- divergences C.30 and C.31 ---------------------------------------------------

def case_kernel_error_in_placement(p, monkeypatch):
    serve = p.serve
    rds = importlib.import_module(
        f"{p.name}.autoscaler.resource_demand_scheduler")
    cfg = p.config.get_config()

    def lost(*args, **kwargs):
        raise RuntimeError("device lost")

    @serve.deployment(name="placed", num_replicas=2)
    def placed(req):
        return req

    with monkeypatch.context() as m:
        m.setattr(cfg, "serve_kernel_placement", "force")
        m.setattr(rds, "_pack_mode_solve", lost)
        deployed = outcome(placed.deploy)
        stats = p.pkg.get(p.controller().get_autoscaler_stats.remote())
        info = p.pkg.get(
            p.controller().get_deployment_info.remote("placed"))
        p.serve.delete("placed")
    errors = stats.get("kernel_errors", stats.get("kernel_fallbacks"))
    return deployed, errors >= 1, stats["kernel_placements"], \
        info["num_running_replicas"]


def test_placement_solve_error_raises_in_the_port(monkeypatch):
    """C.30: a device or kernel error of ``_kernel_place``'s solve is
    counted and raised to the deploy; the reference notes it and places
    both replicas by DEFAULT."""
    want, got = both(case_kernel_error_in_placement, monkeypatch)
    assert want == ("value", (("value", None), True, 0, 2))
    assert got == ("value", (("raise", "RuntimeError", "device lost"),
                             True, 0, 0))


def case_first_request_after_deploy(p, rounds):
    serve = p.serve
    port = p.port()
    statuses = []
    for i in range(rounds):
        @serve.deployment(name=f"r{i}", route_prefix=f"/r{i}")
        def r(request):
            return "ok"
        r.deploy()
        statuses.append(http(port, f"/r{i}")[0])
        serve.delete(f"r{i}")
    return statuses


def test_first_request_after_deploy_is_routed_in_the_port():
    """C.31: the port's ``deploy`` returns once the proxy holds the
    route, so a request made the moment it returns is served, every
    time; the reference's proxy may not know the route yet (a 404)."""
    rounds = 15
    want, got = both(case_first_request_after_deploy, rounds)
    assert got == ("value", [200] * rounds)
    assert want[0] == "value" and set(want[1]) <= {200, 404}, want


def test_serve_and_tune_import_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.tune\n"
        "for m in ('api', 'batching', 'controller', 'handle', 'http_proxy',"
        " 'pipeline', 'replica', 'router'):\n"
        "    __import__('ray_tpu_torch.serve.' + m)\n"
        "for m in ('analysis', 'sample', 'schedulers', 'suggest',"
        " 'trainable', 'trial', 'trial_runner', 'tune'):\n"
        "    __import__('ray_tpu_torch.tune.' + m)\n"
        "import ray_tpu_torch.ml.tuner, ray_tpu_torch.tools.profile_serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
