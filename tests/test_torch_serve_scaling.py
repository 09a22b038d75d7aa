"""The port's Serve under load and faults against the JAX package's, on
the CPU: the queue-depth autoscaler, rolling updates, health checks, a
replica killed under HTTP load, the kernel-placed scale-up and the mini
soak.

Each case of ``tests/test_serve.py``'s ``TestAutoscaling``,
``TestRollingUpdate``, ``TestChaosReplicaDeath``,
``TestAutoscalingKernelPlacement`` and ``TestServeSoakMini`` runs the
same user code once under each package's ``init`` (the port's with
``device="cpu"``, its placement solve on the CPU) and ``serve.start``,
and the outcomes must be equal: every request's value, the replica
counts after each scale (the peak reaching the step, the floor after
it), the autoscaler's counters that the case decides (a scale-up, a
scale-down, kernel placements), the series at ``/metrics``.  How long a
scale takes is timing, so the cases compare what the reference test
asserts, not the replica count at a given instant.  The last test checks
that no thread of the port outlives ``shutdown``.
"""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
import ray_tpu_torch.serve
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.serve
except ImportError:
    ray_tpu = None


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.serve = importlib.import_module(f"{name}.serve")
        self.config = importlib.import_module(f"{name}._private.config")
        self.metrics = importlib.import_module(
            f"{name}._private.metrics_agent")

    def controller(self):
        return self.pkg.get_actor("SERVE_CONTROLLER_ACTOR")

    def info(self, name):
        return self.pkg.get(self.controller().get_deployment_info.remote(name))

    def port(self):
        proxy = self.pkg.get_actor("SERVE_PROXY_ACTOR")
        return self.pkg.get(proxy.ready.remote())


def run(name, case):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=12, **kw)
    try:
        p.serve.start(http_options={"host": "127.0.0.1", "port": 0})
        try:
            return outcome(lambda: case(p))
        finally:
            p.serve.shutdown()
    finally:
        p.pkg.shutdown()


def both(case):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case) for name in ("ray_tpu", PORT)]


def _peak_until(p, name, at_least, timeout):
    deadline = time.monotonic() + timeout
    peak = 1
    while time.monotonic() < deadline:
        peak = max(peak, p.info(name)["num_running_replicas"])
        if peak >= at_least:
            break
        time.sleep(0.1)
    return peak


def _settle_to(p, name, n, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = p.info(name)
        if info["num_running_replicas"] == n:
            break
        time.sleep(0.2)
    return info["num_running_replicas"]


def case_scale_up_then_down(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(
        max_concurrent_queries=2,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_num_ongoing_requests_per_replica": 1})
    def slow(request):
        time.sleep(0.4)
        return "ok"

    slow.deploy()
    h = slow.get_handle()
    stop = threading.Event()
    replies = []

    def load():
        while not stop.is_set():
            try:
                replies.append(pkg.get(h.remote(None)))
            except Exception:  # noqa: BLE001
                return

    threads = [threading.Thread(target=load, daemon=True) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        peak = _peak_until(p, "slow", 2, 15)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    floor = _settle_to(p, "slow", 1, 15)
    return peak >= 2, floor, set(replies)


def case_rolling_update_no_downtime(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(name="roll", num_replicas=3)
    def roll(req):
        return "v1"

    roll.deploy()
    h = roll.get_handle()
    first = pkg.get(h.remote(None))
    failures, seen = [], set()
    stop = threading.Event()

    def load():
        while not stop.is_set():
            try:
                seen.add(pkg.get(h.remote(None), timeout=10))
            except Exception as e:  # noqa: BLE001
                failures.append(e)
            time.sleep(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        @serve.deployment(name="roll", num_replicas=3)
        def roll2(req):
            return "v2"

        roll2.deploy()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            info = p.info("roll")
            if info["num_current_version_replicas"] == 3 and \
                    info["num_running_replicas"] == 3:
                break
            time.sleep(0.1)
    finally:
        stop.set()
        t.join(timeout=10)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if pkg.get(h.remote(None)) == "v2":
            break
        time.sleep(0.1)
    return (first, [repr(e) for e in failures[:3]],
            info["num_current_version_replicas"], info["version"],
            pkg.get(h.remote(None)), seen <= {"v1", "v2"})


def case_user_config_reconfigure_in_place(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(name="cfg", user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            self.threshold = None
            self.calls = 0

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, req):
            self.calls += 1
            return {"threshold": self.threshold, "calls": self.calls}

    Configurable.deploy()
    h = Configurable.get_handle()
    out1 = pkg.get(h.remote(None))
    Configurable.options(user_config={"threshold": 7}).deploy()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        out = pkg.get(h.remote(None))
        if out["threshold"] == 7:
            break
        time.sleep(0.05)
    return out1["threshold"], out["threshold"], out["calls"] > out1["calls"]


def case_health_check_replaces_dead_replica(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(name="hc", num_replicas=2)
    def hc(req):
        return "ok"

    hc.deploy()
    controller = p.controller()
    handles = pkg.get(controller.get_replica_handles.remote("hc"))
    n0 = len(handles)
    pkg.kill(handles[0])
    deadline = time.monotonic() + 60
    ok = False
    while time.monotonic() < deadline and not ok:
        if p.info("hc")["num_running_replicas"] == 2:
            live = pkg.get(controller.get_replica_handles.remote("hc"))
            try:
                ok = all(pkg.get([x.check_health.remote() for x in live],
                                 timeout=5))
            except Exception:  # noqa: BLE001
                pass
        time.sleep(0.25)
    return n0, ok


def case_kill_replica_mid_request_http(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(name="victim", num_replicas=2,
                      max_concurrent_queries=8)
    def victim(request):
        time.sleep(0.3)
        return {"echo": request.json()}

    victim.deploy()
    port = p.port()
    controller = p.controller()
    handles = pkg.get(controller.get_replica_handles.remote("victim"))
    if p.name != PORT:  # the reference's proxy may not route yet (C.31)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/victim",
                    data=json.dumps(-1).encode()), timeout=10)
                break
            except urllib.error.HTTPError:
                time.sleep(0.02)
    results, errors = {}, {}

    def client(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/victim",
                data=json.dumps(i).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                results[i] = (resp.status, json.loads(resp.read()))
        except Exception as e:  # noqa: BLE001
            errors[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(12)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    pkg.kill(handles[0])
    for t in threads:
        t.join(timeout=60)
    deadline = time.monotonic() + 60
    backfilled = False
    while time.monotonic() < deadline and not backfilled:
        if p.info("victim")["num_running_replicas"] == 2:
            live = pkg.get(controller.get_replica_handles.remote("victim"))
            try:
                pkg.get([x.check_health.remote() for x in live], timeout=5)
                backfilled = True
            except Exception:  # noqa: BLE001
                pass
        time.sleep(0.25)
    return (len(handles), errors, sorted(results.items()), backfilled)


def _series(p, *names):
    text = p.metrics.get_metrics_registry().render_prometheus()
    return [name in text for name in names]


def case_scale_up_through_kernel_solve(p):
    serve, pkg = p.serve, p.pkg
    cfg = p.config.get_config()
    prev = cfg.serve_kernel_placement
    cfg.serve_kernel_placement = "force"
    try:
        @serve.deployment(
            name="ksolve", max_concurrent_queries=2,
            autoscaling_config={
                "min_replicas": 1, "max_replicas": 3,
                "target_num_ongoing_requests_per_replica": 1,
                "upscale_delay_s": 0.2, "downscale_delay_s": 0.8})
        def ksolve(req):
            time.sleep(0.25)
            return req

        ksolve.deploy()
        h = ksolve.get_handle()
        ok, failed = [], []
        stop = threading.Event()

        def load(i):
            n = 0
            while not stop.is_set():
                try:
                    assert pkg.get(h.remote((i, n)), timeout=60) == (i, n)
                    ok.append((i, n))
                except Exception as e:  # noqa: BLE001
                    failed.append(repr(e))
                    return
                n += 1

        threads = [threading.Thread(target=load, args=(i,), daemon=True)
                   for i in range(6)]
        for t in threads:
            t.start()
        try:
            peak = _peak_until(p, "ksolve", 2, 20)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=15)
        up = pkg.get(p.controller().get_autoscaler_stats.remote())
        floor = _settle_to(p, "ksolve", 1, 20)
        down = pkg.get(p.controller().get_autoscaler_stats.remote())
        return (peak >= 2, failed[:3], len(ok) > 0, up["scale_ups"] >= 1,
                up["kernel_placements"] >= 2, floor,
                down["scale_downs"] >= 1,
                _series(p, "ray_tpu_serve_autoscaler_load",
                        "ray_tpu_serve_autoscaler_desired",
                        "ray_tpu_serve_autoscaler_decisions"))
    finally:
        cfg.serve_kernel_placement = prev


def case_soak_200_requests(p):
    serve, pkg = p.serve, p.pkg

    @serve.deployment(
        name="soak", max_concurrent_queries=2,
        autoscaling_config={
            "min_replicas": 2, "max_replicas": 4,
            "target_num_ongoing_requests_per_replica": 1,
            "upscale_delay_s": 0.2, "downscale_delay_s": 5.0})
    @serve.batch(max_batch_size=4, latency_budget_s=0.25)
    def soak(requests):
        time.sleep(0.05)
        return [r * 3 for r in requests]

    soak.deploy()
    h = soak.get_handle()
    got, errors = {}, []
    peak = {"n": 2}
    per_client = 25

    def client(c):
        for n in range(per_client):
            i = c * per_client + n
            try:
                got[i] = pkg.get(h.remote(i), timeout=60)
            except Exception as e:  # noqa: BLE001
                errors.append((i, repr(e)))

    def watch():
        while len(got) + len(errors) < 8 * per_client:
            peak["n"] = max(peak["n"],
                            p.info("soak")["num_running_replicas"])
            time.sleep(0.1)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    watcher.join(timeout=10)
    return (errors[:3], sorted(got.items()), peak["n"] > 2,
            _series(p, "ray_tpu_serve_batch_fill_ratio",
                    'deployment="soak"'))


CASES = [case_scale_up_then_down, case_rolling_update_no_downtime,
         case_user_config_reconfigure_in_place,
         case_health_check_replaces_dead_replica,
         case_kill_replica_mid_request_http,
         case_scale_up_through_kernel_solve, case_soak_200_requests]

EXPECTED = {
    "case_scale_up_then_down": (True, 1, {"ok"}),
    "case_rolling_update_no_downtime": ("v1", [], 3, 1, "v2", True),
    "case_user_config_reconfigure_in_place": (1, 7, True),
    "case_health_check_replaces_dead_replica": (2, True),
    "case_kill_replica_mid_request_http": (
        2, {}, [(i, (200, {"echo": i})) for i in range(12)], True),
    "case_scale_up_through_kernel_solve": (
        True, [], True, True, True, 1, True, [True, True, True]),
    "case_soak_200_requests": (
        [], [(i, i * 3) for i in range(200)], True, [True, True]),
}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_serve_scaling_case_matches_jax(case):
    want, got = both(case)
    assert got == want
    assert got == ("value", EXPECTED[case.__name__])


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
