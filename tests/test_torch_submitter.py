"""The port's direct task submitter against the JAX package's, on the CPU.

Both packages' ``DirectTaskSubmitter``s run over scripted raylets that
record every lease request (single or batched: target, tasks, the
``grant_or_reject`` flag), every push to a worker and every lease
returned, and answer from one script: grants, spillbacks, ``backlog``,
``infeasible`` and ``batch_fault`` replies, completions pushed back in
order, the backlog-retry timers fired by hand.  The two logs must be
equal but for one divergence (ROADMAP C.4): the port re-sends a
spillback with ``grant_or_reject``.  A reply rejecting such a lease
re-leases it at the local raylet with no retry charged, in the port
only.  Then the keepalive cases of ``tests/test_dispatch_fastpath.py``
run under both packages, its lease-count case under the port, and C2
(``tools/profile_tasks.cluster_tasks``) at 4 raylets and 400 tasks.
The last test checks that no thread of the port outlives ``shutdown``.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest

import torch_runtime_util as rt
from ray_tpu_torch._private import direct_task_submitter as tdts
from ray_tpu_torch._private.config import get_config as port_config

try:  # the card's machine has no JAX; the tests marked gpu need none
    import ray_tpu
    from ray_tpu._private import direct_task_submitter as jdts
    from ray_tpu._private.config import get_config as jax_config
except ImportError:
    ray_tpu = jdts = jax_config = None

HEAD, OTHER = "head", "n2"


@pytest.fixture
def lease_knobs(monkeypatch):
    """Both packages' submitter knobs at the reference's defaults (an
    earlier ``init(_system_config=...)`` may have left others)."""
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "lease_batch_size", 10)
        monkeypatch.setattr(
            cfg, "max_pending_lease_requests_per_scheduling_category", 10)
        monkeypatch.setattr(cfg, "lease_backlog_retry_ms", 20)
        monkeypatch.setattr(cfg, "worker_lease_keepalive_ms", 0)
        monkeypatch.setattr(cfg, "submit_backpressure_depth", 64)


class _Loop:
    """The raylet loop's timer heap, fired by the script."""

    def __init__(self, log):
        self._log = log
        self.timers = []

    def schedule_after(self, delay, fn, name="timer"):
        self._log(("timer", name))
        self.timers.append(fn)


class _Worker:
    def __init__(self, log, name, keyof):
        self.name = name
        self.state = "LEASED"
        self.node_id = self.worker_id = None
        self._log, self._keyof = log, keyof
        self.pushed = []

    def push_task(self, spec, on_done):
        self._log(("push", self.name, self._keyof(spec)))
        self.pushed.append((spec, on_done))


class _Raylet:
    """Records lease requests and holds their replies for the script."""

    def __init__(self, name, log, keyof, pending):
        self.name, self._log, self._keyof = name, log, keyof
        self._pending = pending
        self._dead = False
        self.loop = _Loop(log)

    def request_worker_lease(self, spec, reply, grant_or_reject=False):
        self._log(("lease", self.name, self._keyof(spec), grant_or_reject))
        self._pending.append(("lease", self, [spec], reply))

    def request_worker_lease_batch(self, specs, reply):
        self._log(("batch", self.name, [self._keyof(s) for s in specs]))
        self._pending.append(("batch", self, specs, reply))

    def return_worker(self, worker, disconnect=False):
        self._log(("return", self.name, worker.name, disconnect))
        worker.state = "DEAD" if disconnect else "IDLE"


class _Harness:
    """One package's submitter over scripted raylets."""

    def __init__(self, package, fields):
        make = rt.jax_spec if package == "jax" else rt.port_spec
        self.specs = [make(f) for f in fields]
        self._keys = {s.task_id: i for i, s in enumerate(self.specs)}
        self.log = []
        self.pending = []
        self.workers = []
        self.failed = []
        self.completed = []
        raylets = {name: _Raylet(name, self.log.append, self.key,
                                 self.pending) for name in (HEAD, OTHER)}
        self.head = raylets[HEAD]
        lookup = types.SimpleNamespace(raylet=raylets.get)
        cluster = lookup if package == "port" else types.SimpleNamespace(
            gcs=types.SimpleNamespace(raylet=raylets.get, task_events=None),
            object_directory=types.SimpleNamespace(
                get_locations=lambda oid: []))
        task_manager = types.SimpleNamespace(
            complete_task=lambda spec: self.completed.append(self.key(spec)),
            fail_or_retry=self._fail_or_retry)
        core = types.SimpleNamespace(cluster=cluster, local_raylet=self.head,
                                     task_manager=task_manager)
        module = jdts if package == "jax" else tdts
        self.submitter = module.DirectTaskSubmitter(core)

    def key(self, spec):
        return self._keys[spec.task_id]

    def _fail_or_retry(self, spec, error, resubmit):
        self.log.append(("failed", self.key(spec), str(error)))
        self.failed.append(self.key(spec))
        return False

    def grant(self, raylet):
        w = _Worker(self.log.append, f"w{len(self.workers)}", self.key)
        self.workers.append(w)
        return {"worker": w, "raylet": raylet}

    def submit(self, keys):
        for k in keys:
            self.submitter.submit(self.specs[k])


def _batch_results(h, raylet, n, pattern):
    out = []
    for i in range(n):
        kind = pattern[i % len(pattern)]
        out.append(h.grant(raylet) if kind == "grant" else
                   {"retry_at": OTHER} if kind == "spill" else
                   {"backlog": True} if kind == "backlog" else
                   {"backlog": True, "infeasible": True}
                   if kind == "infeasible" else {"batch_fault": True})
    return out


FIRST_BATCH = ["grant", "spill", "backlog", "grant", "infeasible",
               "batch_fault", "spill", "backlog", "grant", "grant"]


def _script(h, reject_spills=False):
    """Class A (24 tasks of 1 CPU) and class B (6 of 2 CPUs), submitted
    in three waves; replies in arrival order: the first full batch mixed
    (grants, spillbacks, backlog, infeasible, batch_fault), the first
    single lease spilled, every other grant; completions in push order;
    timers when nothing else is left."""
    h.submit(range(12))         # A: a single lease goes out, then the gate
    h.submit(range(24, 30))     # B: its own lease beside A's
    h.submit(range(12, 24))     # A: queued behind the gate
    mixed = False
    singles = 0
    steps = 0
    while len(h.completed) + len(h.failed) < 30:
        steps += 1
        assert steps < 2000, h.log[-20:]
        if h.pending:
            kind, raylet, specs, reply = h.pending.pop(0)
            if kind == "batch":
                pattern = ["grant"]
                if len(specs) == len(FIRST_BATCH) and not mixed:
                    pattern, mixed = FIRST_BATCH, True
                reply({"results": _batch_results(h, raylet, len(specs),
                                                 pattern)})
            else:
                singles += 1
                if raylet.name == OTHER and reject_spills and singles % 2:
                    reply({"rejected": True, "grant_or_reject": True,
                           "reason": "the spillback target cannot run "
                                     "it now"})
                elif singles == 1:
                    reply({"retry_at": OTHER})
                else:
                    reply(h.grant(raylet))
            continue
        busy = [w for w in h.workers if w.pushed]
        if busy:
            spec, on_done = busy[0].pushed.pop(0)
            on_done(None)
            continue
        timers = h.head.loop.timers
        assert timers, f"stalled with nothing to answer: {h.log[-10:]}"
        timers.pop(0)()
    return h


def _fields(seed):
    rng = np.random.default_rng(seed)
    return ([rt.spec_fields(rng, {"CPU": 1}) for _ in range(24)] +
            [rt.spec_fields(rng, {"CPU": 2}) for _ in range(6)])


def test_lease_requests_match_jax_but_for_grant_or_reject(lease_knobs):
    fields = _fields(0)
    jax_log = _script(_Harness("jax", fields)).log
    port = _script(_Harness("port", fields))
    assert len(port.log) == len(jax_log)
    resent = 0
    for got, want in zip(port.log, jax_log):
        if got != want:
            # The one divergence: a spillback re-sent to its target.
            assert got[:3] == want[:3] and got[0] == "lease", (got, want)
            assert got[1] == OTHER and got[3] is True and want[3] is False
            resent += 1
    assert resent == sum(1 for e in port.log if e[:2] == ("lease", OTHER))
    assert resent == 3      # two of the mixed batch, one single lease
    assert port.submitter.submitter_stats["spillback_rejections"] == 0
    assert sorted(port.completed) == list(range(30)) and not port.failed
    # Batch sizes, targets and the per-class gate: A's first batch of 10
    # and B's of 6 go out together; no class has two new requests out.
    # Batch sizes, targets and the per-class gate: each class's first
    # task leases alone, the rest of its wave in one batch of at most 10
    # once that reply reopens the gate.
    requests = [e for e in port.log if e[0] in ("lease", "batch")]
    assert requests[:2] == [("lease", HEAD, 0, False),
                            ("lease", HEAD, 24, False)]
    batches = [e for e in port.log if e[0] == "batch"]
    assert ("batch", HEAD, list(range(1, 11))) in batches
    assert ("batch", HEAD, list(range(25, 30))) in batches
    assert all(len(e[2]) <= 10 for e in batches)
    kinds = {e[0] for e in port.log}
    assert {"timer", "return", "push"} <= kinds


def test_rejected_spillback_releases_locally_without_a_retry(lease_knobs):
    """A lease re-sent to a spillback's target and rejected there goes
    back to the local raylet: no retry charged, every task completes,
    counted in ``submitter_stats["spillback_rejections"]``."""
    h = _script(_Harness("port", _fields(1)), reject_spills=True)
    assert sorted(h.completed) == list(range(30)) and not h.failed
    stats = h.submitter.submitter_stats
    assert stats["spillback_rejections"] >= 1
    resent = [i for i, e in enumerate(h.log) if e[:2] == ("lease", OTHER)]
    assert all(h.log[i][3] is True for i in resent)
    rejected = resent[::2]
    for i in rejected:
        # The next request for that task goes to the head, un-flagged.
        key = h.log[i][2]
        nxt = next(e for e in h.log[i + 1:]
                   if e[0] in ("lease", "batch") and
                   (e[2] == key if e[0] == "lease" else key in e[2]))
        assert nxt == ("lease", HEAD, key, False)


# -- tests/test_dispatch_fastpath.py's lease-count and keepalive cases --------

INIT = {"ray_tpu": {}, "ray_tpu_torch": dict(device="cpu")}


def _noop():
    return None


def _head(pkg_name):
    return importlib.import_module(
        f"{pkg_name}._private.worker").global_worker().cluster.head_node


def _lease_rpcs(raylet):
    return (raylet.lease_stats["lease_requests"]
            + raylet.lease_stats["lease_batch_requests"])


@pytest.fixture(params=["ray_tpu", "ray_tpu_torch"])
def package(request):
    if request.param == "ray_tpu" and ray_tpu is None:
        pytest.skip("needs the JAX package")
    return request.param


def _init(name, **kw):
    pkg = importlib.import_module(name)
    pkg.init(**kw, **INIT[name])
    return pkg


def test_500_task_burst_costs_dozens_of_lease_rpcs():
    """The port alone: the JAX package's side of this case is
    ``tests/test_dispatch_fastpath.py``'s own, in its own process.  Run
    in a process that has run other bursts, the reference's count
    depends on when its batched tick compiles, and some runs pass the
    bound: it is timing, not a protocol difference."""
    package = "ray_tpu_torch"
    pkg = _init(package, num_cpus=8)
    try:
        noop = pkg.remote(_noop)
        pkg.get([noop.remote() for _ in range(100)])  # warm
        before = _lease_rpcs(_head(package))
        pkg.get([noop.remote() for _ in range(500)])
        spent = _lease_rpcs(_head(package)) - before
        assert spent <= 50, f"500-task burst cost {spent} lease RPCs"
        assert _head(package).lease_stats["lease_batch_entries"] >= 2, \
            "batching never engaged"
    finally:
        pkg.shutdown()


def test_keepalive_reuses_lease_across_bursts(package):
    pkg = _init(package, num_cpus=4, _system_config={
        "worker_lease_keepalive_ms": 2_000})
    try:
        noop = pkg.remote(_noop)
        pkg.get([noop.remote() for _ in range(50)])
        before = _lease_rpcs(_head(package))
        for _ in range(20):
            pkg.get(noop.remote())
        assert _lease_rpcs(_head(package)) - before <= 2
    finally:
        pkg.shutdown()


def test_keepalive_returns_lease_after_window(package):
    pkg = _init(package, num_cpus=2, _system_config={
        "worker_lease_keepalive_ms": 50})
    try:
        noop = pkg.remote(_noop)
        pkg.get([noop.remote() for _ in range(10)])
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                pkg.available_resources().get("CPU", 0) != 2:
            time.sleep(0.05)
        assert pkg.available_resources().get("CPU", 0) == 2, \
            "parked leases never expired back to the raylet"
    finally:
        pkg.shutdown()


def test_keepalive_off_by_default():
    assert type(port_config())().worker_lease_keepalive_ms == 0


# -- C2 at a small size -------------------------------------------------------

def test_c2_cluster_tasks_on_the_cpu():
    """``chip_smoke.py``'s C2 at 4 raylets and 400 tasks: every kept
    task returns its index once (checked inside), the dropped classes
    are those no node fits, and the head solves in batches."""
    from ray_tpu_torch.tools import profile_tasks as pt
    out = pt.cluster_tasks(400, 4, "cpu")
    assert out["submitted"] + out["dropped_infeasible"] == 400
    assert 0 < out["submitted"] and out["dropped_classes"] >= 1
    assert out["batched_ticks"].get("c2-0", 0) >= 1
    assert out["latency_p99_ms"] >= out["latency_p50_ms"] > 0


def test_c1_single_node_on_the_cpu():
    """C1 at a tenth of its counts: every value checked inside."""
    from ray_tpu_torch.tools import profile_tasks as pt
    out = pt.single_node("cpu", n_tasks=1_000, n_latency=200, n_args=1_000,
                         n_returns=300, n_get=1_000, num_cpus=4)
    assert out["batched_ticks"] >= 1 and out["tasks_per_s"] > 0


def test_no_port_thread_survives_shutdown():
    """Runs last in this file: every thread of the port is gone."""
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
