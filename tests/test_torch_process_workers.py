"""The port's process workers against the JAX package's, on the CPU.

Each case runs under ``init(num_cpus=4, _system_config={
"worker_process_mode": "process", ...})`` of both packages, up at once
for a class's cases (``tests/test_wire_transport.py``'s
``process_mode_cluster``), and the two outcomes must be equal: values,
error types and structure (pids other than the driver's, distinct or
shared processes), never pids themselves.  The cases are
``TestProcessWorkers`` and ``TestNestedRemoteInProcessWorkers`` of
``tests/test_wire_transport.py``, ``TestConcurrencyGroups::
test_process_mode`` of ``tests/test_actor.py``, ``TestWorkerLogs`` of
``tests/test_observability.py``, ``test_torch_backend_real_process_group``
of ``tests/test_train.py`` (a real gloo group over two worker processes;
the reference marks it slow, here it runs in a few seconds),
``test_owner_death_borrower_observes_owner_died`` of
``tests/test_failure.py`` (a cluster of one CPU each); and a small
transformer run by a process actor in each package, its weights carried
by ``models/convert.py``'s ``params_from_numpy``, held within
``tests/test_torch_transformer.py``'s float32 tolerance.  The port's own:
a worker process imports neither JAX nor ``ray_tpu``, tensors cross as
their host forms (ROADMAP C.37), and no child or thread outlives
``shutdown``.  Task bodies are nested functions (pickled by value: a
worker process cannot import this module).  Every wait is bounded.
"""

import importlib
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from torch_cluster_util import outcome

PORT = "ray_tpu_torch"
PKGS = ("ray_tpu", PORT)
PROCESS = {"worker_process_mode": "process",
           "maximum_startup_concurrency": 4, "num_workers_soft_limit": 4}


def _start(name, root, num_cpus, system_config):
    pkg = importlib.import_module(name)
    config = {"temp_dir": os.path.join(root, name), **system_config}
    if name == PORT:
        pkg.init(num_cpus=num_cpus, device="cpu", _system_config=config)
    else:
        pkg.init(num_cpus=num_cpus, _system_config=config)
    return pkg


def _port_pool():
    from ray_tpu_torch._private.worker import global_worker
    return global_worker().cluster.head_node.worker_pool


def _check_gone(pids):
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        alive.append(pid)
    assert not alive, f"worker processes outlived shutdown: {alive}"


def _clusters(names=PKGS, num_cpus=4, system_config=PROCESS):
    """Both packages' process-mode clusters; on the way out every child
    of the port's pool and every thread of the port is gone."""
    root = tempfile.mkdtemp(prefix="pworkers-")
    started, pids = [], []
    try:
        pkgs = {}
        for name in names:
            pkgs[name] = _start(name, root, num_cpus, system_config)
            started.append(name)
        yield pkgs
    finally:
        for name in started:
            if name == PORT:
                pids = list(_port_pool().spawned_pids)
            importlib.import_module(name).shutdown()
            importlib.import_module(f"{name}._private.config") \
                .initialize_config()
        shutil.rmtree(root, ignore_errors=True)
    _check_gone(pids)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(f"{PORT}::")]
    assert not left, left


@pytest.fixture(scope="class")
def pw():
    yield from _clusters()


def _both(case, pkgs, *args):
    return [outcome(lambda name=name: case(name, pkgs[name], *args))
            for name in PKGS]


# -- TestProcessWorkers -------------------------------------------------------

def case_tasks_run_in_other_processes(name, pkg):
    @pkg.remote
    def pid_and_sq(i):
        return os.getpid(), i * i

    results = pkg.get([pid_and_sq.remote(i) for i in range(8)], timeout=120)
    return [sq for _, sq in results], os.getpid() in {p for p, _ in results}


def case_big_object_over_the_wire(name, pkg):
    """A 12 MB return crosses worker to host, a 12 MB ref argument host
    to worker."""
    @pkg.remote
    def make(n):
        return np.arange(n, dtype=np.float64)

    @pkg.remote
    def consume(a):
        return float(a[0] + a[-1]), len(a)

    n = (12 * 1024 * 1024) // 8
    ref = make.remote(n)
    arr = pkg.get(ref, timeout=120)
    return arr.shape, float(arr[-1]), pkg.get(consume.remote(ref),
                                              timeout=120)


def case_errors_propagate(name, pkg):
    @pkg.remote
    def bad():
        raise ValueError("process worker error")

    return pkg.get(bad.remote(), timeout=120)


def case_actor_in_process_worker(name, pkg):
    @pkg.remote
    class Counter:
        def __init__(self, start):
            self.n = start
            self.pid = os.getpid()

        def add(self, k):
            self.n += k
            return self.n

        def where(self):
            return self.pid

    c = Counter.remote(100)
    out = pkg.get([c.add.remote(1) for _ in range(5)], timeout=120)
    elsewhere = pkg.get(c.where.remote(), timeout=60) != os.getpid()
    pkg.kill(c)
    return out, elsewhere


class TestProcessWorkers:
    def test_tasks_run_in_other_processes(self, pw):
        want, got = _both(case_tasks_run_in_other_processes, pw)
        assert got == want == ("value", ([i * i for i in range(8)], False))

    def test_big_object_over_the_wire(self, pw):
        n = (12 * 1024 * 1024) // 8
        want, got = _both(case_big_object_over_the_wire, pw)
        assert got == want == ("value", ((n,), float(n - 1),
                                         (float(n - 1), n)))

    def test_errors_propagate(self, pw):
        want, got = _both(case_errors_propagate, pw)
        assert got == want
        assert got[:2] == ("raise", "ValueError")
        assert "process worker error" in got[2]

    def test_actor_in_process_worker(self, pw):
        want, got = _both(case_actor_in_process_worker, pw)
        assert got == want == ("value", ([101, 102, 103, 104, 105], True))


# -- TestNestedRemoteInProcessWorkers -----------------------------------------

def case_nested_remote(name, pkg):
    @pkg.remote
    def inner(x):
        return os.getpid(), x * 2

    @pkg.remote
    def outer(x):
        pid_inner, doubled = pkg.get(inner.remote(x), timeout=60)
        return os.getpid(), pid_inner, doubled

    outer_pid, inner_pid, val = pkg.get(outer.remote(21), timeout=60)
    return val, outer_pid != os.getpid(), inner_pid != os.getpid()


def case_put_get_wait_inside_worker(name, pkg):
    @pkg.remote
    def use_api():
        ref = pkg.put(np.arange(10))
        ready, rest = pkg.wait([ref], num_returns=1, timeout=10)
        assert ready and not rest
        return float(pkg.get(ref, timeout=30).sum())

    return pkg.get(use_api.remote(), timeout=60)


def case_actor_created_from_inside_task(name, pkg):
    @pkg.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    @pkg.remote
    def spawn_and_use():
        c = Counter.remote()
        return [pkg.get(c.bump.remote(), timeout=60) for _ in range(3)]

    return pkg.get(spawn_and_use.remote(), timeout=120)


def case_fan_out_from_worker(name, pkg):
    @pkg.remote
    def leaf(i):
        return i * i

    @pkg.remote
    def fan(n):
        return sum(pkg.get([leaf.remote(i) for i in range(n)], timeout=120))

    return pkg.get(fan.remote(6), timeout=180)


def case_nested_error_propagates(name, pkg):
    @pkg.remote
    def bad():
        raise KeyError("inner-kaboom")

    @pkg.remote
    def outer():
        return pkg.get(bad.remote(), timeout=60)

    return pkg.get(outer.remote(), timeout=120)


def case_nested_big_get_rides_chunk_sessions(name, pkg):
    """An 8 MiB nested get (above the 5 MiB chunk) streams back to the
    child in chunk frames."""
    @pkg.remote
    def make(n):
        return np.ones(n, dtype=np.float64)

    @pkg.remote
    def consume():
        n = (8 * 1024 * 1024) // 8
        arr = pkg.get(make.remote(n), timeout=120)
        return float(arr.sum()), len(arr)

    return pkg.get(consume.remote(), timeout=180)


class TestNestedRemoteInProcessWorkers:
    def test_nested_remote(self, pw):
        want, got = _both(case_nested_remote, pw)
        assert got == want == ("value", (42, True, True))

    def test_put_get_wait_inside_worker(self, pw):
        want, got = _both(case_put_get_wait_inside_worker, pw)
        assert got == want == ("value", 45.0)

    def test_actor_created_from_inside_task(self, pw):
        want, got = _both(case_actor_created_from_inside_task, pw)
        assert got == want == ("value", [1, 2, 3])

    def test_fan_out_from_worker(self, pw):
        want, got = _both(case_fan_out_from_worker, pw)
        assert got == want == ("value", sum(i * i for i in range(6)))

    def test_nested_error_propagates(self, pw):
        want, got = _both(case_nested_error_propagates, pw)
        assert got == want
        assert got[:2] == ("raise", "KeyError") and "inner-kaboom" in got[2]

    def test_nested_big_get_rides_chunk_sessions(self, pw):
        n = (8 * 1024 * 1024) // 8
        want, got = _both(case_nested_big_get_rides_chunk_sessions, pw)
        assert got == want == ("value", (float(n), n))


# -- TestConcurrencyGroups::test_process_mode ---------------------------------

def case_concurrency_groups(name, pkg, gate):
    @pkg.remote(concurrency_groups={"io": 1, "compute": 2})
    class Worker:
        def blocked_io(self, gate):
            deadline = time.monotonic() + 30
            while not os.path.exists(gate):
                if time.monotonic() > deadline:
                    raise TimeoutError("gate never appeared")
                time.sleep(0.01)
            return "io-done"

        def quick_compute(self, x):
            return x * 2

    w = Worker.remote()
    blocked = w.blocked_io.options(concurrency_group="io").remote(gate)
    # While io is blocked, compute-group calls and the default group
    # flow.
    outs = pkg.get([w.quick_compute.options(
        concurrency_group="compute").remote(i) for i in range(4)],
        timeout=30)
    default = pkg.get(w.quick_compute.remote(5), timeout=30)
    open(gate, "w").close()
    io = pkg.get(blocked, timeout=30)
    pkg.kill(w)
    return outs, default, io


class TestConcurrencyGroups:
    def test_process_mode(self, pw, tmp_path):
        want, got = [outcome(lambda n=n: case_concurrency_groups(
            n, pw[n], str(tmp_path / f"gate-{n}"))) for n in PKGS]
        assert got == want == ("value", ([0, 2, 4, 6], 10, "io-done"))


# -- TestWorkerLogs -----------------------------------------------------------

def case_stdout_lands_in_session_files(name, pkg, marker):
    log_monitor = importlib.import_module(f"{name}._private.log_monitor")

    @pkg.remote
    def shout():
        print(marker)
        return os.getpid()

    elsewhere = pkg.get(shout.remote(), timeout=60) != os.getpid()
    d = log_monitor.worker_log_dir(create=False)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        for fname in os.listdir(d):
            if fname.endswith(".out"):
                with open(os.path.join(d, fname), "rb") as f:
                    if marker.encode() in f.read():
                        return elsewhere, True
        time.sleep(0.1)
    return elsewhere, False


def _published(name, pkg, task, marker):
    """The worker_logs messages carrying ``marker`` after ``task`` ran."""
    log_monitor = importlib.import_module(f"{name}._private.log_monitor")
    worker = importlib.import_module(f"{name}._private.worker")
    msgs = []
    pub = worker.global_worker().cluster.gcs.publisher
    sub = pub.subscribe(log_monitor.LOG_CHANNEL, None,
                        lambda _k, m: msgs.append(m))
    try:
        assert pkg.get(task.remote(), timeout=60)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            hits = [m for m in list(msgs)
                    if any(marker in ln for ln in m["lines"])]
            if hits:
                return hits
            time.sleep(0.1)
        return []
    finally:
        pub.unsubscribe(log_monitor.LOG_CHANNEL, None, sub)


def case_print_mirrored_to_driver(name, pkg, marker):
    @pkg.remote
    def shout():
        print(marker)
        return True

    hits = _published(name, pkg, shout, marker)
    return bool(hits), [m["is_err"] for m in hits][:1]


def case_stderr_flagged(name, pkg, marker):
    @pkg.remote
    def complain():
        print(marker, file=sys.stderr)
        return True

    hits = _published(name, pkg, complain, marker)
    return bool(hits), [m["is_err"] for m in hits][:1]


class TestWorkerLogs:
    def test_worker_stdout_lands_in_session_files(self, pw):
        want, got = [outcome(lambda n=n: case_stdout_lands_in_session_files(
            n, pw[n], f"LOGLINE_FILE_MARKER_77_{n}")) for n in PKGS]
        assert got == want == ("value", (True, True))

    def test_worker_print_mirrored_to_driver(self, pw):
        want, got = [outcome(lambda n=n: case_print_mirrored_to_driver(
            n, pw[n], f"LOGLINE_MIRROR_MARKER_88_{n}")) for n in PKGS]
        assert got == want == ("value", (True, [False]))

    def test_stderr_flagged(self, pw):
        want, got = [outcome(lambda n=n: case_stderr_flagged(
            n, pw[n], f"ERRLINE_MARKER_99_{n}")) for n in PKGS]
        assert got == want == ("value", (True, [True]))


# -- the train backend's real process group -----------------------------------

def case_torch_backend_real_process_group(name, pkg):
    train = importlib.import_module(f"{name}.train")

    def train_func():
        import os
        import torch
        import torch.distributed as dist
        assert dist.is_initialized()
        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t)       # 1 + 2 = 3 across the 2 ranks
        return (os.getpid(), dist.get_world_size(), t.item())

    trainer = train.Trainer(backend=train.TorchConfig(), num_workers=2)
    try:
        out = trainer.run(train_func)
    finally:
        trainer.shutdown()
    pids = [o[0] for o in out]
    return (len(set(pids)), os.getpid() in pids, [o[1] for o in out],
            [o[2] for o in out])


class TestTrainProcessGroup:
    def test_torch_backend_real_process_group(self, pw):
        want, got = _both(case_torch_backend_real_process_group, pw)
        assert got == want == ("value", (2, False, [2, 2], [3.0, 3.0]))


# -- a transformer served by a process actor ----------------------------------

_SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, d_ff=128,
              max_seq_len=64, remat=False)
# tests/test_torch_transformer.py's float32 logits tolerance.
_LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_weights():
    import jax
    import jax.numpy as jnp
    import ray_tpu.models.transformer as jt
    cfg = jt.TransformerConfig(dtype=jnp.float32, **_SMALL)
    return jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def case_transformer_in_process_actor(name, pkg, weights, tokens):
    if name == PORT:
        @pkg.remote
        class Model:
            def __init__(self, tree):
                import ray_tpu_torch.models.transformer as tt
                from ray_tpu_torch.models.convert import params_from_numpy
                cfg = tt.TransformerConfig(dtype=torch.float32, **_SMALL)
                self.model = tt.Transformer(
                    cfg, params=params_from_numpy(tree, cfg, device="cpu"),
                    device="cpu")

            def forward(self, toks):
                with torch.no_grad():
                    return (self.model(torch.from_numpy(toks)).numpy(),
                            os.getpid())
    else:
        @pkg.remote
        class Model:
            def __init__(self, tree):
                import jax.numpy as jnp
                import ray_tpu.models.transformer as jt
                self.cfg = jt.TransformerConfig(dtype=jnp.float32, **_SMALL)
                self.params = tree

            def forward(self, toks):
                import jax.numpy as jnp
                import ray_tpu.models.transformer as jt
                return (np.asarray(jt.forward(self.params, jnp.asarray(toks),
                                              self.cfg)), os.getpid())

    m = Model.remote(weights)
    logits, pid = pkg.get(m.forward.remote(tokens), timeout=300)
    pkg.kill(m)
    return logits, pid != os.getpid()


class TestTransformerInProcessActor:
    def test_forward_matches_jax_across_processes(self, pw):
        weights = _jax_weights()
        tokens = np.random.default_rng(1).integers(
            0, _SMALL["vocab_size"], (2, 32)).astype(np.int32)
        want, got = [case_transformer_in_process_actor(
            n, pw[n], weights, tokens) for n in PKGS]
        assert got[1] and want[1]
        assert got[0].shape == want[0].shape == (2, 32, 256)
        np.testing.assert_allclose(got[0], want[0], **_LOGIT_TOL)


# -- the port's own -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the worker makes a CUDA tensor")
    return torch.device("cuda")


class TestPortWorkerProcesses:
    def test_children_import_neither_jax_nor_the_reference(self, pw):
        import ray_tpu_torch as rt

        @rt.remote
        def modules():
            return sorted(m for m in sys.modules
                          if m in ("jax", "ray_tpu") or m.startswith("jax.")
                          or m.startswith("ray_tpu.")), os.getpid()

        @rt.remote
        def nested():
            return rt.get(modules.remote(), timeout=60)

        for got, pid in (rt.get(modules.remote(), timeout=60),
                         rt.get(nested.remote(), timeout=60)):
            assert got == [] and pid != os.getpid()

    def test_tensors_cross_as_host_forms_in_the_port(self, pw):
        """C.37: a tensor returned whole from a worker process reaches
        the driver as a CPU tensor of its dtype (a thread worker's would
        stay a device object), and so does a tensor a worker puts or
        takes as an argument."""
        import ray_tpu_torch as rt
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)

        @rt.remote
        def echo(t):
            return t.to(torch.bfloat16) * 2, os.getpid()

        @rt.remote
        def put_one():
            return [rt.put(torch.ones(5, dtype=torch.bfloat16))]

        y, pid = rt.get(echo.remote(x), timeout=60)
        assert pid != os.getpid()
        assert y.device.type == "cpu" and y.dtype == torch.bfloat16
        assert torch.equal(y, (x * 2).to(torch.bfloat16))
        [ref] = rt.get(put_one.remote(), timeout=60)
        z = rt.get(ref, timeout=60)
        assert z.dtype == torch.bfloat16 and torch.equal(
            z, torch.ones(5, dtype=torch.bfloat16))

    def test_nested_specs_take_the_host_classes_in_the_port(
            self, pw, monkeypatch):
        """C.38: a spec built in a worker process carries the child's
        interned scheduling class; the host queues it under its own id
        for the shape (the reference keeps the child's)."""
        import ray_tpu_torch as rt
        from ray_tpu_torch._private.task_spec import scheduling_class_of
        from ray_tpu_torch._private.worker import global_worker
        core = global_worker().core_worker
        seen = []
        submit = core.submit_task

        def record(spec, holders=()):
            seen.append((spec.scheduling_class, scheduling_class_of(
                spec.resources, spec.scheduling_options)))
            return submit(spec, holders)

        monkeypatch.setattr(core, "submit_task", record)

        @rt.remote
        def outer():
            inner = rt.remote(num_cpus=0.25)(lambda: "quarter")
            return rt.get(inner.remote(), timeout=60)

        assert rt.get(outer.remote(), timeout=120) == "quarter"
        assert len(seen) == 2 and all(got == want for got, want in seen)

    def test_workers_register_and_are_counted(self, pw):
        """Every live child of the pool registers (within the 120 s
        wait), and the pool counts it."""
        pool = _port_pool()
        assert len(pool.spawned_pids) >= 4
        assert os.getpid() not in pool.spawned_pids
        deadline = time.monotonic() + 120
        while any(w.spawn_to_registered_s is None
                  for w in pool.process_workers()):
            assert time.monotonic() < deadline, "a child never registered"
            time.sleep(0.05)
        assert len(pool.registered_s) >= len(pool.process_workers()) >= 4
        assert all(0 < s < 120 for s in pool.registered_s)


@pytest.mark.gpu
def test_cuda_tensor_returns_arrive_on_the_host_in_the_port(cuda_device):
    """C.37 on the card: a CUDA tensor returned from a worker process
    arrives as a CPU tensor of the same dtype and values."""
    import ray_tpu_torch as rt
    for _ in _clusters(names=(PORT,)):
        @rt.remote
        def make():
            t = torch.arange(6, dtype=torch.bfloat16, device="cuda")
            return t, str(t.device)

        t, where = rt.get(make.remote(), timeout=300)
        assert where.startswith("cuda")
        assert t.device.type == "cpu" and t.dtype == torch.bfloat16
        assert torch.equal(t, torch.arange(6, dtype=torch.bfloat16))


# -- owner death --------------------------------------------------------------

def case_owner_death_borrower_observes_owner_died(name, pkg):
    exceptions = importlib.import_module(f"{name}.exceptions")
    worker = importlib.import_module(f"{name}._private.worker")

    @pkg.remote
    def make_owned():
        inner = pkg.put(np.ones(500_000, dtype=np.float64))
        return [inner]

    [inner_ref] = pkg.get(make_owned.remote(), timeout=120)
    readable = pkg.get(inner_ref, timeout=60)[0] == 1.0
    pool = worker.global_worker().cluster.head_node.worker_pool
    killed = 0
    for w in list(pool._all.values()):
        proc = getattr(w, "_proc", None)
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
            killed += 1
    deadline = time.monotonic() + 30
    while True:
        try:
            pkg.get(inner_ref, timeout=2.0)
        except exceptions.OwnerDiedError as e:
            return readable, killed > 0, type(e).__name__
        except exceptions.GetTimeoutError:
            pass
        if time.monotonic() > deadline:
            return readable, killed > 0, "never"


def test_owner_death_borrower_observes_owner_died():
    """Kill the worker process that put an object; the borrower's get
    raises OwnerDiedError, not a hang (reference_count.cc OWNER_DIED)."""
    got = []
    for name in PKGS:
        for pkgs in _clusters(names=(name,), num_cpus=1):
            got.append(outcome(
                lambda: case_owner_death_borrower_observes_owner_died(
                    name, pkgs[name])))
    assert got[1] == got[0] == ("value", (True, True, "OwnerDiedError"))


def test_no_child_or_thread_outlives_shutdown_in_the_port():
    """Runs last in this file: a port cluster whose workers ran tasks,
    an actor and a nested call leaves no child process and no thread
    of the port after shutdown (``_clusters`` checks both)."""
    import ray_tpu_torch as rt
    for _ in _clusters(names=(PORT,)):
        @rt.remote
        def f(i):
            return i + 1

        @rt.remote
        class A:
            def ping(self):
                return rt.get(f.remote(1), timeout=60)

        a = A.remote()
        assert rt.get([f.remote(i) for i in range(8)], timeout=60) == \
            list(range(1, 9))
        assert rt.get(a.ping.remote(), timeout=60) == 2
        assert len(_port_pool().spawned_pids) >= 5
