"""The port's ``ray_tpu_torch.util`` (ActorPool, Queue, metrics, iter,
check_serialize, rpdb) against the JAX package's ``ray_tpu.util``, on
the CPU.

Each case of ``tests/test_util.py`` runs once on each package's cluster
(``torch_cluster_util``'s ``both``), and the two outcomes must be equal:
the values, or the error's type and message.  Metrics are read from
each registry's Prometheus text (the lines of the case's own series).
The cases that need no cluster (``check_serialize``, ``LocalIterator``)
and the remote pdb session run once through each package's module.  A
remote pdb waits on a loopback port with a timeout here (the JAX
package's waits for ever), and the session's client reads with one.
Then the port's own: the lazy attributes of ``ray_tpu_torch.util``
(``multiprocessing`` and ``joblib`` load as the reference's do;
``tracing``, not ported, raises ``AttributeError``), and the bounds of
its remote pdb.  The last test
checks that no thread of the port outlives ``shutdown``.
"""

import contextlib
import importlib
import io
import re
import threading
import time

import pytest

import ray_tpu_torch
from torch_cluster_util import PORT, both

try:  # the card's machine has no JAX
    import ray_tpu
except ImportError:
    ray_tpu = None

HEAD_CPUS = 4
PACKAGES = ("ray_tpu", PORT)


def _util(env, name):
    return importlib.import_module(f"{env.name}.util.{name}")


class Doubler:
    def double(self, v):
        return 2 * v


def _pool(env, n):
    pool_mod = _util(env, "actor_pool")
    cls = env.pkg.remote(Doubler)
    return pool_mod.ActorPool([cls.remote() for _ in range(n)])


# -- ActorPool ------------------------------------------------------------------

def case_actor_pool_map_ordered(env):
    pool = _pool(env, 2)
    return list(pool.map(lambda a, v: a.double.remote(v), range(20)))


def case_actor_pool_map_unordered(env):
    pool = _pool(env, 2)
    return sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                     [1, 2, 3, 4]))


def case_actor_pool_submit_get_next(env):
    pool = _pool(env, 1)
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    seen = [pool.has_next(), pool.has_free()]
    seen += [pool.get_next(), pool.get_next(), pool.has_next()]
    try:
        pool.get_next()
    except StopIteration as e:
        seen.append(("StopIteration", str(e)))
    return seen


def case_actor_pool_push_pop(env):
    pool_mod = _util(env, "actor_pool")
    cls = env.pkg.remote(Doubler)
    a, b = cls.remote(), cls.remote()
    pool = pool_mod.ActorPool([a])
    seen = []
    try:
        pool.push(a)
    except ValueError as e:
        seen.append(str(e))
    pool.push(b)
    seen.append(pool.pop_idle() is not None)
    seen.append(pool.pop_idle() is not None)
    seen.append(pool.pop_idle())
    return seen


# -- Queue ------------------------------------------------------------------------

def case_queue_basics(env):
    q_mod = _util(env, "queue")
    q = q_mod.Queue(maxsize=2)
    seen = [q.empty()]
    q.put(1)
    q.put(2)
    seen += [q.full(), q.size(), len(q)]
    for call in (lambda: q.put(3, block=False),
                 lambda: q.put(3, timeout=0.05)):
        try:
            call()
        except q_mod.Full:
            seen.append("Full")
    seen += [q.get(), q.get()]
    for call in (lambda: q.get(block=False), lambda: q.get(timeout=0.05)):
        try:
            call()
        except q_mod.Empty:
            seen.append("Empty")
    try:
        q.get(timeout=-1)
    except ValueError as e:
        seen.append(str(e))
    q.shutdown()
    return seen


def case_queue_batch(env):
    q_mod = _util(env, "queue")
    q = q_mod.Queue()
    q.put_nowait_batch([1, 2, 3])
    seen = [q.get_nowait_batch(2)]
    try:
        q.get_nowait_batch(5)
    except q_mod.Empty as e:
        seen.append(str(e))
    bounded = q_mod.Queue(maxsize=2)
    try:
        bounded.put_nowait_batch([1, 2, 3])
    except q_mod.Full as e:
        seen.append(str(e))
    return seen


def _produce(pkg_name, q, start, n):
    for i in range(start, start + n):
        q.put(i)
    return n


def case_queue_between_tasks(env):
    q_mod = _util(env, "queue")
    q = q_mod.Queue(maxsize=16)
    producer = env.pkg.remote(_produce)
    refs = [producer.remote(env.name, q, s, 50) for s in (0, 1000)]
    got = [q.get(timeout=30) for _ in range(100)]
    env.pkg.get(refs)
    return sorted(got) == list(range(50)) + list(range(1000, 1050)), \
        q.empty()


# -- metrics ------------------------------------------------------------------------

def _series(env, prefix):
    reg = importlib.import_module(
        f"{env.name}._private.metrics_agent").get_metrics_registry()
    return sorted(line for line in reg.render_prometheus().splitlines()
                  if prefix in line)


def case_metrics_counter_gauge_histogram(env):
    m = _util(env, "metrics")
    c = m.Counter("torch_util_requests", description="reqs",
                  tag_keys=("route",))
    c.inc(tags={"route": "/"})
    c.inc(2, tags={"route": "/"})
    g = m.Gauge("torch_util_inflight")
    g.set(5)
    h = m.Histogram("torch_util_lat", boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return c.info, _series(env, "torch_util_")


def case_metrics_tag_validation(env):
    m = _util(env, "metrics")
    c = m.Counter("torch_util_tagged", tag_keys=("k",))
    seen = []
    for call in (lambda: c.inc(), lambda: c.inc(tags={"bad": "x"}),
                 lambda: c.inc(-1, tags={"k": "v"}),
                 lambda: m.Histogram("torch_util_h", boundaries=[]),
                 lambda: m.Gauge(""),
                 lambda: c.set_default_tags({"nope": "1"})):
        try:
            call()
        except ValueError as e:
            seen.append(str(e))
    c.set_default_tags({"k": "d"})
    c.inc(4)
    return seen, _series(env, "torch_util_tagged")


# -- iter ------------------------------------------------------------------------------

def case_parallel_iterator(env):
    it = _util(env, "iter").from_range(8, num_shards=2)
    return repr(it), sorted(it.for_each(lambda x: x * 2).gather_sync()
                            .take(8))


def case_parallel_iterator_filter_batch(env):
    it = _util(env, "iter").from_items(list(range(10)), num_shards=2)
    batches = it.filter(lambda x: x % 2 == 0).batch(2).gather_sync().take(5)
    return sorted(x for b in batches for x in b)


def case_parallel_iterator_gather_async(env):
    it = _util(env, "iter").from_range(6, num_shards=3)
    return sorted(it.gather_async().take(6))


def case_parallel_iterator_shards(env):
    it = _util(env, "iter").from_items(list(range(9)), num_shards=3)
    shards = [list(s) for s in it.shards()]
    across = _util(env, "iter").from_range(6, num_shards=2)
    return it.num_shards(), shards, \
        list(across.batch_across_shards().take(3))


CASES = [case_actor_pool_map_ordered, case_actor_pool_map_unordered,
         case_actor_pool_submit_get_next, case_actor_pool_push_pop,
         case_queue_basics, case_queue_batch, case_queue_between_tasks,
         case_metrics_counter_gauge_histogram, case_metrics_tag_validation,
         case_parallel_iterator, case_parallel_iterator_filter_batch,
         case_parallel_iterator_gather_async, case_parallel_iterator_shards]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_util_case_matches_jax(case):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    want, got = both(case, HEAD_CPUS)
    assert want[0] == "value", want
    assert got == want


# -- no cluster: LocalIterator, check_serialize --------------------------------------

def _each_package(fn):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [fn(pkg) for pkg in PACKAGES]


def test_local_iterator_transforms_match_jax():
    def run(pkg):
        local = importlib.import_module(f"{pkg}.util.iter").LocalIterator
        it = local(lambda: iter(range(6)))
        a = it.for_each(lambda x: x + 1).filter(lambda x: x % 2 == 0) \
            .batch(2).take(2)
        b = local(lambda: iter([[1, 2], [3]])).flatten().take(5)
        c = local(lambda: iter("ab")).union(local(lambda: iter("xyz"))) \
            .take(5)
        return a, b, c
    want, got = _each_package(run)
    assert got == want == ([[2, 4], [6]], [1, 2, 3], list("axbyz"))


def test_check_serialize_matches_jax():
    lock = threading.Lock()

    def captured():
        return lock

    def clean(x):
        return x + 1

    def run(pkg):
        inspect = importlib.import_module(
            f"{pkg}.util.check_serialize").inspect_serializability
        out = []
        for fn in (captured, clean):
            ok, failures = inspect(fn, print_trace=False)
            out.append((ok, sorted(f.name for f in failures)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inspect(captured)
        out.append("is NOT serializable" in buf.getvalue())
        return out
    want, got = _each_package(run)
    assert got == want
    assert want[0][0] is False and any("lock" in n for n in want[0][1])


# -- rpdb ----------------------------------------------------------------------------

def _pdb_session(pkg):
    """Drive a remote pdb session: read a local, continue.  Every wait
    is bounded (10 s)."""
    rpdb = importlib.import_module(f"{pkg}.util.rpdb")
    done = threading.Event()
    err = io.StringIO()

    def task():
        secret = 1234  # noqa: F841 — read through the debugger
        with contextlib.redirect_stderr(err):
            rpdb.set_trace(port=0)
        done.set()

    t = threading.Thread(target=task, daemon=True)
    t.start()
    port = None
    deadline = time.monotonic() + 10
    while port is None and time.monotonic() < deadline:
        m = re.search(r"waiting on 127\.0\.0\.1:(\d+)", err.getvalue())
        port = int(m.group(1)) if m else None
        time.sleep(0.02)
    assert port, "remote pdb never advertised its port"
    conn = rpdb.connect("127.0.0.1", port)
    conn.settimeout(10)
    conn.sendall(b"p secret\nc\n")
    out = []
    try:
        while "1234" not in "".join(out):
            chunk = conn.recv(4096)
            if not chunk:
                break
            out.append(chunk.decode())
    except OSError:
        pass
    conn.close()
    resumed = done.wait(timeout=10)
    t.join(timeout=10)
    return resumed, "1234" in "".join(out), "(remote-pdb)" in "".join(out)


def test_remote_pdb_session_matches_jax():
    want, got = _each_package(_pdb_session)
    assert got == want == (True, True, True)


def test_remote_pdb_waits_with_a_timeout_in_the_port():
    from ray_tpu_torch.util import rpdb
    err = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err), \
            pytest.raises(TimeoutError, match="no debugger attached"):
        rpdb.set_trace(port=0, timeout=0.2)
    assert time.monotonic() - t0 < 5
    with pytest.raises(ValueError, match="loopback"):
        rpdb.RemotePdb(host="0.0.0.0", timeout=0.1)


# -- the package's lazy attributes -------------------------------------------------------

def test_util_lazy_attributes_in_the_port():
    util = ray_tpu_torch.util
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue
    assert util.ActorPool is ActorPool and util.Queue is Queue
    for name in ("collective", "metrics", "iter", "queue", "multiprocessing",
                 "joblib"):
        assert getattr(util, name).__name__ == f"ray_tpu_torch.util.{name}"
    for name in ("tracing", "tracing_missing"):
        with pytest.raises(AttributeError, match=name):
            getattr(util, name)


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    q = ray_tpu_torch.util.Queue()
    q.put(1)
    assert q.get() == 1
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
