"""The port's object plane end to end (``ray_tpu_torch.init`` -> ``put``,
``get``, tasks with large arguments and returns, spilling, pulls and
relay between raylets, lineage reconstruction) against the JAX package's,
on the CPU.

Each case runs once on a cluster of the JAX package (its ``Cluster``
under ``ray_tpu.init(_cluster=...)``) and once on the port's
(``LocalCluster(device="cpu")`` under ``ray_tpu_torch.init``), built
the same way from the same numpy seed, and the two outcomes must be
equal: the values, the error's type and message (ids masked, the
package's name read as one), or the invariant the JAX package's own
test asserts where exact counts depend on the spill thread's and the
pulls' timing (``spilled_objects > 0``, ``restored_objects > 0``, the
origin's served bytes within twice the object in a chained broadcast,
no cross-node bytes under locality).  The JAX package's node stores are
built python-held (``use_native_object_store = False``), as the port's
are, except in the chained broadcast, whose chain needs its segment
path; that case asserts the invariants of each package alone.  The
reference's relay tests slow each chunk with a fault point, which the
port does not have: here ``monkeypatch`` slows each package's transfer
writer instead.  The cases are ``tests/test_basic.py``'s two large
objects, ``tests/test_object_store.py``'s cluster cases,
``tests/test_spill.py``'s end-to-end cases and its ``/metrics`` series,
``tests/test_multi_node.py``'s transfer, ``tests/test_failure.py``'s
reconstruction and unrecoverable loss (a task with lineage pinning off,
where the reference's loses an actor's return: the port has no actors
yet), ``tests/test_reference_counting_2.py``'s ``TestLineageInteraction``
and ``TestStoreRelease``, ``tests/test_unified_scheduler.py``'s locality
case and ``tests/test_relay.py``'s ``TestChainBroadcast``.  A ``gpu``
twin runs the port's cases on raylets whose tick runs on the card
against ``device="cpu"``; the last test checks that no thread of the
port outlives ``shutdown``.
"""

import gc
import importlib
import os
import re
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch

try:  # the card's machine has no JAX; the tests marked gpu need none
    import ray_tpu
except ImportError:
    ray_tpu = None

PORT = "ray_tpu_torch"
MB = 1024 * 1024
BIG = 2 * MB    # node-store sized (test_reference_counting_2.py)


# -- task bodies (module level: exported by reference) ------------------------

def _sum(a):
    return float(a.sum())


def _ones(n, dtype):
    return np.ones(n, dtype=dtype)


def _arange(n):
    return np.arange(n, dtype=np.float32)


def _arange_mod(n, mod):
    return np.arange(n, dtype=np.uint8) % mod


def _zeros(n):
    return np.zeros(n, dtype=np.uint8)


def _full(n, v):
    return np.full(n, v, dtype=np.uint8)


def _first(a):
    return int(a[0])


def _first_and_node(pkg_name, x):
    ctx = importlib.import_module(pkg_name).get_runtime_context()
    return float(x[0]), ctx.get_node_id()


def _slow_one():
    time.sleep(0.2)
    return 1


def _echo_big(a):
    return a * 2


# -- running a case on each package's cluster ---------------------------------

def _normalize(message):
    message = message.replace("ray_tpu_torch", "ray_tpu")
    return re.sub(r"[0-9a-f]{12,}", "<id>", message)


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("raise", type(e).__name__, _normalize(str(e)))


class _Env:
    """One package's cluster, with the calls a case needs in one
    spelling.  Its ``temp_dir`` (where the node stores spill) is a fresh
    temporary directory, removed by ``close``; the config that names it
    is set before the cluster is built, whose head reads it, and passed
    on to ``init``, which rebuilds the config that the nodes added later
    read.  ``shutdown`` ends the runtime, then ``close``s."""

    def __init__(self, name, head_cpus=1, object_store_memory=None,
                 native=False, system_config=None, device="cpu"):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.temp_dir = tempfile.mkdtemp(prefix=f"{name}-")
        system_config = {"temp_dir": self.temp_dir, **(system_config or {})}
        if name == PORT:
            from ray_tpu_torch._private.cluster import LocalCluster
            self._config_module().initialize_config(system_config)
            self.cluster = LocalCluster(device=device)
            self.cluster.add_node({"CPU": float(head_cpus)},
                                  node_name="head",
                                  object_store_memory=object_store_memory)
        else:
            from ray_tpu._private.cluster import Cluster
            # Python-held unless the case needs the segment
            # (test_spill.py:55).
            system_config["use_native_object_store"] = native
            self._config_module().initialize_config(system_config)
            self.cluster = Cluster(initialize_head=True, head_node_args=dict(
                num_cpus=head_cpus,
                object_store_memory=object_store_memory))
        self.pkg.init(_cluster=self.cluster, _system_config=system_config)

    def _config_module(self):
        return importlib.import_module(f"{self.name}._private.config")

    def shutdown(self):
        try:
            self.pkg.shutdown()
        finally:
            self.close()

    def close(self):
        """Back to the default config; the temporary directory goes."""
        self._config_module().initialize_config()
        shutil.rmtree(self.temp_dir, ignore_errors=True)

    @property
    def head(self):
        return self.cluster.head_node

    def add_node(self, cpus=0, resources=None, object_store_memory=None):
        if self.name == PORT:
            res = {"CPU": float(cpus), **(resources or {})}
            return self.cluster.add_node(
                {k: v for k, v in res.items() if v},
                object_store_memory=object_store_memory)
        node = self.cluster.add_node(num_cpus=cpus, resources=resources,
                                     object_store_memory=object_store_memory)
        assert self.cluster.wait_for_nodes(len(self.cluster.raylets()))
        return node

    def core(self):
        return importlib.import_module(
            f"{self.name}._private.worker").global_worker().core_worker

    def config(self):
        return self._config_module().get_config()

    def store_module(self):
        return importlib.import_module(f"{self.name}._private.object_store")

    def metrics_text(self):
        return importlib.import_module(
            f"{self.name}._private.metrics_agent") \
            .get_metrics_registry().render_prometheus()

    def gone(self, oid, timeout=5.0):
        """True once the owner drops its last reference to ``oid``."""
        rc = self.core().reference_counter
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gc.collect()
            if not rc.has_reference(oid):
                return True
            time.sleep(0.02)
        return False


def _run(name, case, seed, env_kw=None):
    env = _Env(name, **(env_kw or {}))
    try:
        return _outcome(lambda: case(env, np.random.default_rng(seed)))
    finally:
        env.shutdown()


def _both(case, seed=0, env_kw=None):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [_run(name, case, seed, env_kw) for name in ("ray_tpu", PORT)]


def _wait_until(pred, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# -- tests/test_basic.py ------------------------------------------------------

def case_large_object_through_node_store(env, rng):
    x = rng.integers(0, 255, 10 * MB, dtype=np.uint8)
    ref = env.pkg.put(x)
    y = env.pkg.get(ref)
    oid = ref.object_id()
    return (y.nbytes, bool((y == x).all()),
            env.head.node_id in env.cluster.object_directory.get_locations(
                oid),
            env.head.object_store.contains(oid),
            env.core().memory_store.contains(oid))


def case_large_arg_promotion(env, rng):
    big = rng.random(2 * 1024 * 1024)
    s = env.pkg.remote(_sum)
    back = env.pkg.get(env.pkg.remote(_echo_big).remote(big[:MB]))
    return env.pkg.get(s.remote(big)) == float(big.sum()), \
        bool((back == big[:MB] * 2).all())


# -- tests/test_object_store.py -----------------------------------------------

def case_spilling_and_restore(env, rng):
    env.config().object_spilling_threshold = 0.5
    refs = [env.pkg.put(np.full(3 * MB // 8, i, dtype=np.float64))
            for i in range(8)]
    store = env.head.object_store
    spilled = store.stats["spilled_objects"] > 0
    values = [env.pkg.get(ref)[0] for ref in refs]
    return values, spilled, store.stats["restored_objects"] > 0


def case_store_capacity_error(env, rng):
    return env.pkg.put(np.zeros(8 * MB, dtype=np.uint8))


def case_free_objects_api(env, rng):
    ref = env.pkg.put(np.zeros(1024))
    env.core().free_objects([ref])
    return env.pkg.get(ref, timeout=0.2)


def case_stale_self_location(env, rng):
    node2 = env.add_node(1, {"src": 1})
    produce = env.pkg.remote(resources={"src": 0.5}, num_cpus=0)(_arange)
    ref = produce.remote(200_000)
    oid = ref.object_id()
    landed = _wait_until(lambda: node2.object_store.contains(oid), 30)
    env.cluster.object_directory.add_location(oid, env.head.node_id)
    stale = env.head.object_store.contains(oid)
    done = threading.Event()
    ok_box = []
    env.head.object_manager.pull_async(
        oid, lambda ok: (ok_box.append(ok), done.set()))
    return (landed, stale, done.wait(timeout=30), ok_box,
            env.head.object_store.contains(oid),
            bool((env.pkg.get(ref) == _arange(200_000)).all()))


# -- tests/test_spill.py ------------------------------------------------------

def case_put_2x_capacity(env, rng):
    store = env.head.object_store
    arrays = [rng.integers(0, 255, 3 * MB, dtype=np.uint8)
              for _ in range(16)]
    refs = [env.pkg.put(a) for a in arrays]
    spilled = store.stats["spilled_objects"] > 0
    return spilled, [bool((env.pkg.get(r) == a).all())
                     for a, r in zip(arrays, refs)]


def case_arg_pins_released(env, rng):
    store = env.head.object_store
    ref = env.pkg.put(np.arange(2 * MB, dtype=np.uint8) % 199)
    got = env.pkg.get(env.pkg.remote(_first).remote(ref), timeout=30)
    oid = ref.object_id()
    released = _wait_until(lambda: store.get(oid).pin_count == 0, 10)
    return got, released, store.spill_now() >= 1, \
        store.get(oid).spilled_path is not None


def case_pull_served_from_spilled_file(env, rng):
    producer = env.add_node(1, {"prod": 1}, object_store_memory=32 * MB)
    produce = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0)(
        _arange_mod)
    ref = produce.remote(4 * MB, 233)
    ready, _ = env.pkg.wait([ref], timeout=15)
    src = producer.object_store
    spilled = src.spill_now() >= 1
    restored_before = src.stats["restored_objects"]
    value = env.pkg.get(ref, timeout=15)
    return (len(ready), spilled,
            bool((value == _arange_mod(4 * MB, 233)).all()),
            src.stats["restored_objects"] == restored_before)


def case_backpressure_series(env, rng):
    store = env.head.object_store
    ref = env.pkg.put(np.zeros(2 * MB, np.uint8))
    spilled = store.spill_now() >= 1
    env.pkg.get(ref)                     # a restore
    text = env.metrics_text()
    return spilled, [name in text for name in (
        "ray_tpu_object_store_spilled_bytes",
        "ray_tpu_object_store_restored_bytes",
        "ray_tpu_object_store_create_queue_depth",
        "ray_tpu_object_store_create_queue_wait_ms",
        "ray_tpu_lineage_reconstructions",
        "ray_tpu_local_object_manager_spill_batches",
        "ray_tpu_object_manager_cross_node_fetch_bytes")]


# -- tests/test_multi_node.py, tests/test_failure.py --------------------------

def case_cross_node_transfer(env, rng):
    env.add_node(1, {"there": 1})
    produce = env.pkg.remote(resources={"there": 0.5}, num_cpus=0)(_arange)
    consume = env.pkg.remote(num_cpus=1)(_sum)
    got = env.pkg.get(consume.remote(produce.remote(1_000_000)))
    fetched = sum(r.object_manager.stats["cross_node_fetch_bytes"]
                  for r in env.cluster.raylets())
    return got == float(_arange(1_000_000).sum()), fetched > 0


def case_reconstruction_on_node_loss(env, rng):
    producer = env.add_node(1, {"prod": 1})
    produce = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0,
                             max_retries=2)(_ones)
    ref = produce.remote(2_000_000, np.float32)
    first = env.pkg.get(ref).sum()
    # A second object only the producer holds (waited on, never
    # fetched): removing the node loses its last copy.
    only = produce.remote(2_000_000, np.float32)
    ready, _ = env.pkg.wait([only], timeout=10)
    env.add_node(1, {"prod": 1})
    env.cluster.remove_node(producer)
    time.sleep(0.3)
    again = env.pkg.get(ref, timeout=15).sum()
    rebuilt = env.pkg.get(only, timeout=15).sum()
    return (first, again, len(ready), rebuilt,
            env.core().metrics["lineage_reconstructions"] >= 1)


def case_unrecoverable_loss(env, rng):
    producer = env.add_node(1, {"prod": 1})
    make = env.pkg.remote(resources={"prod": 0.1}, num_cpus=0,
                          max_retries=0)(_ones)
    ref = make.remote(2_000_000, np.float32)
    ready, _ = env.pkg.wait([ref], timeout=10)
    env.cluster.remove_node(producer)
    time.sleep(0.3)
    t0 = time.monotonic()
    out = _outcome(lambda: env.pkg.get(ref, timeout=20))
    return len(ready), out, time.monotonic() - t0 < 10


# -- tests/test_reference_counting_2.py ---------------------------------------

def case_lineage_evicted_on_free(env, rng):
    ref = env.pkg.remote(_ones).remote(8, np.float64)
    env.pkg.get(ref)
    task_id = ref.task_id()
    tm = env.core().task_manager
    pinned = tm.lineage_spec_for_object(ref.object_id()) is not None
    del ref
    gc.collect()
    return pinned, _wait_until(lambda: tm._lineage.get(task_id) is None, 5)


def case_get_after_free_raises_promptly(env, rng):
    ref = env.pkg.remote(_zeros).remote(BIG)
    env.pkg.get(ref)
    env.core().free_objects([ref])
    env.core().task_manager.evict_lineage(ref.task_id())
    return env.pkg.get(ref, timeout=5)


def case_recover_after_free_with_lineage(env, rng):
    ref = env.pkg.remote(max_retries=2)(_full).remote(BIG, 3)
    first = env.pkg.get(ref)
    oid = ref.object_id()
    env.head.object_store.delete(oid)
    env.core().memory_store.delete(oid)
    env.cluster.object_directory.remove_object(oid)
    again = env.pkg.get(ref, timeout=15)
    return int(first[0]), int(again[0]), again.shape == first.shape


def case_memory_store_evicted(env, rng):
    ref = env.pkg.put("small-value")
    oid = ref.object_id()
    before = env.core().memory_store.contains(oid)
    del ref
    return before, env.gone(oid), env.core().memory_store.contains(oid)


def case_node_store_and_directory_evicted(env, rng):
    ref = env.pkg.put(np.zeros(BIG, dtype=np.uint8))
    oid = ref.object_id()
    directory = env.cluster.object_directory
    before = bool(directory.get_locations(oid))
    del ref
    return (before, env.gone(oid), bool(directory.get_locations(oid)),
            env.head.object_store.contains(oid))


def case_return_value_store_release(env, rng):
    ref = env.pkg.remote(_zeros).remote(BIG)
    env.pkg.get(ref)
    oid = ref.object_id()
    held = env.head.object_store.contains(oid)
    del ref
    return held, env.gone(oid), env.head.object_store.contains(oid)


def case_wait_does_not_leak_refs(env, rng):
    refs = [env.pkg.remote(_slow_one).remote() for _ in range(4)]
    ready, rest = env.pkg.wait(refs, num_returns=4, timeout=10)
    n = len(ready)
    oids = [r.object_id() for r in refs]
    del refs, ready, rest
    text = env.metrics_text()
    return n, [env.gone(oid) for oid in oids], [name in text for name in (
        "ray_tpu_scheduler_tick_spillbacks_no_capacity",
        "ray_tpu_scheduler_tick_spillbacks_locality_override")]


# -- tests/test_unified_scheduler.py ------------------------------------------

def case_locality_zeroes_cross_node_fetch(env, rng):
    """With the arg-locality cost live, a burst of consumers of a
    B-resident object runs on B and moves no bytes between nodes
    (retried with a fresh object, up to 3 attempts, as the
    reference)."""
    node_b = env.add_node(4, {"b": 1})
    time.sleep(0.3)
    produce = env.pkg.remote(resources={"b": 0.01}, num_cpus=0)(_ones)
    consume = env.pkg.remote(num_cpus=1)(_first_and_node)

    def fetch_bytes():
        return sum(n.object_manager.stats["cross_node_fetch_bytes"]
                   for n in (env.head, node_b))

    b_hex = node_b.node_id.hex()
    for attempt in range(3):
        ref = produce.remote(600_000, np.float64)
        env.pkg.wait([ref], timeout=30)
        before = fetch_bytes()
        out = env.pkg.get([consume.remote(env.name, ref)
                           for _ in range(4)], timeout=60)
        where = {n for _, n in out}
        if where == {b_hex} and fetch_bytes() == before:
            break
    return ([v for v, _ in out], where == {b_hex},
            fetch_bytes() - before,
            "ray_tpu_object_manager_cross_node_fetch_bytes"
            in env.metrics_text())


E2E_CASES = [case_large_object_through_node_store, case_large_arg_promotion,
             case_free_objects_api, case_stale_self_location,
             case_arg_pins_released, case_pull_served_from_spilled_file,
             case_cross_node_transfer, case_reconstruction_on_node_loss,
             case_lineage_evicted_on_free,
             case_get_after_free_raises_promptly,
             case_recover_after_free_with_lineage,
             case_memory_store_evicted,
             case_node_store_and_directory_evicted,
             case_return_value_store_release, case_wait_does_not_leak_refs,
             case_locality_zeroes_cross_node_fetch]

#: Cases that need a head of its own shape: (env kwargs, expected).
SHAPED = {
    "spilling_and_restore": (case_spilling_and_restore,
                             dict(object_store_memory=20 * MB, head_cpus=2)),
    "store_capacity_error": (case_store_capacity_error,
                             dict(object_store_memory=4 * MB)),
    "put_2x_capacity": (case_put_2x_capacity,
                        dict(object_store_memory=24 * MB, head_cpus=2)),
    "arg_pins_released": (case_arg_pins_released,
                          dict(object_store_memory=16 * MB, head_cpus=2)),
    "pull_served_from_spilled_file": (case_pull_served_from_spilled_file,
                                      dict(object_store_memory=32 * MB)),
    "backpressure_series": (case_backpressure_series,
                            dict(object_store_memory=16 * MB)),
    "unrecoverable_loss": (case_unrecoverable_loss, dict(
        system_config={"lineage_pinning_enabled": False})),
    "locality_zeroes_cross_node_fetch": (
        case_locality_zeroes_cross_node_fetch, dict(head_cpus=4)),
}


def _env_kw(case):
    name = case.__name__[len("case_"):]
    return SHAPED[name][1] if name in SHAPED else {}


ALL_CASES = E2E_CASES + [SHAPED[k][0] for k in
                         ("spilling_and_restore", "store_capacity_error",
                          "put_2x_capacity", "backpressure_series",
                          "unrecoverable_loss")]


def _name(case):
    return case.__name__[len("case_"):]


#: The value each case's test in the JAX package asserts.
EXPECTED = {
    "large_object_through_node_store": ("value",
                                        (10 * MB, True, True, True, False)),
    "large_arg_promotion": ("value", (True, True)),
    "free_objects_api": ("raise", "GetTimeoutError"),
    "stale_self_location": ("value", (True, False, True, [True], True,
                                      True)),
    "arg_pins_released": ("value", (0, True, True, True)),
    "pull_served_from_spilled_file": ("value", (1, True, True, True)),
    "cross_node_transfer": ("value", (True, True)),
    "reconstruction_on_node_loss": ("value", (2e6, 2e6, 1, 2e6, True)),
    "lineage_evicted_on_free": ("value", (True, True)),
    "recover_after_free_with_lineage": ("value", (3, 3, True)),
    "memory_store_evicted": ("value", (True, True, False)),
    "node_store_and_directory_evicted": ("value", (True, True, False,
                                                   False)),
    "return_value_store_release": ("value", (True, True, False)),
    "wait_does_not_leak_refs": ("value", (4, [True] * 4, [True, True])),
    "locality_zeroes_cross_node_fetch": ("value", ([1.0] * 4, True, 0,
                                                   True)),
    "spilling_and_restore": ("value", (list(range(8)), True, True)),
    "store_capacity_error": ("raise", "ObjectStoreFullError"),
    "put_2x_capacity": ("value", (True, [True] * 16)),
    "backpressure_series": ("value", (True, [True] * 7)),
}


def _check_expected(name, out):
    want = EXPECTED.get(name)
    if want is None:
        return
    if want[0] == "raise":
        assert out[:2] == want, out
    else:
        assert out == want, out


@pytest.mark.parametrize("case", ALL_CASES, ids=_name)
def test_object_plane_case_matches_jax(case):
    jax_out, port_out = _both(case, seed=ALL_CASES.index(case),
                              env_kw=_env_kw(case))
    assert port_out == jax_out
    _check_expected(_name(case), port_out)


def test_get_after_free_raises_an_object_lost_error():
    """The port's outcome of ``case_get_after_free_raises_promptly``
    (the reference's test takes either ObjectLostError or a timeout)."""
    out = _run(PORT, case_get_after_free_raises_promptly, 0)
    assert out[:2] == ("raise", "ObjectLostError"), out
    assert "lineage=not pinned" in out[2]


def test_unrecoverable_loss_names_the_cause():
    """``tests/test_failure.py:104-133``'s outcome: a prompt
    ObjectLostError with the reference's message."""
    out = _run(PORT, case_unrecoverable_loss, 0,
               _env_kw(case_unrecoverable_loss))
    assert out[0] == "value" and out[1][0] == 1 and out[1][2], out
    kind, err, message = out[1][1]
    assert (kind, err) == ("raise", "ObjectLostError"), out
    assert message.startswith("Object ObjectID(<id>) lost: all copies lost "
                              "and "
                              "lineage reconstruction unavailable; owner "
                              "worker=this driver (<id>); known "
                              "locations=none; lineage=not pinned"), message


def _o5_burst(one_class):
    from ray_tpu_torch._private.cluster import LocalCluster
    from ray_tpu_torch.tools import profile_objects as po
    cluster = LocalCluster(device="cpu")
    cluster.add_node({"CPU": 4.0}, node_name="a")
    home = cluster.add_node({"CPU": 4.0, "b": 1.0}, node_name="b")
    ray_tpu_torch.init(_cluster=cluster)
    try:
        out = po._locality_burst(ray_tpu_torch, cluster, home, 4, 3,
                                 one_class)
        totals = po._solver_totals(cluster)
    finally:
        ray_tpu_torch.shutdown()
    return out, totals


def test_locality_burst_takes_the_cost_tick():
    """O5's 2-raylet probe (``tools.profile_objects``) on the CPU: the
    consumers, one scheduling class each, reach the holder's tick
    together, whose batched solve builds the arg-locality cost from the
    directory; all run on the holder and no byte moves."""
    out, totals = _o5_burst(one_class=False)
    assert out["share_on_home"] == 1.0 and \
        out["cross_node_fetch_bytes"] == 0, out
    assert totals["cost_ticks"] >= 1, totals


def test_one_class_locality_burst_never_reaches_the_cost():
    """O5's 2-raylet case at ``tests/test_unified_scheduler.py:377-417``'s
    shape: 4 consumers of one function are leased one at a time, so the
    lease policy and the greedy tick place them all on the holder, with
    no byte moved and no batched tick with the locality cost."""
    out, totals = _o5_burst(one_class=True)
    assert out["share_on_home"] == 1.0 and \
        out["cross_node_fetch_bytes"] == 0, out
    assert totals["cost_ticks"] == 0, totals


# -- tests/test_relay.py's TestChainBroadcast ---------------------------------

def _slow_writers(monkeypatch, name, delay_s=0.02):
    """Each chunk a transfer writer takes sleeps first: the reference's
    ``transfer.chunk`` delay, on the receiver's side."""
    store_mod = importlib.import_module(f"{name}._private.object_store")
    for cls_name in ("_HeapTransferWriter", "_SegmentTransferWriter"):
        cls = getattr(store_mod, cls_name, None)
        if cls is None:
            continue
        write = cls.write

        def slow(self, offset, data, _write=write):
            time.sleep(delay_s)
            return _write(self, offset, data)
        monkeypatch.setattr(cls, "write", slow)


def _broadcast(nodes, oid):
    events, results = [], []
    for node in nodes:
        ev = threading.Event()
        res = {}

        def cb(ok, ev=ev, res=res):
            res["ok"] = ok
            ev.set()

        node.object_manager.pull_async(oid, cb)
        events.append(ev)
        results.append(res)
        # Stagger just enough for the chain to see the predecessor's
        # in-flight transfer.
        _wait_until(lambda n=node, e=ev: n.object_store.num_partials() > 0
                    or e.is_set(), timeout=20)
    return [ev.wait(timeout=120) for ev in events], \
        [r.get("ok") for r in results]


@pytest.mark.parametrize("name", ["ray_tpu", PORT])
def test_chain_broadcast_origin_serves_fair_share(name, monkeypatch):
    """``TestChainBroadcast.test_chain_broadcast_origin_serves_fair_share``
    for each package: 4 nodes pull one 4 MiB object under one outbound
    session per store, each chunk slowed; every copy equal, the origin
    serving at most twice the object, the rest relayed."""
    if name == "ray_tpu" and ray_tpu is None:
        pytest.skip("needs the JAX package")
    env = _Env(name, native=True)
    try:
        cfg = env.config()
        monkeypatch.setattr(cfg, "object_transfer_max_outbound_sessions", 1)
        monkeypatch.setattr(cfg, "object_manager_chunk_size", 256 * 1024)
        nodes = [env.add_node(0, object_store_memory=64 * MB)
                 for _ in range(4)]
        arr = np.arange(4 * MB, dtype=np.uint8) % 251
        ref = env.pkg.put(arr)
        oid = ref.object_id()
        head = env.head
        size = head.object_store.get(oid).size
        origin_before = head.object_store.stats["outbound_served_bytes"]
        _slow_writers(monkeypatch, name)
        done, oks = _broadcast(nodes, oid)
        assert all(done) and all(oks), (done, oks)
        entry_value = env.store_module().entry_value
        for node in nodes:
            assert (entry_value(node.object_store.get(oid)) == arr).all()
        served = head.object_store.stats["outbound_served_bytes"] \
            - origin_before
        assert 0 < served <= 2 * size, (served, size)
        relayed = sum(n.object_store.stats["relay_served_bytes"]
                      for n in nodes)
        relay_pulls = sum(n.object_manager.stats["relay_pulls"]
                          for n in nodes)
        assert relayed > 0 and relay_pulls >= 2, (relayed, relay_pulls)
        assert all(not row.get("partial") for row in
                   env.cluster.object_directory.get_candidates(oid))
    finally:
        env.shutdown()


def case_naive_arm(env, rng):
    """``TestChainBroadcast.test_naive_arm_still_correct``: first-row
    sources, relay off, every copy right and nothing relayed."""
    cfg = env.config()
    cfg.object_transfer_source_selection = "first"
    cfg.object_transfer_relay_enabled = False
    nodes = [env.add_node(0, object_store_memory=64 * MB)
             for _ in range(3)]
    arr = np.arange(2 * MB, dtype=np.uint8) % 239
    ref = env.pkg.put(arr)
    oid = ref.object_id()
    done = []
    for node in nodes:
        ev = threading.Event()
        node.object_manager.pull_async(oid, lambda ok, e=ev: e.set())
        done.append(ev)
    entry_value = env.store_module().entry_value
    return ([ev.wait(timeout=60) for ev in done],
            [bool((entry_value(n.object_store.get(oid)) == arr).all())
             for n in nodes],
            [n.object_store.stats["relay_served_bytes"] for n in nodes],
            [n.object_store.num_partials() for n in nodes])


def test_naive_arm_matches_jax():
    jax_out, port_out = _both(case_naive_arm, 0)
    assert port_out == jax_out
    assert port_out == ("value", ([True] * 3, [True] * 3, [0] * 3,
                                  [0] * 3))


# -- the configuration and the card -------------------------------------------

def test_native_object_store_raises_naming_its_item():
    from ray_tpu_torch._private.config import initialize_config
    try:
        with pytest.raises(NotImplementedError, match="A.4b.2b"):
            ray_tpu_torch.init(num_cpus=1, device="cpu", _system_config={
                "use_native_object_store": True})
        assert not ray_tpu_torch.is_initialized()
    finally:
        initialize_config()     # a cluster built before init reads it


def test_each_package_spills_under_its_own_directory():
    """The two runtimes of one process spill apart: the port under its
    own temporary directory, the JAX package under its ``temp_dir``;
    a removed raylet takes its spill directory with it."""
    from ray_tpu_torch._private.config import Config
    env = _Env(PORT, object_store_memory=8 * MB)
    try:
        spill_dir = env.head.object_store.spill_dir
        assert spill_dir.startswith(env.config().temp_dir)
        assert "ray_tpu_torch" in Config().temp_dir
        if ray_tpu is not None:
            from ray_tpu._private.config import Config as JaxConfig
            assert not spill_dir.startswith(JaxConfig().temp_dir + "/")
        ref = env.pkg.put(np.zeros(2 * MB, np.uint8))
        assert env.head.object_store.spill_now() == 1
        node = env.add_node(1)
        node_dir = node.object_store.spill_dir
        assert env.pkg.get(ref).nbytes == 2 * MB
    finally:
        env.pkg.shutdown()
    try:
        assert not os.path.exists(spill_dir) and \
            not os.path.exists(node_dir)
    finally:
        env.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raylets' tick runs its "
                    "kernel only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALL_CASES + [case_naive_arm], ids=_name)
def test_object_plane_case_on_card_matches_cpu(case, cuda_device):
    """The end-to-end cases with every raylet's tick on the card,
    against the port with ``device="cpu"``."""
    seed = (ALL_CASES + [case_naive_arm]).index(case)
    card = _run(PORT, case, seed, dict(_env_kw(case), device="cuda"))
    host = _run(PORT, case, seed, _env_kw(case))
    assert card == host
    _check_expected(_name(case), card)


def test_no_port_thread_survives_shutdown():
    """Runs last in this file: every pull, spill, worker and loop thread
    of the cases above is gone."""
    env = _Env(PORT, object_store_memory=8 * MB)
    node = env.add_node(1, {"n": 1})
    ref = env.pkg.put(np.zeros(4 * MB, np.uint8))
    env.head.object_store.spill_now()
    f = env.pkg.remote(resources={"n": 1}, num_cpus=0)(_sum)
    assert env.pkg.get(f.remote(ref)) == 0.0
    assert node.object_manager.stats["pulled_objects"] == 1
    env.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
