"""The port's GCS (``ray_tpu_torch.gcs``: storage, pubsub, the KV, the job
and node managers, ``GcsServer`` over a file store) against the JAX
package's, on the CPU.

Each case drives the same script, made from a numpy seed, through the
JAX package's module and the port's, and compares the outcomes exactly;
time stamps (``start_time``, ``end_time``, ``suspect_since``) are left out
of the comparison, since the two runs take them at different instants.
The cases are those of ``tests/test_gcs.py`` and of
``tests/test_pubsub_batching.py::TestInProcessCoalescing``, each run on
both packages, plus the node manager's incarnations and fencing counts.
"""

import importlib
import threading
import time

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
STAMPS = ("start_time", "end_time", "suspect_since")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(case, *args):
    """``case(pkg, *args)`` on each package: the JAX outcome, the port's."""
    return [case(pkg, *args) for pkg in PACKAGES]


def unstamped(info):
    return {k: v for k, v in info.items() if k not in STAMPS}


def _script(seed, n=200, keys=24):
    """A seeded script of (op, table, key, value) over a few tables."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        op = "put" if rng.random() < 0.7 else "del"
        table = ("node", "job", "kv")[int(rng.integers(3))]
        key = b"k%d" % int(rng.integers(keys))
        ops.append((op, table, key, {"v": int(rng.integers(1000))}))
    return ops


def _apply(store, ops):
    deleted = []
    for op, table, key, value in ops:
        if op == "put":
            store.put(table, key, value)
        else:
            deleted.append(store.delete(table, key))
    return deleted


def _contents(store):
    return {t: sorted(store.get_all(t)) for t in ("node", "job", "kv")}


# -- storage --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_memory_store_matches_jax(seed):
    def case(pkg):
        store = mod(pkg, "gcs.storage").InMemoryStoreClient()
        deleted = _apply(store, _script(seed))
        return deleted, _contents(store), sorted(store.keys("kv", b"k1"))
    jax, port = both(case)
    assert port == jax


def test_file_journal_reload_matches_jax(tmp_path):
    """The journal replays to the same tables in each package, and each
    package reads the other's journal (the records are the same)."""
    ops = _script(2)

    def case(pkg):
        storage = mod(pkg, "gcs.storage")
        path = str(tmp_path / f"{pkg}.bin")
        first = storage.FileStoreClient(path)
        _apply(first, ops)
        reloaded = storage.FileStoreClient(path)
        return path, _contents(first), _contents(reloaded)
    (jpath, jfirst, jreload), (ppath, pfirst, preload) = both(case)
    assert pfirst == jfirst and preload == jreload == jfirst
    jax_reads_port = mod("ray_tpu", "gcs.storage").FileStoreClient(ppath)
    port_reads_jax = mod("ray_tpu_torch", "gcs.storage").FileStoreClient(
        jpath)
    assert _contents(jax_reads_port) == _contents(port_reads_jax) == jfirst


def test_truncated_journal_tail_is_dropped_as_in_jax(tmp_path):
    def case(pkg):
        storage = mod(pkg, "gcs.storage")
        path = str(tmp_path / f"{pkg}.bin")
        _apply(storage.FileStoreClient(path), _script(3, n=40))
        with open(path, "ab") as f:
            f.write(b"\x80\x04\x95truncated")
        return _contents(storage.FileStoreClient(path))
    jax, port = both(case)
    assert port == jax


def test_typed_tables_match_jax():
    def case(pkg):
        storage = mod(pkg, "gcs.storage")
        ids = mod(pkg, "_private.ids")
        tables = storage.GcsTableStorage(storage.InMemoryStoreClient())
        node = ids.NodeID(bytes(range(ids.NodeID.SIZE)))
        tables.job_table.put(b"j1", {"state": "RUNNING"})
        tables.node_table.put(node, {"state": "ALIVE"})
        tables.placement_group_table.put("pg", {"state": "CREATED"})
        return (tables.job_table.get(b"j1"), tables.actor_table.get(b"j1"),
                tables.node_table.get(node.binary()),
                sorted(tables.placement_group_table.get_all()),
                tables.kv_table.get_all(), tables.actor_table.get_all())
    jax, port = both(case)
    assert port == jax


# -- pubsub ---------------------------------------------------------------------

def test_key_and_channel_subscription_match_jax():
    def case(pkg):
        pubsub = mod(pkg, "gcs.pubsub")
        pub = pubsub.Publisher()
        got_key, got_all = [], []
        pub.subscribe(pubsub.ACTOR_CHANNEL, b"a1",
                      lambda k, m: got_key.append((k, m)))
        pub.subscribe(pubsub.ACTOR_CHANNEL, None,
                      lambda k, m: got_all.append((k, m)))
        rng = np.random.default_rng(4)
        for i in range(50):
            pub.publish(pubsub.ACTOR_CHANNEL,
                        b"a%d" % int(rng.integers(3)), i)
        pub.publish(pubsub.NODE_CHANNEL, b"a1", "other channel")
        return got_key, got_all, pub.stats["published"]
    jax, port = both(case)
    assert port == jax


def test_unsubscribe_matches_jax():
    def case(pkg):
        pubsub = mod(pkg, "gcs.pubsub")
        pub = pubsub.Publisher()
        got = []
        sid = pub.subscribe(pubsub.ACTOR_CHANNEL, b"a",
                            lambda k, m: got.append(m))
        pub.publish(pubsub.ACTOR_CHANNEL, b"a", 1)
        pub.unsubscribe(pubsub.ACTOR_CHANNEL, b"a", sid)
        pub.publish(pubsub.ACTOR_CHANNEL, b"a", 2)
        return got
    jax, port = both(case)
    assert port == jax == [1]


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_burst_coalescing_matches_jax():
    """A 300-message burst to a publisher on a parked loop: every
    message delivered in order to a channel and a key subscriber, one
    drain post a subscriber (a few more may race the drain)."""
    def case(pkg):
        loop = mod(pkg, "_private.event_loop").EventLoop(f"coalesce-{pkg}")
        try:
            pub = mod(pkg, "gcs.pubsub").Publisher(event_loop=loop)
            a_got, b_got = [], []
            pub.subscribe("CH", None, lambda k, m: a_got.append(m))
            pub.subscribe("CH", b"k", lambda k, m: b_got.append(m))
            gate = threading.Event()
            loop.post(gate.wait, name="block")
            n = 300
            for i in range(n):
                pub.publish("CH", b"k", i)
            gate.set()
            assert _wait_until(lambda: len(a_got) == n and len(b_got) == n)
            drains = loop.handler_stats.get("pubsub.drain",
                                            {}).get("count", 0)
            assert pub.stats["drain_posts"] == drains
            return a_got, b_got, 0 < drains <= 8
        finally:
            loop.stop()
    jax, port = both(case)
    assert port == jax
    assert port[2] and port[0] == list(range(300))


def test_unsubscribe_drops_queued_mailbox_as_in_jax():
    def case(pkg):
        loop = mod(pkg, "_private.event_loop").EventLoop(f"unsub-{pkg}")
        try:
            pub = mod(pkg, "gcs.pubsub").Publisher(event_loop=loop)
            got = []
            gate = threading.Event()
            sid = pub.subscribe("CH", None, lambda k, m: got.append(m))
            loop.post(gate.wait, name="block")
            pub.publish("CH", b"k", "queued")
            pub.unsubscribe("CH", None, sid)
            gate.set()
            time.sleep(0.2)
            return got
        finally:
            loop.stop()
    jax, port = both(case)
    assert port == jax == []


# -- the internal KV -----------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6])
def test_kv_namespaces_match_jax(seed):
    def case(pkg):
        storage = mod(pkg, "gcs.storage")
        kv = mod(pkg, "gcs.server").GcsInternalKV(
            storage.GcsTableStorage(storage.InMemoryStoreClient()))
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(300):
            ns = (None, b"ns1", b"ns2")[int(rng.integers(3))]
            key = b"key%d" % int(rng.integers(10))
            op = int(rng.integers(5))
            if op == 0:
                out.append(kv.put(key, b"v%d" % int(rng.integers(100)),
                                  overwrite=bool(rng.integers(2)),
                                  namespace=ns))
            elif op == 1:
                out.append(kv.get(key, namespace=ns))
            elif op == 2:
                out.append(kv.delete(key, namespace=ns))
            elif op == 3:
                out.append(kv.exists(key, namespace=ns))
            else:
                out.append(sorted(kv.keys(b"key1", namespace=ns)))
        return out
    jax, port = both(case)
    assert port == jax


# -- the job and node managers ----------------------------------------------

def _managers(pkg):
    storage = mod(pkg, "gcs.storage")
    pubsub = mod(pkg, "gcs.pubsub")
    tables = storage.GcsTableStorage(storage.InMemoryStoreClient())
    pub = pubsub.Publisher()
    seen = []
    for channel in (pubsub.JOB_CHANNEL, pubsub.NODE_CHANNEL):
        pub.subscribe(channel, None,
                      lambda k, m, c=channel: seen.append((c, k, m)))
    return tables, pub, seen


def _message(m):
    if isinstance(m, dict) and "info" in m:
        return dict(m, info=unstamped(m["info"]))
    return unstamped(m) if isinstance(m, dict) else m


def test_job_manager_matches_jax():
    def case(pkg):
        tables, pub, seen = _managers(pkg)
        ids = mod(pkg, "_private.ids")
        jobs = mod(pkg, "gcs.server").GcsJobManager(tables, pub)
        a, b = ids.JobID.from_int(1), ids.JobID.from_int(2)
        jobs.add_job(a, {"entrypoint": "x"})
        jobs.add_job(b)
        jobs.mark_job_finished(a)
        jobs.mark_job_finished(ids.JobID.from_int(3))     # unknown: no-op
        rows = {k: unstamped(v) for k, v in tables.job_table.get_all()}
        return rows, [(c, k, _message(m)) for c, k, m in seen]
    jax, port = both(case)
    assert port == jax


def test_node_incarnations_and_fencing_match_jax():
    """Registration mints incarnations (a re-registration moves forward,
    also through the stored table), suspicion and its clearing, death,
    fencing checks and counts."""
    def case(pkg):
        tables, pub, seen = _managers(pkg)
        ids = mod(pkg, "_private.ids")
        server = mod(pkg, "gcs.server")
        nm = server.GcsNodeManager(tables, pub)
        a = ids.NodeID(b"\x01" * ids.NodeID.SIZE)
        b = ids.NodeID(b"\x02" * ids.NodeID.SIZE)
        out = [nm.register_node(a, {"node_name": "a"}),
               nm.register_node(b, {"node_name": "b"}),
               nm.register_node(a, {"node_name": "a"})]
        nm.mark_suspect(b)
        nm.mark_suspect(b)
        out.append(nm.get_all_node_info()[b]["state"])
        nm.clear_suspect(b)
        nm.drain_node(a)
        out += [nm.check_incarnation(a, 2), nm.check_incarnation(a, 1),
                nm.current_incarnation(a)]
        nm.on_node_death(a, "test")
        nm.on_node_death(a, "twice")
        out += [nm.check_incarnation(a, 2), nm.is_alive(a), nm.is_alive(b)]
        nm.note_fenced(a, "heartbeat")
        nm.note_fenced(a, "heartbeat")
        nm.note_fenced(a, "report")
        out += [nm.fenced_count(a), nm.fence_rejections[a]]
        # A fresh manager over the same tables continues the series.
        again = server.GcsNodeManager(tables, pub)
        out.append(again.register_node(a, {"node_name": "a"}))
        out.append(again.register_node(b, {"node_name": "b"},
                                       incarnation=7))
        infos = {k.hex(): unstamped(v)
                 for k, v in nm.get_all_node_info().items()}
        rows = {k: unstamped(v) for k, v in tables.node_table.get_all()}
        return out, infos, rows, [(c, k, _message(m)) for c, k, m in seen]
    jax, port = both(case)
    assert port == jax


def test_gcs_server_over_one_file_reloads_kv_and_jobs_as_in_jax(tmp_path):
    """A ``GcsServer`` over a file store, its KV and job table written,
    shut down; a second over the same file has both."""
    def case(pkg):
        server = mod(pkg, "gcs.server")
        ids = mod(pkg, "_private.ids")
        path = str(tmp_path / f"{pkg}-gcs.bin")
        kwargs = {"device": "cpu"} if pkg == "ray_tpu_torch" else {}
        gcs = server.GcsServer(storage_path=path, **kwargs)
        try:
            gcs.kv.put(b"persisted", b"yes")
            gcs.kv.put(b"fn", b"blob", namespace=b"fun")
            gcs.kv.delete(b"persisted")
            gcs.kv.put(b"persisted", b"again")
            job = ids.JobID.from_int(9)
            gcs.job_manager.add_job(job)
            gcs.job_manager.mark_job_finished(job)
        finally:
            gcs.shutdown()
        gcs2 = server.GcsServer(storage_path=path, **kwargs)
        try:
            return (gcs2.kv.get(b"persisted"),
                    gcs2.kv.get(b"fn", namespace=b"fun"),
                    sorted(gcs2.kv.keys(namespace=b"fun")),
                    {k: unstamped(v)
                     for k, v in gcs2.storage.job_table.get_all()})
        finally:
            gcs2.shutdown()
    jax, port = both(case)
    assert port == jax
    assert port[0] == b"again"


def test_init_registers_the_job_and_shutdown_finishes_it():
    """Under both packages' ``init``: the driver's job is RUNNING in the
    job table while it runs and FINISHED after ``shutdown``, and the
    function table rows live in the KV (``fn:`` keys)."""
    def case(pkg):
        api = importlib.import_module(pkg)
        worker = mod(pkg, "_private.worker")
        kwargs = {"device": "cpu"} if pkg == "ray_tpu_torch" else {}
        api.init(num_cpus=1, **kwargs)
        try:
            w = worker.global_worker()
            gcs, job = w.cluster.gcs, w.job_id
            f = api.remote(lambda: 1)
            value = api.get(f.remote())
            running = gcs.job_manager.jobs[job]["state"]
            fn_keys = len(gcs.kv.keys(b"fn:"))
        finally:
            api.shutdown()
        return value, running, gcs.job_manager.jobs[job]["state"], fn_keys
    jax, port = both(case)
    assert port == jax == (1, "RUNNING", "FINISHED", 1)
