"""The port's node store (``ray_tpu_torch._private.object_store``) against
the JAX package's, on bare stores driven step by step, on the CPU.

Each case builds one store of each package the same way (the JAX
package's with ``native_backend=None``: the python-held path, the only
one the port has), on the same object ids and seeded values, each with
a spill directory of its own, and returns what it saw: values, ``stats``
(less the JAX package's counters of its native segment, which the port
does not have), used bytes, spill file names and error types and
messages (spill directories and ids masked).  The two outcomes must be
equal.  Where a case needs time to pass for the spill's recency guard,
both stores read one fake clock, so the run is step by step.  The cases
are those of ``tests/test_spill.py`` on bare stores, the single transfer
writer of ``tests/test_unified_scheduler.py`` and the partial-prefix
relay of ``tests/test_relay.py``; then the port's own surfaces that have
no JAX counterpart on this path (``drop_vanished`` over a removed spill
file, the store's ``close``).
"""

import os
import re
import threading
import time
import types

import numpy as np
import pytest

from ray_tpu_torch._private import config as tconfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import local_object_manager as tlom
from ray_tpu_torch._private import object_store as tstore
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch import exceptions as texc

try:  # the card's machine has no JAX
    from ray_tpu import exceptions as jexc
    from ray_tpu._private import config as jconfig
    from ray_tpu._private import ids as jids
    from ray_tpu._private import local_object_manager as jlom
    from ray_tpu._private import object_store as jstore
    from ray_tpu._private import serialization as jser
except ImportError:
    jstore = None

MB = 1024 * 1024
#: Counters of the JAX package's native segment: always 0 on its
#: python-held path, and absent from the port.
NATIVE_ONLY = ("native_put_bytes", "native_puts", "evicted_objects")


def _pkgs():
    if jstore is None:
        pytest.skip("needs the JAX package")
    return [
        types.SimpleNamespace(name="jax", store=jstore, ids=jids,
                              ser=jser, config=jconfig, lom=jlom,
                              exc=jexc),
        types.SimpleNamespace(name="port", store=tstore, ids=tids,
                              ser=tser, config=tconfig, lom=tlom,
                              exc=texc)]


def _make_store(pkg, tmp_path, capacity, node=b"\x05" * 24, **kw):
    spill_dir = str(tmp_path / pkg.name)
    if pkg.name == "jax":
        kw["native_backend"] = None
    return pkg.store.NodeObjectStore(pkg.ids.ObjectID(node), capacity,
                                     spill_dir, **kw), spill_dir


def _stats(store):
    out = {k: v for k, v in store.stats.items() if k not in NATIVE_ONLY}
    out["create_queue_wait_ms"] = out["create_queue_wait_ms"] > 0
    return out


def _files(spill_dir):
    names = sorted(os.listdir(spill_dir)) if os.path.isdir(spill_dir) \
        else []
    return [re.sub(r"^batch-[0-9a-f]+$", "batch", n) for n in names]


def _normalize(message, spill_dir):
    message = message.replace(spill_dir, "<spill>")
    return message.replace("ray_tpu_torch", "ray_tpu")


def _oids(pkg, rng, n):
    return [pkg.ids.ObjectID(bytes(rng.integers(0, 256, 24,
                                                dtype=np.uint8)))
            for _ in range(n)]


def _value(store, pkg, oid):
    e = store.get(oid)
    return None if e is None else pkg.store.entry_value(e)


def _both(case, tmp_path, monkeypatch, seed=0):
    out = []
    for pkg in _pkgs():
        (tmp_path / pkg.name).mkdir(exist_ok=True)
        out.append(case(pkg, tmp_path, monkeypatch,
                        np.random.default_rng(seed)))
    return out


class _Clock:
    """A monotonic clock both stores read, advanced by the case."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _fake_clock(pkg, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(pkg.store, "time",
                        types.SimpleNamespace(monotonic=clock.monotonic))
    return clock


# -- put, get, pin, unpin, delete --------------------------------------------

def case_put_get_pin_delete(pkg, tmp_path, monkeypatch, rng):
    store, _ = _make_store(pkg, tmp_path, 16 * MB)
    oids = _oids(pkg, rng, 3)
    values = [rng.integers(0, 255, int(s), dtype=np.uint8)
              for s in (MB, 2 * MB, MB // 2)]
    seen = []
    for oid, v in zip(oids, values):
        seen.append(store.put(oid, pkg.ser.serialize(v)))
    seen.append(store.put(oids[0], pkg.ser.serialize(values[1])))
    seen.append((store.used_bytes(), store.num_objects()))
    store.pin(oids[1])
    store.pin(oids[1])
    seen.append(store.get(oids[1]).pin_count)
    store.unpin(oids[1])
    seen.append(store.get(oids[1]).pin_count)
    seen.append([bool((_value(store, pkg, o) == v).all())
                 for o, v in zip(oids, values)])
    store.delete(oids[0])
    store.delete(oids[0])
    seen.append((store.contains(oids[0]), store.get(oids[0]),
                 store.used_bytes(), store.num_objects()))
    seen.append(_stats(store))
    return seen


# -- spilling -----------------------------------------------------------------

def case_inline_spill_and_restore(pkg, tmp_path, monkeypatch, rng):
    """A store with no spill thread spills inline, LRU first, once its
    entries are past the recency guard; a get restores."""
    clock = _fake_clock(pkg, monkeypatch)
    store, spill_dir = _make_store(pkg, tmp_path, 8 * MB,
                                   spill_threshold=0.5)
    oids = _oids(pkg, rng, 6)
    values = [rng.integers(0, 255, MB, dtype=np.uint8) for _ in oids]
    seen = []
    for oid, v in zip(oids, values):
        store.put(oid, pkg.ser.serialize(v))
        clock.now += 2.0
        seen.append((store.used_bytes(), _files(spill_dir)))
    seen.append(_stats(store))
    for oid, v in zip(oids, values):
        seen.append(bool((_value(store, pkg, oid) == v).all()))
        clock.now += 2.0
    seen.append((store.used_bytes(), _stats(store), _files(spill_dir)))
    # Re-spilling a restored entry writes nothing new.
    seen.append((store.spill_now(), _stats(store), _files(spill_dir)))
    for oid in oids:
        store.delete(oid)
    seen.append((store.used_bytes(), _files(spill_dir)))
    return seen


def case_fused_spiller(pkg, tmp_path, monkeypatch, rng):
    """tests/test_spill.py:290-338: the spill thread fuses small objects
    into batch files, each object restored on its own."""
    clock = _fake_clock(pkg, monkeypatch)
    monkeypatch.setattr(pkg.config.get_config(), "min_spilling_size",
                        2 * MB)
    store, spill_dir = _make_store(pkg, tmp_path, 4 * MB,
                                   spill_threshold=0.5)
    mgr = pkg.lom.LocalObjectManager(store, spill_dir, node_label="t")
    store.attach_spill_manager(mgr)
    try:
        oids = _oids(pkg, rng, 12)
        values = [np.full(256 * 1024, i, dtype=np.uint8)
                  for i in range(12)]
        for oid, v in zip(oids, values):
            store.put(oid, pkg.ser.serialize(v))
        clock.now += 2.0
        mgr.request_spill()
        deadline = time.monotonic() + 10
        while store.spill_shortfall() > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        seen = [store.spill_shortfall() <= 0, dict(mgr.stats),
                _stats(store), _files(spill_dir)]
        seen.append([bool((_value(store, pkg, o) == v).all())
                     for o, v in zip(oids, values)])
        # The reads' restores wake the spill thread again, and what it
        # spills while they run is up to the threads: an invariant only.
        seen.append(store.stats["restored_objects"] >=
                    seen[2]["spilled_objects"])
        return seen
    finally:
        mgr.stop()


def case_open_spilled_view(pkg, tmp_path, monkeypatch, rng):
    """tests/test_spill.py:262-289: the mmap over a spilled object's
    region is its flat form; a hot entry has none."""
    store, _ = _make_store(pkg, tmp_path, 8 * MB)
    oid, hot = _oids(pkg, rng, 2)
    s = pkg.ser.serialize(np.arange(MB, dtype=np.uint8) % 229)
    flat = s.to_bytes()
    store.put(oid, s)
    seen = [store.spill_now()]
    view, release = store.open_spilled_view(oid)
    try:
        seen.append(bytes(view) == flat)
        seen.append(bytes(view[100:200]))
    finally:
        release()
    seen.append(store.read_sealed_range(oid, 5, 50))
    store.put(hot, pkg.ser.serialize(b"x" * 1024))
    seen.append(store.open_spilled_view(hot))
    seen.append(len(flat))
    return seen


def case_create_queue_admits_when_space_frees(pkg, tmp_path, monkeypatch,
                                              rng):
    """tests/test_spill.py:68-108: a put over hard capacity queues and
    is admitted when a delete frees room."""
    monkeypatch.setattr(pkg.config.get_config(),
                        "object_store_full_grace_period_s", 10.0)
    store, _ = _make_store(pkg, tmp_path, 8 * MB)
    filler, queued = _oids(pkg, rng, 2)
    store.put(filler, pkg.ser.serialize(np.zeros(7 * MB, np.uint8)))
    store.pin(filler)
    value = np.arange(4 * MB, dtype=np.uint8) % 251
    done = threading.Event()
    err = []

    def putter():
        try:
            store.put(queued, pkg.ser.serialize(value))
        except Exception as e:  # noqa: BLE001 — the error is the outcome
            err.append(e)
        done.set()

    t = threading.Thread(target=putter)
    t.start()
    seen = [done.wait(timeout=0.3)]
    deadline = time.monotonic() + 10      # the putter may start late
    while store.stats["queued_creates"] < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    seen.append(store.stats["queued_creates"])
    store.unpin(filler)
    store.delete(filler)
    seen.append(done.wait(timeout=5.0))
    t.join(timeout=5)
    seen.append((err, bool((_value(store, pkg, queued) == value).all())))
    seen.append(_stats(store))
    return seen


def case_create_queue_deadline(pkg, tmp_path, monkeypatch, rng):
    """tests/test_spill.py:110-136: the grace period passes with no
    space freed: ObjectStoreFullError with its context."""
    monkeypatch.setattr(pkg.config.get_config(),
                        "object_store_full_grace_period_s", 0.3)
    store, spill_dir = _make_store(pkg, tmp_path, 8 * MB)
    filler, other = _oids(pkg, rng, 2)
    store.put(filler, pkg.ser.serialize(np.zeros(7 * MB, np.uint8)))
    store.pin(filler)
    try:
        store.put(other, pkg.ser.serialize(np.zeros(4 * MB, np.uint8)))
        raised = None
    except pkg.exc.ObjectStoreFullError as e:
        raised = (type(e).__name__, _normalize(str(e), spill_dir),
                  e.infeasible)
    try:
        store.put(other, pkg.ser.serialize(np.zeros(9 * MB, np.uint8)))
        infeasible = None
    except pkg.exc.ObjectStoreFullError as e:
        infeasible = (_normalize(str(e), spill_dir), e.infeasible)
    return raised, infeasible, _stats(store)


def case_spill_during_pin_refused(pkg, tmp_path, monkeypatch, rng):
    """tests/test_spill.py:138-156."""
    store, spill_dir = _make_store(pkg, tmp_path, 8 * MB)
    (oid,) = _oids(pkg, rng, 1)
    value = np.arange(MB, dtype=np.uint8) % 241
    store.put(oid, pkg.ser.serialize(value))
    store.pin(oid)
    seen = [store.spill_now(), store.select_spill_victims(8 * MB),
            store.get(oid).data is not None]
    store.unpin(oid)
    seen.append(store.spill_now())
    seen.append(_normalize(store.get(oid).spilled_path, spill_dir))
    seen.append(bool((_value(store, pkg, oid) == value).all()))
    seen.append(_stats(store))
    return seen


def case_restore_during_delete(pkg, tmp_path, monkeypatch, rng):
    """tests/test_spill.py:158-200: a restore racing a delete never
    fails and never leaks the spill file (an invariant: which of the
    two wins is up to the threads)."""
    errors, leaked = [], []
    for i in range(10):
        store, spill_dir = _make_store(pkg, tmp_path / pkg.name,
                                       8 * MB, node=bytes([i]) * 24)
        (oid,) = _oids(pkg, rng, 1)
        value = np.arange(MB, dtype=np.uint8) % 239
        store.put(oid, pkg.ser.serialize(value))
        assert store.spill_now() == 1
        start = threading.Barrier(2)

        def restorer():
            start.wait()
            try:
                e = store.get(oid)
                if e is not None:
                    assert (pkg.store.entry_value(e) == value).all()
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def deleter():
            start.wait()
            store.delete(oid)

        threads = [threading.Thread(target=restorer),
                   threading.Thread(target=deleter)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        store.delete(oid)
        leaked.extend(_files(spill_dir))
    return errors, leaked


# -- transfers ----------------------------------------------------------------

def case_single_transfer_writer(pkg, tmp_path, monkeypatch, rng):
    """tests/test_unified_scheduler.py:421-458: a second writer of one
    object blocks until the first seals, then adopts its copy."""
    store, _ = _make_store(pkg, tmp_path, 64 * MB)
    oid = pkg.ids.ObjectID(b"x" * 24)
    arr = np.arange(250_000, dtype=np.float64)
    blob = pkg.ser.serialize(arr).to_bytes()
    w1 = store.create_transfer_writer(oid, len(blob))
    results = []
    t = threading.Thread(target=lambda: results.append(
        store.create_transfer_writer(oid, len(blob))), daemon=True)
    t.start()
    time.sleep(0.2)
    seen = [w1 is not None, list(results)]
    w1.write(0, blob)
    w1.seal()
    t.join(timeout=10)
    seen += [results, store.contains(oid),
             bool((_value(store, pkg, oid) == arr).all()),
             store.stats.get("vanished_objects", 0), store.used_bytes()]
    store.delete(oid)
    seen.append(_stats(store))
    return seen


def _blob_and_array(pkg, n_chunks, chunk):
    arr = np.arange(n_chunks * chunk + chunk // 2, dtype=np.uint8) % 251
    return pkg.ser.serialize(arr).to_bytes(), arr


def case_relay_watermark(pkg, tmp_path, monkeypatch, rng):
    """tests/test_relay.py:59-98: a relay read never crosses the
    assembly watermark; late reads resolve through the sealed copy."""
    cfg = pkg.config.get_config()
    chunk = 64 * 1024
    monkeypatch.setattr(cfg, "object_manager_chunk_size", chunk)
    store, _ = _make_store(pkg, tmp_path, 64 * MB)
    (oid,) = _oids(pkg, rng, 1)
    blob, arr = _blob_and_array(pkg, 6, chunk)
    nbytes = len(blob)
    writer = store.create_transfer_writer(oid, nbytes)
    relay = store.open_relay_source(oid)
    seen = [relay.nbytes == nbytes]

    def read(start, end, timeout):
        try:
            return relay.read_range(start, end, timeout=timeout)
        except TimeoutError:
            return "pending"

    seen.append(read(0, chunk, 0.05))
    writer.write(0, blob[:chunk])
    writer.write(chunk, blob[chunk:2 * chunk])
    seen.append(relay.watermark)
    seen.append(read(0, chunk, 2.0) == blob[:chunk])
    seen.append(read(chunk, 2 * chunk, 2.0) == blob[chunk:2 * chunk])
    seen.append(read(2 * chunk, 3 * chunk, 0.05))
    for off in range(2 * chunk, nbytes, chunk):
        writer.write(off, blob[off:off + chunk])
    writer.seal()
    seen.append(store.open_relay_source(oid))
    seen.append(read(nbytes - chunk, nbytes, 2.0) == blob[nbytes - chunk:])
    seen.append(bool((_value(store, pkg, oid) == arr).all()))
    seen.append(_stats(store))
    return seen


def case_relay_upstream_abort(pkg, tmp_path, monkeypatch, rng):
    """tests/test_relay.py:100-132: an upstream abort fails a parked
    relay reader with None, and the object never lands."""
    cfg = pkg.config.get_config()
    chunk = 64 * 1024
    monkeypatch.setattr(cfg, "object_manager_chunk_size", chunk)
    store, _ = _make_store(pkg, tmp_path, 64 * MB)
    (oid,) = _oids(pkg, rng, 1)
    blob, _ = _blob_and_array(pkg, 4, chunk)
    writer = store.create_transfer_writer(oid, len(blob))
    relay = store.open_relay_source(oid)
    writer.write(0, blob[:chunk])
    seen = [relay.read_range(0, chunk, timeout=2.0) == blob[:chunk]]
    got = {}

    def parked_read():
        try:
            got["data"] = relay.read_range(chunk, 2 * chunk, timeout=10.0)
        except TimeoutError:
            got["data"] = "timeout"

    t = threading.Thread(target=parked_read, daemon=True)
    t.start()
    time.sleep(0.1)
    writer.abort()
    t.join(timeout=5.0)
    seen += [t.is_alive(), got.get("data"),
             relay.read_range(0, chunk, timeout=0.2),
             store.open_relay_source(oid), store.contains(oid),
             relay.failed, _stats(store)]
    # The claim and the reservation went with the abort: a new writer
    # opens at once.
    w2 = store.create_transfer_writer(oid, len(blob))
    seen.append(w2 is not None)
    w2.abort()
    return seen


def case_relay_duplicate_writer(pkg, tmp_path, monkeypatch, rng):
    """tests/test_relay.py:134-168: a racing writer adopts the sealed
    copy while relay reads keep serving."""
    cfg = pkg.config.get_config()
    chunk = 64 * 1024
    monkeypatch.setattr(cfg, "object_manager_chunk_size", chunk)
    store, _ = _make_store(pkg, tmp_path, 64 * MB)
    (oid,) = _oids(pkg, rng, 1)
    blob, arr = _blob_and_array(pkg, 4, chunk)
    nbytes = len(blob)
    writer = store.create_transfer_writer(oid, nbytes)
    relay = store.open_relay_source(oid)
    writer.write(0, blob[:chunk])
    second = {}
    t = threading.Thread(target=lambda: second.setdefault(
        "writer", store.create_transfer_writer(oid, nbytes)), daemon=True)
    t.start()
    time.sleep(0.1)
    seen = [t.is_alive(),
            relay.read_range(0, chunk, timeout=2.0) == blob[:chunk]]
    for off in range(chunk, nbytes, chunk):
        writer.write(off, blob[off:off + chunk])
    writer.seal()
    t.join(timeout=10.0)
    seen += [t.is_alive(), second.get("writer"),
             relay.read_range(0, nbytes, timeout=2.0) == blob,
             bool((_value(store, pkg, oid) == arr).all()), _stats(store)]
    return seen


def case_transfer_ledger_fifo(pkg, tmp_path, monkeypatch, rng):
    """The sender's admission: FIFO tickets under a cap of one, gauges
    in the store's stats."""
    monkeypatch.setattr(pkg.config.get_config(),
                        "object_transfer_max_outbound_sessions", 1)
    store, _ = _make_store(pkg, tmp_path, 8 * MB)
    ledger = store.transfer_ledger
    seen = [ledger.try_acquire(100, timeout=0.1), ledger.load_score(),
            ledger.has_free_slot()]
    a, b = ledger.enqueue(), ledger.enqueue()
    seen += [ledger.wait_grant(b, timeout=0.05), ledger.load_snapshot()]
    ledger.release(100)
    seen += [ledger.wait_grant(b, timeout=0.05),
             ledger.wait_grant(a, timeout=0.05)]
    ledger.cancel(b)
    ledger.note_served(10)
    ledger.note_served(5, relay=True)
    seen += [ledger.load_snapshot(), ledger.load_score()]
    ledger.release(0)
    seen += [ledger.has_free_slot(), _stats(store)]
    return seen


CASES = [case_put_get_pin_delete, case_inline_spill_and_restore,
         case_fused_spiller, case_open_spilled_view,
         case_create_queue_admits_when_space_frees,
         case_create_queue_deadline, case_spill_during_pin_refused,
         case_restore_during_delete, case_single_transfer_writer,
         case_relay_watermark, case_relay_upstream_abort,
         case_relay_duplicate_writer, case_transfer_ledger_fifo]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: c.__name__[len("case_"):])
def test_store_case_matches_jax(case, tmp_path, monkeypatch):
    jax_out, port_out = _both(case, tmp_path, monkeypatch,
                              seed=CASES.index(case))
    assert port_out == jax_out


def test_the_reference_outcomes_hold(tmp_path):
    """What the JAX package's own tests assert of these cases holds for
    the port alone (so a shared wrong answer cannot pass)."""
    pkg = types.SimpleNamespace(name="port", store=tstore, ids=tids,
                                ser=tser, config=tconfig, lom=tlom,
                                exc=texc)
    (tmp_path / "port").mkdir()
    rng = np.random.default_rng(0)

    def run(case):
        with pytest.MonkeyPatch.context() as mp:
            return case(pkg, tmp_path, mp, rng)

    spill = run(case_inline_spill_and_restore)
    assert spill[6]["spilled_objects"] > 0 and all(spill[7:13])
    fused = run(case_fused_spiller)
    assert fused[0] and fused[1]["spill_batches"] >= 1
    assert fused[1]["spilled_objects"] >= 2 and all(fused[4]) and fused[5]
    assert 1 <= fused[3].count("batch") < fused[1]["spilled_objects"]
    assert run(case_open_spilled_view)[:2] == [1, True]
    queue = run(case_create_queue_admits_when_space_frees)
    assert queue[:3] == [False, 1, True] and queue[3] == ([], True)
    raised, infeasible, st = run(case_create_queue_deadline)
    for phrase in ("cannot reserve", "bytes used", "queued",
                   "object_store_memory"):
        assert phrase in raised[1]
    assert "NEVER fit" in infeasible[0] and infeasible[1]
    assert st["create_queue_timeouts"] == 1
    assert run(case_restore_during_delete) == ([], [])
    single = run(case_single_transfer_writer)
    assert single[:6] == [True, [], [None], True, True, 0]
    mark = run(case_relay_watermark)
    assert mark[1] == "pending" and mark[5] == "pending"
    assert mark[6] is None and all(mark[3:5] + mark[7:9])
    abort = run(case_relay_upstream_abort)
    assert abort[1:6] == [False, None, None, None, False]


def test_drop_vanished_heals_a_removed_spill_file(tmp_path):
    """The port's vanished entry: a spilled object whose spill file was
    removed underneath reads as ObjectVanishedError, and
    ``drop_vanished`` removes it (and only it) so ``contains`` stops
    claiming it."""
    store = tstore.NodeObjectStore(tids.ObjectID(b"\x01" * 24), 8 * MB,
                                   str(tmp_path))
    lost, kept = (tids.ObjectID(bytes([i]) * 24) for i in (2, 3))
    for oid in (lost, kept):
        store.put(oid, tser.serialize(np.arange(MB // 8)))
    assert store.spill_now() == 2
    assert store.drop_vanished(lost) is False     # file still there
    os.unlink(store._entries[lost].spilled_path.partition("?")[0])
    assert store.contains(lost)
    with pytest.raises(tstore.ObjectVanishedError):
        store.get(lost)
    assert store.get_serialized(lost) is None
    assert store.drop_vanished(lost) is True
    assert not store.contains(lost)
    assert store.stats["vanished_objects"] == 1
    assert store.drop_vanished(kept) is False
    assert (tstore.entry_value(store.get(kept)) == np.arange(MB // 8)).all()


def test_close_drops_entries_and_spill_files(tmp_path):
    spill_dir = tmp_path / "spill"
    store = tstore.NodeObjectStore(tids.ObjectID(b"\x01" * 24), 8 * MB,
                                   str(spill_dir))
    for i in range(3):
        store.put(tids.ObjectID(bytes([i + 1]) * 24),
                  tser.serialize(np.zeros(MB, np.uint8)))
    assert store.spill_now() == 3 and len(os.listdir(spill_dir)) == 3
    store.close()
    assert store.num_objects() == 0 and store.used_bytes() == 0
    assert not spill_dir.exists()


def test_flat_form_matches_jax():
    """``to_bytes`` is byte-equal to the JAX package's, ``from_bytes``
    reads either's, and ``flat_chunks`` cover the flat form in order."""
    if jstore is None:
        pytest.skip("needs the JAX package")
    rng = np.random.default_rng(4)
    value = {"a": rng.random((64, 33)), "b": "meta",
             "c": rng.integers(0, 9, 1000).astype(np.int16)}
    port, ref = tser.serialize(value), jser.serialize(value)
    blob = port.to_bytes()
    assert blob == ref.to_bytes()
    assert port.flat_nbytes == ref.flat_nbytes == len(blob)
    for back in (tser.deserialize(tser.SerializedObject.from_bytes(blob)),
                 jser.deserialize(jser.SerializedObject.from_bytes(blob))):
        assert back["b"] == "meta" and (back["a"] == value["a"]).all()
        assert (back["c"] == value["c"]).all()
    for chunk in (7, 1000, 1 << 20):
        buf = bytearray(len(blob))
        ends = []
        for off, view in port.flat_chunks(chunk):
            assert view.nbytes <= chunk
            buf[off:off + view.nbytes] = view
            ends.append(off + view.nbytes)
        assert bytes(buf) == blob and ends == sorted(ends)
    dst = bytearray(len(blob))
    assert port.write_into(memoryview(dst)) == len(blob) and dst == blob


def test_received_and_restored_buffers_are_aligned(tmp_path):
    """A flat form copied in by a transfer writer, or read back from a
    spill file, has its first buffer 64-byte aligned (the flat layout
    leaves it wherever the header ends), so a float32 reduction over the
    copy takes the original's path and gives its bits."""
    store = tstore.NodeObjectStore(tids.ObjectID(b"\x01" * 24), 64 * MB,
                                   str(tmp_path))
    rng = np.random.default_rng(5)
    value = rng.random(1_000_003).astype(np.float32)
    s = tser.serialize({"x": value, "pad": "y" * 37})
    moved, spilled = (tids.ObjectID(bytes([i]) * 24) for i in (2, 3))
    writer = store.create_transfer_writer(moved, s.flat_nbytes)
    for off, view in s.flat_chunks(256 * 1024):
        writer.write(off, view)
    writer.seal()
    store.put(spilled, s)
    values = [tstore.entry_value(store.get(moved))["x"]]
    assert store.spill_now() == 2      # both, the moved copy too
    values += [tstore.entry_value(store.get(oid))["x"]
               for oid in (moved, spilled)]
    for got in values:
        assert got.ctypes.data % tser.FLAT_ALIGN == 0
        assert not got.flags.writeable
        assert got.sum() == value.sum()
        assert got.tobytes() == value.tobytes()


def test_reference_counter_records_match_jax():
    """The reference counter's node-store records: the pinned node, the
    spill record and ``describe`` (which the ObjectLostError message
    reads), and ``add_on_delete`` firing at the release or at once."""
    if jstore is None:
        pytest.skip("needs the JAX package")
    from ray_tpu._private import reference_counter as jrc
    from ray_tpu_torch._private import reference_counter as trc

    def run(rc_mod, ids):
        rc = rc_mod.ReferenceCounter()
        oid, gone = ids.ObjectID(b"\x07" * 24), ids.ObjectID(b"\x08" * 24)
        fired = []
        rc.add_owned_object(oid)
        rc.add_local_ref(oid)
        rc.set_pinned_node(oid, "node-a")
        rc.set_spilled_url(oid, "/spill/f?offset=0&size=9")
        rc.add_on_delete(oid, lambda o: fired.append(o.hex()))
        rc.add_on_delete(gone, lambda o: fired.append(o.hex()))
        seen = [rc.describe(oid), rc.describe(gone), list(fired)]
        rc.remove_local_ref(oid)
        rc.close()
        seen += [rc.describe(oid), fired, rc.has_reference(oid)]
        return seen

    port = run(trc, tids)
    ref = run(jrc, jids)
    ref[0].pop("borrowers")     # the reference's borrowers: not ported
    assert port == ref
    assert port[0]["pinned_node"] == "node-a" and port[4] == [
        "08" * 24, "07" * 24]


def _headroom_put(pkg, tmp_path, monkeypatch):
    """A 64 MiB store with its spill thread, 48 MiB in it (under the
    threshold), then a 16 MiB put: more than the headroom above the
    threshold, so it must queue until the thread spills."""
    monkeypatch.setattr(pkg.config.get_config(),
                        "object_store_full_grace_period_s", 3.0)
    store, spill_dir = _make_store(pkg, tmp_path, 64 * MB)
    mgr = pkg.lom.LocalObjectManager(store, spill_dir, node_label="h")
    store.attach_spill_manager(mgr)
    try:
        rng = np.random.default_rng(9)
        for oid in _oids(pkg, rng, 3):
            store.put(oid, pkg.ser.serialize(np.zeros(16 * MB, np.uint8)))
        try:
            store.put(_oids(pkg, rng, 1)[0],
                      pkg.ser.serialize(np.zeros(16 * MB, np.uint8)))
            return "admitted", store.stats["spilled_objects"] > 0
        except pkg.exc.ObjectStoreFullError as e:
            return "full", str(e).split(";")[-1].strip()[:6]
    finally:
        mgr.stop()


def test_put_larger_than_the_spill_headroom_is_admitted(tmp_path,
                                                        monkeypatch):
    """ROADMAP C.5: the port's spill thread counts the queued bytes, so
    the put is admitted once it spilled; the JAX package's thread sees
    the store under its threshold and spills nothing, and the put fails
    after its grace period."""
    pkgs = _pkgs()
    for pkg in pkgs:
        (tmp_path / pkg.name).mkdir()
    assert _headroom_put(pkgs[1], tmp_path, monkeypatch) == \
        ("admitted", True)
    assert _headroom_put(pkgs[0], tmp_path, monkeypatch) == \
        ("full", "queued")
