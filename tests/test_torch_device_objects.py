"""The port's device-object plane (a tensor put, returned, passed and
pulled as an object; the GPU resource) against the JAX package's
(``jax.Array``\\s as objects; the TPU resource), on the CPU.

A tensor is the port's ``jax.Array``: under ``device="cpu"`` the port's
CPU tensors are device objects as the JAX package's CPU arrays are under
``JAX_PLATFORMS=cpu``.  Each end-to-end case runs once on each package's
cluster (``torch_cluster_util``'s ``both``: a head, and for the pulls a
node "far" that only tasks asking for its resource reach), its arrays
made by that package from the same seeded numpy values (``jnp.asarray``
there, ``torch.from_numpy`` here), and returns what it saw: the values as
numpy, whether a read gave the stored object itself (two reads give one
object), whether a copy is the package's host form (a numpy array there,
a CPU tensor here: ROADMAP C.20; on the CPU a tensor is both, so a read
of the stored object is held by identity, not by type), the object's
locations in the directory, its entry in the owner's memory store and in
each node store (a device entry's size; a serialized one's differs by
its pickle header between the packages).  The two outcomes must
be equal, values exactly.  The bare-store cases hold a device entry's
capacity accounting, spilling and host form on one store of each
package.  The GPU count and ids of the port are held against the TPU
count and ids of the JAX package (``num_gpus`` against ``num_tpus``).
The cases named ``..._in_the_port`` have no JAX counterpart: the private
copy a put takes (C.19) and the dtype a host form keeps (C.20).  The
card's twin is ``tests/test_torch_core_worker.py``'s
``test_cuda_tensor_as_object_round_trips``.  The last test checks that
no thread of the port outlives ``shutdown``.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import object_store as tstore
from ray_tpu_torch._private import serialization as tser
from torch_cluster_util import PORT, both, run_case

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from ray_tpu._private import ids as jids
    from ray_tpu._private import object_store as jstore
    from ray_tpu._private import serialization as jser
except ImportError:
    jax = None

HEAD_CPUS = 4
KB = 1024
MB = 1024 * KB


# -- each package's arrays -----------------------------------------------------

def _array(name, x):
    """``x`` (numpy) as ``name``'s array: a ``jax.Array`` or a tensor."""
    if name == PORT:
        return torch.from_numpy(np.array(x))
    return jnp.asarray(x)


def _numpy(v):
    """Any package's array as numpy, for comparing values."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def _is_array(name, v):
    """The package's array type: ``jax.Array`` or ``torch.Tensor``."""
    if name == PORT:
        return isinstance(v, torch.Tensor)
    return isinstance(v, jax.Array)


def _is_host(name, v):
    """The package's host form: numpy there, a CPU tensor here."""
    if name == PORT:
        return isinstance(v, torch.Tensor) and v.device.type == "cpu"
    return isinstance(v, np.ndarray)


def _core(name):
    return importlib.import_module(
        f"{name}._private.worker").global_worker().core_worker


def _where(env, ref):
    """(sorted names of the nodes the directory lists, the memory
    store's entry or None, each listed node's entry as (is_device,
    size) for a device entry, (is_device, "serialized") else)."""
    oid = ref.object_id()
    core = _core(env.name)
    nodes = env.cluster.object_directory.get_locations(oid)
    entry = core.memory_store.get_entry(oid)
    stores = {}
    for raylet in env.cluster.raylets():
        if raylet.node_id in nodes:
            e = raylet.object_store.get(oid)
            stores[env.node_of(raylet.node_id.hex())] = \
                None if e is None else \
                (e.is_device, e.size if e.is_device else "serialized")
    return (sorted(env.node_of(n.hex()) for n in nodes),
            None if entry is None else type(entry.data).__name__, stores)


# -- task and actor bodies (module level: exported by reference) ---------------

def _make(name, seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return _array(name, x)


def _inspect(name, v):
    """What a task sees of its argument."""
    return (_is_array(name, v), _is_host(name, v), _numpy(v).tolist(),
            id(v))


class Holder:
    def __init__(self, name):
        self.name = name

    def inspect(self, v):
        return _inspect(self.name, v)


def _far(env, fn):
    return env.pkg.remote(resources={"far": 1})(fn)


# -- end-to-end cases ----------------------------------------------------------

def case_put_get(env):
    """A put of each size is a device entry on the head, whatever its
    size; two gets give one object, equal in value."""
    rng = np.random.default_rng(0)
    out = []
    for n in (4, 1024, 256 * KB):
        x = rng.standard_normal(n).astype(np.float32)
        ref = env.pkg.put(_array(env.name, x))
        a, b = env.pkg.get(ref), env.pkg.get(ref)
        out.append((_is_array(env.name, a), a is b,
                    bool(np.array_equal(_numpy(a), x)), _where(env, ref)))
    return out


def _task_return(env, node, fn):
    ref = fn.remote(env.name, 3, (8, 16))
    ready, _ = env.pkg.wait([ref], timeout=30)
    where = _where(env, ref)
    v, again = env.pkg.get(ref), env.pkg.get(ref)
    want = np.random.default_rng(3).standard_normal(
        (8, 16)).astype(np.float32)
    # The head's is the stored array; the far node's is pulled.
    form = _is_array(env.name, v) if node == "head" else \
        _is_host(env.name, v)
    return (len(ready), where, v is again, form,
            bool(np.array_equal(_numpy(v), want)), _where(env, ref))


def case_task_return_on_head(env):
    """A task's array return lands in its node's store as a device entry
    and nowhere in the memory store; ``wait`` reports it ready."""
    return _task_return(env, "head", env.pkg.remote(_make))


def case_task_return_on_far(env):
    """The same on another node, and the driver's read pulls it."""
    return _task_return(env, "far", _far(env, _make))


def case_same_node_reads(env):
    """A task and an actor on the object's node get the stored array
    itself: the object the driver's ``get`` gives."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref = env.pkg.put(_array(env.name, x))
    stored_id = id(env.pkg.get(ref))
    task = env.pkg.get(env.pkg.remote(_inspect).remote(env.name, ref))
    actor = env.pkg.remote(Holder).remote(env.name)
    by_actor = env.pkg.get(actor.inspect.remote(ref))
    return [(t[0], t[2], t[3] == stored_id) for t in (task, by_actor)]


def case_pull_to_other_node(env):
    """A task on another node reads the object through a pull: its host
    form, equal in value, in a serialized entry there; the driver reads
    a far node's return the same way."""
    x = np.random.default_rng(5).standard_normal((64, 64)).astype(
        np.float32)
    ref = env.pkg.put(_array(env.name, x))
    seen = env.pkg.get(_far(env, _inspect).remote(env.name, ref))
    far_ref = _far(env, _make).remote(env.name, 6, (32,))
    env.pkg.wait([far_ref], timeout=30)
    before = _where(env, far_ref)
    v = env.pkg.get(far_ref)
    want = np.random.default_rng(6).standard_normal(32).astype(np.float32)
    return (seen[1:3] == (True, x.tolist()), _where(env, ref),
            before, _is_host(env.name, v),
            bool(np.array_equal(_numpy(v), want)), _where(env, far_ref))


def case_inline_argument(env):
    """A small array passed by value arrives as its host form."""
    x = np.linspace(-1, 1, 10, dtype=np.float32)
    seen = env.pkg.get(env.pkg.remote(_inspect).remote(
        env.name, _array(env.name, x)))
    return seen[1:3] == (True, x.tolist())


def case_large_literal_argument(env):
    """An array argument above the inline limit is promoted to a device
    object, which the task reads as the package's array."""
    x = np.random.default_rng(7).standard_normal(64 * KB).astype(
        np.float32)
    seen = env.pkg.get(env.pkg.remote(_inspect).remote(
        env.name, _array(env.name, x)))
    return (seen[0], seen[2]) == (True, x.tolist())


E2E_CASES = [case_put_get, case_task_return_on_head,
             case_task_return_on_far, case_same_node_reads,
             case_pull_to_other_node, case_inline_argument,
             case_large_literal_argument]
#: The cases that add the node "far"; the others run on the head alone,
#: so that their tasks and actors share the object's node.
FAR_CASES = (case_task_return_on_far, case_pull_to_other_node)


def _with_far(case):
    def run(env):
        env.add_node("far", 2, {"far": 1})
        return case(env)
    return run


@pytest.mark.parametrize("case", E2E_CASES, ids=lambda c: c.__name__)
def test_device_object_case_matches_jax(case):
    if jax is None:
        pytest.skip("needs the JAX package")
    want, got = both(_with_far(case) if case in FAR_CASES else case,
                     HEAD_CPUS)
    assert want[0] == "value", want
    assert got == want


# -- bare stores -----------------------------------------------------------------

def _pkgs():
    if jax is None:
        pytest.skip("needs the JAX package")
    return [types.SimpleNamespace(name="ray_tpu", store=jstore, ids=jids,
                                  ser=jser),
            types.SimpleNamespace(name=PORT, store=tstore, ids=tids,
                                  ser=tser)]


def _store(pkg, tmp_path, capacity):
    kw = {"native_backend": None} if pkg.name == "ray_tpu" else {}
    spill_dir = str(tmp_path / pkg.name)
    return pkg.store.NodeObjectStore(pkg.ids.ObjectID(b"\x07" * 24),
                                      capacity, spill_dir, **kw)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _bare_both(case, tmp_path, monkeypatch):
    out = []
    for pkg in _pkgs():
        clock = _Clock()
        monkeypatch.setattr(pkg.store, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))
        rng = np.random.default_rng(11)
        out.append(case(pkg, _store(pkg, tmp_path, 16 * MB), clock, rng))
    return out


def _oid(pkg, i):
    return pkg.ids.ObjectID(bytes([i]) * 24)


def case_device_entries_never_spill(pkg, store, clock, rng):
    """A store half full of device entries: the serialized entries put
    after them spill under pressure and in ``spill_now``; the device
    entries stay, with their bytes counted."""
    devs = [rng.standard_normal(MB // 2).astype(np.float32)
            for _ in range(4)]
    for i, x in enumerate(devs):
        store.put(_oid(pkg, i), pkg.store.DeviceObject(
            _array(pkg.name, x)))
    seen = [store.used_bytes()]
    for i in range(4):
        clock.now += 2.0
        store.put(_oid(pkg, 10 + i), pkg.ser.serialize(
            rng.integers(0, 255, 2 * MB, dtype=np.uint8)))
        seen.append((store.used_bytes(), store.stats["spilled_objects"]))
    clock.now += 2.0
    seen.append(store.spill_now())
    for i, x in enumerate(devs):
        e = store.get(_oid(pkg, i))
        seen.append((e.is_device, e.spilled_path is None, e.size,
                     bool(np.array_equal(
                         _numpy(pkg.store.entry_value(e)), x))))
    seen.append([store.get(_oid(pkg, 10 + i)).is_device for i in range(4)])
    return seen


def case_device_entry_over_capacity(pkg, store, clock, rng):
    """A device entry larger than the store raises as any entry does."""
    big = np.zeros(5 * MB, np.float32)      # 20 MB into 16 MB
    try:
        store.put(_oid(pkg, 1), pkg.store.DeviceObject(
            _array(pkg.name, big)))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return type(e).__name__, getattr(e, "infeasible", None), \
            store.used_bytes()
    return "no error"


def case_device_entry_host_form(pkg, store, clock, rng):
    """A pull reads a device entry's host form; a forced spill writes
    it, and the restored entry reads back as the host form."""
    x = rng.standard_normal((16, 8)).astype(np.float32)
    oid = _oid(pkg, 2)
    store.put(oid, pkg.store.DeviceObject(_array(pkg.name, x)))
    pulled = pkg.ser.deserialize(store.get_serialized(oid))
    with store._lock:
        store._spill(oid, store._entries[oid])
    restored = pkg.store.entry_value(store.get(oid))
    return (_is_host(pkg.name, pulled), np.array_equal(_numpy(pulled), x),
            store.stats["spilled_objects"], _is_host(pkg.name, restored),
            np.array_equal(_numpy(restored), x))


BARE_CASES = [case_device_entries_never_spill,
              case_device_entry_over_capacity, case_device_entry_host_form]


@pytest.mark.parametrize("case", BARE_CASES, ids=lambda c: c.__name__)
def test_device_store_case_matches_jax(case, tmp_path, monkeypatch):
    want, got = _bare_both(case, tmp_path, monkeypatch)
    assert got == want


# -- the accelerator resource ----------------------------------------------------

def _ids(pkg_name):
    pkg = importlib.import_module(pkg_name)
    return pkg.get_gpu_ids() if pkg_name == PORT else pkg.get_tpu_ids()


def _accelerators(pkg_name, count):
    """The cluster's count and the ids the driver and tasks asking for
    0, 1 and 2 accelerators see; ``count`` None leaves it to ``init``."""
    pkg = importlib.import_module(pkg_name)
    res, key = ("num_gpus", "GPU") if pkg_name == PORT else \
        ("num_tpus", "TPU")
    kw = {"num_cpus": 4}
    if pkg_name == PORT:
        kw["device"] = "cpu"
    if count is not None:
        kw[res] = count
    pkg.init(**kw)
    try:
        out = [pkg.cluster_resources().get(key, 0.0), _ids(pkg_name)]
        for n in (0, 1, 2)[:1 + int(count or 0)]:
            fn = pkg.remote(**{res: n})(_ids) if n else pkg.remote(_ids)
            out.append(pkg.get(fn.remote(pkg_name)))
        return out
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("count", [None, 2])
def test_gpu_count_and_ids_match_jax_tpus(count):
    if jax is None:
        pytest.skip("needs the JAX package")
    assert _accelerators(PORT, count) == _accelerators("ray_tpu", count)


def test_cpu_cluster_counts_no_gpu():
    """``device="cpu"`` counts no card, and ``init`` makes no device
    context to count."""
    ray_tpu_torch.init(num_cpus=1, device="cpu")
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
    finally:
        ray_tpu_torch.shutdown()


# -- the port's own: C.19 and C.20 -------------------------------------------------

def case_put_keeps_private_copy(env):
    """A put copies the tensor once on its device: writing into the
    original afterwards, or into an argument, leaves the object as it
    was; no host byte is copied."""
    x = torch.arange(1000, dtype=torch.float32)
    t = x.clone()
    host0 = tser.copy_stats["bytes_copied"]
    dev0 = tser.copy_stats["device_bytes_copied"]
    ref = env.pkg.put(t)
    copied = (tser.copy_stats["device_bytes_copied"] - dev0,
              tser.copy_stats["bytes_copied"] - host0)
    t.zero_()
    kept = torch.equal(env.pkg.get(ref), x)
    return copied, kept, _where(env, ref)


def test_put_keeps_a_private_copy_in_the_port():
    got = run_case(PORT, case_put_keeps_private_copy, HEAD_CPUS)
    assert got == ("value", ((4000, 0), True, (["head"], None,
                                                {"head": (True, 4000)})))


def _dtype_of(v):
    return str(v.dtype), v.device.type, v.float().tolist()


def case_host_form_keeps_dtype(env):
    x = torch.tensor([1.5, -2.25, 3.0e4, 1e-3], dtype=torch.bfloat16)
    want = (str(x.dtype), "cpu", x.float().tolist())
    ref = env.pkg.put(x)
    pulled = env.pkg.get(_far(env, _dtype_of).remote(ref))
    inline = env.pkg.get(env.pkg.remote(_dtype_of).remote(x))
    serialized = _dtype_of(tser.deserialize(tser.serialize(x)))
    returned = env.pkg.get(_far(env, lambda: x * 1).remote())
    return [pulled, inline, serialized, _dtype_of(returned)] == [want] * 4


def test_host_form_keeps_dtype_in_the_port():
    got = run_case(PORT, _with_far(case_host_form_keeps_dtype), HEAD_CPUS)
    assert got == ("value", True)


@pytest.mark.parametrize("value", [
    torch.tensor([[1.0, 2.0], [3.0, 4.0]]).t(),          # not contiguous
    torch.zeros(0, 3), torch.tensor(2.5), torch.ones(5, dtype=torch.bool),
    torch.arange(6, dtype=torch.int16).reshape(2, 3),
], ids=["transposed", "empty", "scalar", "bool", "int16"])
def test_host_form_round_trips_in_the_port(value):
    back = tser.deserialize(tser.serialize(value))
    assert back.dtype == value.dtype and back.shape == value.shape
    assert torch.equal(back, value)
    # A fresh tensor, never a view of the serialized bytes.
    assert value.numel() == 0 or back.data_ptr() != value.data_ptr()


def test_non_strided_tensor_takes_serialized_path_in_the_port():
    """A sparse tensor is not a device object: it is serialized."""
    ray_tpu_torch.init(num_cpus=1, device="cpu")
    try:
        s = torch.eye(3).to_sparse()
        ref = ray_tpu_torch.put(s)
        core = _core(PORT)
        assert core.memory_store.get_entry(ref.object_id()) is not None
        assert torch.equal(ray_tpu_torch.get(ref).to_dense(), torch.eye(3))
    finally:
        ray_tpu_torch.shutdown()


_RUNS = []
_GATE = threading.Event()


def _gated_return(n):
    _RUNS.append(n)
    assert _GATE.wait(30), "the gate never opened"
    return torch.arange(n, dtype=torch.float32)


def case_get_during_device_return(env):
    """``get`` of a device return that another node seals while the get
    waits on the memory store (where a device return puts nothing): the
    task finishes in that wait, and the get must read its location, not
    reconstruct the task from lineage (ROADMAP C.21; the reference's
    ``_get_one`` decides on the locations it read before the wait)."""
    core = _core(env.name)
    ref = _far(env, _gated_return).remote(64)
    real_get = core.memory_store.get

    def finish_in_the_wait(object_id, timeout=None):
        if object_id == ref.object_id() and not _GATE.is_set():
            _GATE.set()
            deadline = time.monotonic() + 30
            while core.task_manager.is_pending(ref.task_id()):
                assert time.monotonic() < deadline, "the task never ended"
                time.sleep(0.005)
            raise env.pkg.exceptions.GetTimeoutError(
                "the task ended in the wait")
        return real_get(object_id, timeout)

    core.memory_store.get = finish_in_the_wait
    try:
        value = env.pkg.get(ref, timeout=30)
    finally:
        core.memory_store.get = real_get
    return torch.equal(value, torch.arange(64.)), list(_RUNS), \
        core.metrics["lineage_reconstructions"]


def test_get_during_a_device_return_reads_it_in_the_port():
    _RUNS.clear()
    _GATE.clear()
    try:
        got = run_case(PORT, _with_far(case_get_during_device_return),
                       HEAD_CPUS)
    finally:
        _GATE.set()
    assert got == ("value", (True, [64], 0)), got


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.get(ray_tpu_torch.put(torch.ones(4)))
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
