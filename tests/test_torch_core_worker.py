"""The port's task API (``ray_tpu_torch.init`` -> ``@remote`` ->
``.remote()`` -> ``get``/``wait``/``put``) against the JAX package's, on
the CPU.

Each case runs once under ``ray_tpu.init(num_cpus=4)`` and once under
``ray_tpu_torch.init(num_cpus=4, device="cpu")``, on inputs drawn from
the same numpy seed, and the two outcomes must be equal: the values, or
the error's type and message (ids masked, the package's name read as
one).  The cases are those of ``tests/test_basic.py``, its two large
objects through the node store included (the rest of the object plane
is ``tests/test_torch_object_plane.py``); the four of
``tests/test_reference_counting.py`` with the owner's memory-store
entry counts; retries; ``wait`` under controlled completion; the
stand-ins that raise; ``init`` without a card.  The task functions live
at module level, so that both packages' function export pickles them by
reference, and a task blocks on a ``threading.Event`` of this module
where the reference's tests sleep.  A ``gpu`` twin runs the basic cases
on the card's raylet against ``device="cpu"``, and a card test puts,
reads, returns, passes and pulls a CUDA tensor.  The last test checks
that no thread of the port outlives ``shutdown``.
"""

import gc
import importlib
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
INIT = {"ray_tpu": dict(num_cpus=4),
        PORT: dict(num_cpus=4, device="cpu")}

# -- task bodies (module level: exported by reference) ------------------------

_GATES = {}


def _gate(name):
    _GATES[name] = threading.Event()
    return name


def _add(a, b):
    return a + b


def _defaults(a, b=10, *, c=100):
    return a + b + c


def _double(x):
    return x * 2


def _incr(x=0):
    return x + 1


def _identity(x):
    return x


def _three():
    return 1, 2, 3


def _nothing():
    return None


def _assigned(pkg_name):
    pkg = importlib.import_module(pkg_name)
    return pkg.get_runtime_context().get_assigned_resources()


def _raise_value(message):
    raise ValueError(message)


def _raise_key(key):
    raise KeyError(key)


def _square(i):
    return i * i


def _sum_of_squares(pkg_name, n):
    pkg = importlib.import_module(pkg_name)
    square = pkg.remote(_square)
    return sum(pkg.get([square.remote(i) for i in range(n)]))


def _gated(name, value):
    assert _GATES[name].wait(30), f"gate {name} never opened"
    return value


def _deref(pkg_name, d):
    return importlib.import_module(pkg_name).get(d["ref"])


def _whoami(pkg_name):
    ctx = importlib.import_module(pkg_name).get_runtime_context()
    return ctx.get_task_id(), ctx.get_node_id(), ctx.get_job_id()


_ATTEMPTS = {}


def _flaky(key, failures, value):
    """Fails its first ``failures`` attempts, counted under ``key``."""
    _ATTEMPTS[key] = _ATTEMPTS.get(key, 0) + 1
    if _ATTEMPTS[key] <= failures:
        raise RuntimeError(f"attempt {_ATTEMPTS[key]} of {key} failed")
    return value


def _make_big(nbytes):
    return np.zeros(nbytes, np.uint8)


def _total(a):
    return float(a.sum())


# -- running a case under each package ----------------------------------------

def _normalize(message):
    message = message.replace("ray_tpu_torch", "ray_tpu")
    return re.sub(r"[0-9a-f]{16,}", "<id>", message)


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("raise", type(e).__name__, _normalize(str(e)))


def _run(pkg_name, case, seed, init_kw=None):
    """``case`` under ``pkg_name``'s ``init``, its node stores spilling
    under a temporary directory that goes with the run."""
    pkg = importlib.import_module(pkg_name)
    temp_dir = tempfile.mkdtemp(prefix=f"{pkg_name}-")
    pkg.init(**(init_kw or INIT[pkg_name]),
             _system_config={"temp_dir": temp_dir})
    try:
        return _outcome(lambda: case(pkg, pkg_name,
                                     np.random.default_rng(seed)))
    finally:
        for event in _GATES.values():
            event.set()
        _GATES.clear()
        pkg.shutdown()
        importlib.import_module(
            f"{pkg_name}._private.config").initialize_config()
        shutil.rmtree(temp_dir, ignore_errors=True)


def _both(case, seed=0):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [_run(name, case, seed) for name in ("ray_tpu", PORT)]


def _core(pkg_name):
    return importlib.import_module(
        f"{pkg_name}._private.worker").global_worker().core_worker


# -- tests/test_basic.py ------------------------------------------------------

def case_simple_task(pkg, name, rng):
    a, b = (int(v) for v in rng.integers(0, 1000, size=2))
    return pkg.get(pkg.remote(_add).remote(a, b))


def case_kwargs_and_defaults(pkg, name, rng):
    a, b, c = (int(v) for v in rng.integers(0, 1000, size=3))
    f = pkg.remote(_defaults)
    return [pkg.get(f.remote(a)), pkg.get(f.remote(a, b=b, c=c))]


def case_object_ref_args(pkg, name, rng):
    f = pkg.remote(_double)
    r1 = f.remote(int(rng.integers(0, 1000)))
    return pkg.get(f.remote(r1))     # ref as arg resolves to its value


def case_kwarg_object_ref(pkg, name, rng):
    ref = pkg.put(int(rng.integers(0, 1000)))
    return pkg.get(pkg.remote(_incr).remote(x=ref))


def case_put_get_roundtrip(pkg, name, rng):
    n = int(rng.integers(0, 1000))
    values = [n, f"s{n}", [n, 2, {"k": (3, n)}], None, bytes([n % 256])]
    return [pkg.get(pkg.put(v)) for v in values]


def case_put_get_numpy(pkg, name, rng):
    # test_basic's 1 MiB array: it leaves the owner's memory store for
    # the node store.
    x = rng.random((1024, 256)).astype(np.float32)
    y = pkg.get(pkg.put(x))
    return y.dtype.str, y.shape, y.tobytes() == x.tobytes()


def case_large_object_through_node_store(pkg, name, rng):
    x = np.zeros(10 * 1024 * 1024, dtype=np.uint8)
    x[::4096] = rng.integers(0, 255, x.size // 4096, dtype=np.uint8)
    y = pkg.get(pkg.put(x))
    return y.nbytes, bool((y == x).all())


def case_large_arg_promotion(pkg, name, rng):
    big = np.ones(2 * 1024 * 1024, dtype=np.float64)
    big[rng.integers(0, big.size, 100)] = 2.0
    got = pkg.get(pkg.remote(_total).remote(big))
    return got == float(big.sum()), \
        int(pkg.get(pkg.remote(_make_big).remote(200 * 1024)).nbytes)


def case_num_returns(pkg, name, rng):
    a, b, c = pkg.remote(num_returns=3)(_three).remote()
    return pkg.get([a, b, c])


def case_num_returns_zero(pkg, name, rng):
    return pkg.remote(num_returns=0)(_nothing).remote()


def case_options_override(pkg, name, rng):
    f = pkg.remote(num_cpus=1)(_assigned)
    return pkg.get(f.options(num_cpus=2).remote(name))


def case_error_propagation(pkg, name, rng):
    return pkg.get(pkg.remote(_raise_value).remote("bang"))


def case_error_through_dependency(pkg, name, rng):
    use = pkg.remote(_identity)
    return pkg.get(use.remote(pkg.remote(_raise_key).remote("k")))


def case_nested_tasks(pkg, name, rng):
    return pkg.get(pkg.remote(_sum_of_squares).remote(name, 5))


def case_wait(pkg, name, rng):
    fast, slow = pkg.remote(_identity), pkg.remote(_gated)
    gate = _gate("wait")
    refs = [fast.remote(1), slow.remote(gate, 2)]
    ready, not_ready = pkg.wait(refs, num_returns=1, timeout=10)
    split = (len(ready), len(not_ready), ready == refs[:1])
    _GATES[gate].set()
    return split, pkg.get(refs)


def case_wait_validation(pkg, name, rng):
    r = pkg.put(1)
    return [_outcome(lambda: pkg.wait([r, r])),
            _outcome(lambda: pkg.wait([1, 2]))]


def case_get_timeout(pkg, name, rng):
    gate = _gate("hang")
    return pkg.get(pkg.remote(_gated).remote(gate, None), timeout=0.2)


def case_many_tasks_throughput(pkg, name, rng):
    f = pkg.remote(_identity)
    values = [int(v) for v in rng.permutation(500)]
    return pkg.get([f.remote(i) for i in values]) == values


def case_nested_object_refs(pkg, name, rng):
    inner = pkg.put("inner-value")
    outer = pkg.put({"ref": inner})
    return pkg.get(pkg.remote(_deref).remote(name, outer))


def case_runtime_context(pkg, name, rng):
    task_id, node_id, job_id = pkg.get(pkg.remote(_whoami).remote(name))
    head = importlib.import_module(f"{name}._private.worker") \
        .global_worker().cluster.head_node
    return bool(task_id), node_id == head.node_id.hex(), bool(job_id)


def case_reinit_guard(pkg, name, rng):
    # Runs inside _run's init: a second init raises, an ignored one not.
    again = _outcome(lambda: pkg.init())
    pkg.init(ignore_reinit_error=True)
    return again, pkg.is_initialized()


def case_function_id_not_confused_by_id_reuse(pkg, name, rng):
    def make_probe():
        def probe():            # content-identical every time
            return "probe"
        return probe

    for _ in range(5):
        pkg.remote(make_probe()).remote()
    gc.collect()
    outs = []
    for i in range(50):
        def different(x, _i=i):
            return ("different", x, _i)
        fn = pkg.remote(different)
        outs.append(pkg.get(fn.remote(7), timeout=60))
        del different, fn
        gc.collect()
    return outs == [("different", 7, i) for i in range(50)]


BASIC_CASES = [case_simple_task, case_kwargs_and_defaults,
               case_object_ref_args, case_kwarg_object_ref,
               case_put_get_roundtrip, case_put_get_numpy,
               case_large_object_through_node_store,
               case_large_arg_promotion, case_num_returns,
               case_num_returns_zero, case_options_override,
               case_error_propagation, case_error_through_dependency,
               case_nested_tasks, case_wait, case_wait_validation,
               case_get_timeout, case_many_tasks_throughput,
               case_nested_object_refs, case_runtime_context,
               case_reinit_guard,
               case_function_id_not_confused_by_id_reuse]


def _name(case):
    return case.__name__[len("case_"):]


@pytest.mark.parametrize("case", BASIC_CASES, ids=_name)
def test_basic_case_matches_jax(case):
    jax_out, port_out = _both(case, seed=BASIC_CASES.index(case))
    assert port_out == jax_out
    # The outcome the case's test in test_basic.py asserts.
    expected_raise = {"error_propagation": "ValueError",
                      "error_through_dependency": "KeyError",
                      "get_timeout": "GetTimeoutError"}.get(_name(case))
    if expected_raise:
        assert port_out[:2] == ("raise", expected_raise), port_out
    else:
        assert port_out[0] == "value", port_out


def test_error_keeps_its_class_and_message():
    """``except ValueError`` works across the task boundary, as the
    reference's ``as_instanceof_cause`` makes it."""
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        with pytest.raises(ValueError, match="bang") as info:
            ray_tpu_torch.get(ray_tpu_torch.remote(_raise_value)
                              .remote("bang"))
        assert isinstance(info.value.__cause__,
                          ray_tpu_torch.exceptions.TaskError)
    finally:
        ray_tpu_torch.shutdown()


# -- tests/test_reference_counting.py -----------------------------------------

def _observe(name, oid):
    """(has_reference, memory-store entries) with releases settled."""
    core = _core(name)
    core.reference_counter.flush_pending_releases()
    return core.reference_counter.has_reference(oid), \
        core.memory_store.size()


def refs_out_of_scope_frees_object(pkg, name, rng):
    ref = pkg.put(rng.integers(0, 255, 16 * 1024, dtype=np.uint8))
    oid = ref.object_id()
    seen = [_observe(name, oid)]
    del ref
    gc.collect()
    seen.append(_observe(name, oid))
    return seen


def refs_submitted_task_ref_pins(pkg, name, rng):
    gate = _gate("pins")
    value = int(rng.integers(0, 1000))
    ref = pkg.put(value)
    oid = ref.object_id()
    out = pkg.remote(_gated).remote(gate, ref)
    del ref
    gc.collect()
    # The pending task still holds a reference.
    seen = [_observe(name, oid)]
    _GATES[gate].set()
    got = pkg.get(out)
    del out
    gc.collect()
    # The return is sealed before the worker completes the task and
    # drops its submitted-task refs (in both packages): the pin must go
    # within a moment.
    counter = _core(name).reference_counter
    deadline = time.monotonic() + 30
    while counter.has_reference(oid):
        assert time.monotonic() < deadline, "the task's pin never went"
        time.sleep(0.001)
    seen.append(_observe(name, oid))
    return seen, got == value


def refs_contained_ref_kept_alive(pkg, name, rng):
    inner = pkg.put("payload")
    inner_id = inner.object_id()
    outer = pkg.put([inner])
    del inner
    gc.collect()
    # Outer's value contains the inner ref -> still reachable.
    seen = [_observe(name, inner_id)]
    got_inner = pkg.get(outer)[0]
    payload = pkg.get(got_inner)
    del got_inner, outer
    gc.collect()
    seen.append(_observe(name, inner_id))
    return seen, payload


def refs_return_value_lifetime(pkg, name, rng):
    ones = pkg.remote(_identity).remote(np.ones(4))
    value = pkg.get(ones).tolist()
    oid = ones.object_id()
    seen = [_observe(name, oid)]
    del ones
    gc.collect()
    seen.append(_observe(name, oid))
    return seen, value


@pytest.mark.parametrize("case", [
    refs_out_of_scope_frees_object, refs_submitted_task_ref_pins,
    refs_contained_ref_kept_alive, refs_return_value_lifetime],
    ids=lambda c: c.__name__[len("refs_"):])
def test_reference_counting_matches_jax(case):
    jax_out, port_out = _both(case, seed=7)
    assert port_out == jax_out
    assert port_out[0] == "value", port_out
    seen = port_out[1] if case is refs_out_of_scope_frees_object \
        else port_out[1][0]
    (held, before), (after_held, after) = seen
    assert held and not after_held and after < before


# -- retries and wait ---------------------------------------------------------

@pytest.mark.parametrize("max_retries,retry_exceptions,failures", [
    (2, True, 1), (1, True, 3), (3, False, 1), (0, True, 1)])
def test_retries_match_jax(max_retries, retry_exceptions, failures):
    def case(pkg, name, rng):
        key = f"{name}-{max_retries}-{retry_exceptions}-{failures}"
        _ATTEMPTS.pop(key, None)
        f = pkg.remote(max_retries=max_retries,
                       retry_exceptions=retry_exceptions)(_flaky)
        out = _outcome(lambda: pkg.get(f.remote(key, failures, "done")))
        return out, _ATTEMPTS[key]

    jax_out, port_out = _both(case)
    assert port_out == jax_out
    (result, attempts) = port_out[1]
    succeeds = retry_exceptions and failures <= max_retries
    assert attempts == (failures + 1 if succeeds else
                        1 + (max_retries if retry_exceptions else 0))
    assert (result == ("value", "done")) == succeeds


def test_wait_with_controlled_completion_matches_jax():
    """Twelve gated tasks; a seeded subset is released at a time: the
    ready and not-ready splits of each ``wait`` are equal."""
    def case(pkg, name, rng):
        gates = [_gate(f"w{i}") for i in range(12)]
        # A quarter CPU each: all twelve run at once on 4 CPUs.
        f = pkg.remote(num_cpus=0.25)(_gated)
        refs = [f.remote(g, i) for i, g in enumerate(gates)]
        splits = []

        def split(ready, not_ready):
            return (sorted(refs.index(r) for r in ready),
                    sorted(refs.index(r) for r in not_ready))
        splits.append(split(*pkg.wait(refs, num_returns=1, timeout=0.05)))
        released = []
        for size in (3, 4):
            pick = rng.choice([i for i in range(12) if i not in released],
                              size=size, replace=False)
            for i in pick:
                _GATES[gates[int(i)]].set()
            released.extend(int(i) for i in pick)
            splits.append(split(*pkg.wait(refs, num_returns=len(released),
                                          timeout=30)))
        splits.append(split(*pkg.wait(refs, num_returns=12, timeout=0.05)))
        for g in gates:
            _GATES[g].set()
        return splits, pkg.get(refs), sorted(released)

    jax_out, port_out = _both(case, seed=3)
    assert port_out == jax_out
    splits, values, released = port_out[1]
    assert values == list(range(12))
    assert splits[0] == ([], list(range(12)))
    assert splits[2][0] == released and splits[3][0] == released


# -- the stand-ins and the card -----------------------------------------------

def test_stand_ins_raise_not_implemented():
    """What the port does not have yet raises, naming its item: the
    native shared-memory object store (A.4b.2b).  A placement-group
    strategy, a stand-in until placement groups were ported (A.4b.3),
    now runs its task in the group's bundle; an actor class, a stand-in
    until actors were ported (A.4b.5), gives an actor; a runtime env (for
    a task and for an actor) and process workers, stand-ins until
    A.4b.9a, run and return."""
    from ray_tpu_torch._private.config import initialize_config
    from ray_tpu_torch.util import placement_group
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy
    try:
        with pytest.raises(NotImplementedError, match="A.4b.2b"):
            ray_tpu_torch.init(num_cpus=1, device="cpu", _system_config={
                "use_native_object_store": True})
    finally:
        initialize_config()
    assert not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        big = np.zeros(200 * 1024, np.uint8)
        f = ray_tpu_torch.remote(_identity)
        group = placement_group([{"CPU": 1}])
        assert group.wait(10)
        pg = PlacementGroupSchedulingStrategy(group, 0)
        assert ray_tpu_torch.get(
            f.options(scheduling_strategy=pg).remote(1), timeout=10) == 1
        assert ray_tpu_torch.get(f.options(runtime_env={
            "env_vars": {"A": "1"}}).remote(1), timeout=10) == 1
        actor_class = ray_tpu_torch.remote(
            type("Actor", (), {"ping": lambda self: "pong"}))
        assert ray_tpu_torch.get(actor_class.options(runtime_env={
            "env_vars": {"A": "1"}}).remote().ping.remote(),
            timeout=10) == "pong"
        assert ray_tpu_torch.get(actor_class.remote().ping.remote(),
                                 timeout=10) == "pong"
        assert ray_tpu_torch.get(f.remote(big)).nbytes == 200 * 1024
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, device="cpu", _system_config={
        "worker_process_mode": "process"})
    try:
        # A worker process cannot import this module: a nested function
        # is pickled by value.
        def identity(x):
            return x
        assert ray_tpu_torch.get(ray_tpu_torch.remote(identity).remote(
            big), timeout=60).nbytes == 200 * 1024
    finally:
        ray_tpu_torch.shutdown()
        initialize_config()
    assert not ray_tpu_torch.is_initialized()


def test_init_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ray_tpu_torch.init(num_cpus=1)
    assert not ray_tpu_torch.is_initialized()
    ray_tpu_torch.init(num_cpus=1, device="cpu")
    try:
        assert ray_tpu_torch.get(ray_tpu_torch.put(5)) == 5
        assert ray_tpu_torch.cluster_resources() == {"CPU": 1.0}
        assert [n["Alive"] for n in ray_tpu_torch.nodes()] == [True]
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raylets' tick runs its "
                    "kernel only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", BASIC_CASES, ids=_name)
def test_basic_case_on_card_matches_cpu(case, cuda_device):
    """The basic cases with the raylet's tick on the card, against the
    port with ``device="cpu"``."""
    seed = BASIC_CASES.index(case)
    card = _run(PORT, case, seed, dict(num_cpus=4))
    host = _run(PORT, case, seed, INIT[PORT])
    assert card == host


def _on_card(t):
    return t.device.type, t.data_ptr()


def _card_return(n):
    return torch.arange(n, device="cuda", dtype=torch.float32)


@pytest.mark.gpu
def test_cuda_tensor_as_object_round_trips(cuda_device):
    """A CUDA tensor put, read on its node (the stored tensor, no host
    copy), returned, passed inline (its host form) and pulled to another
    raylet (its host form, bf16 kept)."""
    from ray_tpu_torch._private.serialization import copy_stats
    ray_tpu_torch.init(num_cpus=2, resources={"head": 10})
    try:
        cluster = ray_tpu_torch._private.worker.global_worker().cluster
        cluster.add_node({"CPU": 1, "far": 1}, node_name="far")
        on_head = ray_tpu_torch.remote(resources={"head": 1})(_on_card)
        x = torch.randn(1 << 20, device=cuda_device)
        t = x.clone()
        host0 = copy_stats["bytes_copied"]
        ref = ray_tpu_torch.put(t)
        t.zero_()
        got = ray_tpu_torch.get(ref)
        assert got.is_cuda and torch.equal(got, x)
        assert got is ray_tpu_torch.get(ref)
        assert copy_stats["bytes_copied"] == host0
        assert ray_tpu_torch.get(on_head.remote(ref)) == \
            ("cuda", got.data_ptr())
        ret = ray_tpu_torch.remote(resources={"head": 1})(
            _card_return).remote(1000)
        assert ray_tpu_torch.wait([ret], timeout=30)[0] == [ret]
        assert torch.equal(ray_tpu_torch.get(ret),
                           torch.arange(1000., device=cuda_device))
        small = torch.ones(4, device=cuda_device)
        assert ray_tpu_torch.get(on_head.remote(small))[0] == "cpu"
        far = ray_tpu_torch.remote(resources={"far": 1})(_identity)
        for dtype in (torch.float32, torch.bfloat16):
            y = x.to(dtype)
            pulled = ray_tpu_torch.get(far.remote(ray_tpu_torch.put(y)))
            assert pulled.device.type == "cpu" and pulled.dtype == dtype
            assert torch.equal(pulled, y.cpu())
        assert ray_tpu_torch.cluster_resources()["GPU"] == \
            torch.cuda.device_count()
    finally:
        ray_tpu_torch.shutdown()


def test_no_port_thread_survives_shutdown():
    """Runs last in this file: every worker thread, raylet loop, the
    broadcast and the release thread of the cases above are gone."""
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.get([ray_tpu_torch.remote(_identity).remote(i)
                       for i in range(20)])
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
