"""The port's ecosystem shims (``ray_tpu_torch.util.multiprocessing``,
``util.joblib``, ``util.dask``) against the JAX package's, on the CPU.

Each case of ``tests/test_ecosystem.py``'s ``TestMultiprocessingPool``,
``TestJoblibBackend`` and ``TestDaskOnRayTpu`` runs the same user code
once under each package's ``init`` (the port's with ``device="cpu"``),
and the outcomes (the values, or the error's type and message with the
package's name read as one) must be equal and meet the reference test's
own predicates.  ``TestDashboard`` waits for the cluster tooling (ROADMAP
A.4b.10).  The joblib case skips where joblib is not installed; the
dask cases run the graph executor without dask, as the reference's do,
and where dask is not installed ``enable_dask_on_ray_tpu`` raises its
``ImportError`` in both.  The last test checks that no thread of the
port outlives ``shutdown``.
"""

import importlib
from operator import add, mul

import numpy as np
import pytest

import ray_tpu_torch
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
except ImportError:
    ray_tpu = None


def _sq(x):
    return x * x


def _addmul(a, b, c=1):
    return (a + b) * c


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.mp = importlib.import_module(f"{name}.util.multiprocessing")
        self.dask = importlib.import_module(f"{name}.util.dask")

    @property
    def joblib_backend(self):
        return "ray_tpu_torch" if self.name == PORT else "ray_tpu"


def run(name, case):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=4, **kw)
    try:
        return outcome(lambda: case(p))
    finally:
        p.pkg.shutdown()


def both(case):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case) for name in ("ray_tpu", PORT)]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return type(e).__name__
    return None


# -- TestMultiprocessingPool --------------------------------------------------

def case_map(p):
    with p.mp.Pool(3) as pool:
        return pool.map(_sq, range(20))


def case_apply_and_async(p):
    with p.mp.Pool(2) as pool:
        applied = pool.apply(_addmul, (2, 3), {"c": 10})
        res = pool.apply_async(_addmul, (1, 1))
        res.wait(timeout=30)
        return applied, res.ready(), res.get(timeout=30), res.successful()


def case_starmap_and_imap(p):
    with p.mp.Pool(2) as pool:
        return (pool.starmap(_addmul, [(1, 2), (3, 4)]),
                list(pool.imap(_sq, range(7))),
                sorted(pool.imap_unordered(_sq, range(7))))


def case_initializer_and_close(p):
    def init(v):
        import builtins
        builtins._POOL_SEED = v

    def read(_):
        import builtins
        return builtins._POOL_SEED

    pool = p.mp.Pool(2, initializer=init, initargs=(42,))
    out = pool.map(read, range(4))
    pool.close()
    closed = _raises(lambda: pool.map(_sq, [1]))
    pool.join()
    return out, closed


def case_map_256_chunked(p):
    """``chip_smoke.py`` W1's map: 256 items over 4 actors."""
    with p.mp.Pool(4) as pool:
        return pool.map(_sq, range(256))


# -- TestJoblibBackend --------------------------------------------------------

def case_joblib_parallel_roundtrip(p):
    import joblib
    register = importlib.import_module(f"{p.name}.util.joblib").register_ray
    register()
    with joblib.parallel_backend(p.joblib_backend, n_jobs=4):
        return joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(12))


# -- TestDaskOnRayTpu ---------------------------------------------------------

def case_dask_simple_graph(p):
    get = p.dask.ray_tpu_dask_get
    dsk = {
        "a": 1,
        "b": (add, "a", 2),          # 3
        "c": (mul, "b", "b"),        # 9
        "d": (sum, ["a", "b", "c"]),  # 13
    }
    return get(dsk, "d"), get(dsk, ["c", "d"]), get(dsk, [["a"], ["b", "c"]])


def _make(i):
    return np.full(4, float(i))


def case_dask_chunked_keys_and_fanout(p):
    dsk = {("x", i): (_make, i) for i in range(6)}
    dsk["total"] = (sum, [(np.sum, ("x", i)) for i in range(6)])
    return float(p.dask.ray_tpu_dask_get(dsk, "total"))


def case_dask_cycle_detected(p):
    dsk = {"a": (add, "b", 1), "b": (add, "a", 1)}
    return p.dask.ray_tpu_dask_get(dsk, "a")


def case_dask_intermediates_stay_in_object_store(p):
    dsk = {
        "base": (np.ones, 200_000),
        "scaled": ((lambda a: a * 3), "base"),
        "norm": ((lambda a: float(a.sum())), "scaled"),
    }
    return p.dask.ray_tpu_dask_get(dsk, "norm")


def case_enable_dask_without_dask(p):
    return p.dask.enable_dask_on_ray_tpu()


CASES = {
    case_map: ("value", [i * i for i in range(20)]),
    case_apply_and_async: ("value", (50, True, 2, True)),
    case_starmap_and_imap: ("value", ([3, 7], [i * i for i in range(7)],
                                      sorted(i * i for i in range(7)))),
    case_initializer_and_close: ("value", ([42] * 4, "ValueError")),
    case_map_256_chunked: ("value", [i * i for i in range(256)]),
    case_joblib_parallel_roundtrip: ("value", [i * i for i in range(12)]),
    case_dask_simple_graph: ("value", (13, [9, 13], [[1], [3, 9]])),
    case_dask_chunked_keys_and_fanout: ("value",
                                        sum(4.0 * i for i in range(6))),
    case_dask_cycle_detected: ("raise", "ValueError",
                               "cycle in dask graph at key 'a'"),
    case_dask_intermediates_stay_in_object_store: ("value", 600_000.0),
}


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__[5:])
def test_shim_case_matches_jax(case):
    if case is case_joblib_parallel_roundtrip:
        pytest.importorskip("joblib")
    want, got = both(case)
    assert got == want
    assert got == CASES[case]


def test_enable_dask_without_dask_matches_jax():
    try:
        import dask  # noqa: F401
        pytest.skip("dask is installed")
    except ImportError:
        pass
    want, got = both(case_enable_dask_without_dask)
    assert got == want
    assert got[:2] == ("raise", "ImportError")


def test_util_exposes_the_shims():
    util = ray_tpu_torch.util
    assert util.multiprocessing.Pool is importlib.import_module(
        "ray_tpu_torch.util.multiprocessing").Pool
    assert callable(util.joblib.register_ray)


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_ecosystem")
