"""The port's scheduling tick (``ray_tpu_torch``) against the JAX package.

Inputs are made with numpy from a seed and go through both packages on
the CPU (``device="cpu"`` in the port).  Allocations and packed stream
outputs must be identical, bit for bit; the numpy oracles of both
packages are checked too.  Tests marked ``gpu`` run the same paths on
the card and skip without one.
"""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from ray_tpu.scheduler import jax_backend as jb
from ray_tpu.scheduler import policy as jpolicy
from ray_tpu.scheduler import resources as jres
from ray_tpu_torch.ops import class_fill as cf
from ray_tpu_torch.scheduler import convert
from ray_tpu_torch.scheduler import policy as tpolicy
from ray_tpu_torch.scheduler import resources as tres
from ray_tpu_torch.scheduler import torch_backend as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_problem(rng, C=12, N=40, R=4):
    total = rng.integers(1, 32, size=(N, R)).astype(np.float32)
    used_frac = rng.uniform(0, 0.5, size=(N, R)).astype(np.float32)
    avail = np.floor(total * (1 - used_frac))
    demand = np.zeros((C, R), dtype=np.float32)
    for c in range(C):
        k = rng.integers(1, R + 1)
        cols = rng.choice(R, size=k, replace=False)
        demand[c, cols] = rng.integers(1, 4, size=k)
    counts = rng.integers(0, 50, size=C)
    accel_node = rng.random(N) < 0.25
    accel_class = rng.random(C) < 0.2
    return avail, total, demand, counts, accel_node, accel_class


def build_problem(rng, num_tasks=1_000_000, C=256, N=10_000, R=8):
    """A copy of bench.py's problem builder (heterogeneous fleet,
    power-law class counts)."""
    total = np.zeros((N, R), dtype=np.float32)
    kinds = rng.choice(3, size=N, p=[0.6, 0.3, 0.1])
    total[:, 0] = np.where(kinds == 0, 4, np.where(kinds == 1, 64, 8))
    total[:, 1] = np.where(kinds == 0, 16, np.where(kinds == 1, 256, 64))
    total[:, 2] = np.where(kinds == 2, 4, 0)
    total[:, 3] = rng.integers(0, 2, N)
    for r in range(4, R):
        total[:, r] = rng.integers(0, 8, N)
    used = rng.uniform(0.0, 0.6, size=(N, R)).astype(np.float32)
    avail = np.floor(total * (1.0 - used))
    demand = np.zeros((C, R), dtype=np.float32)
    demand[:, 0] = rng.choice([0.5, 1, 2, 4], size=C,
                              p=[0.4, 0.4, 0.15, 0.05])
    demand[:, 1] = rng.choice([1, 2, 4, 16], size=C,
                              p=[0.5, 0.3, 0.15, 0.05])
    accel_classes = rng.random(C) < 0.08
    demand[accel_classes, 2] = rng.choice([1, 4], size=accel_classes.sum())
    raw = rng.pareto(1.5, size=C) + 1.0
    counts = np.floor(raw / raw.sum() * num_tasks).astype(np.int64)
    counts[-1] += num_tasks - counts.sum()
    accel_node = total[:, 2] > 0
    return avail, total, demand, counts, accel_node, accel_classes


def arrival_stream(rng, counts, ticks, per_tick=130_000):
    """A copy of bench.py's arrival stream."""
    C = counts.shape[0]
    stream = np.empty((ticks, C), dtype=np.int64)
    stream[0] = counts
    frac = counts / counts.sum()
    for k in range(1, ticks):
        mix = np.roll(frac, k)
        row = np.floor(mix * per_tick).astype(np.int64)
        row += rng.integers(0, 3, size=C)
        stream[k] = row
    return stream


def _assert_stream_equal(a, b):
    for key in ("idx", "vals", "placed", "ok", "nnz"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# -- solve_matrices ----------------------------------------------------------

class TestSolveMatrices:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("N", [40, 300])
    def test_matches_jax_and_oracles(self, seed, N):
        rng = np.random.default_rng(seed)
        avail, total, demand, counts, an, ac = random_problem(rng, N=N)
        got = tb.BatchSolver(device="cpu").solve_matrices(
            avail, total, demand, counts, an, ac, spread_threshold=0.5)
        want = jb.BatchSolver().solve_matrices(
            avail, total, demand, counts, an, ac, spread_threshold=0.5)
        np.testing.assert_array_equal(got, want)
        oracle = tb.waterfill_oracle(avail, total, demand, counts, an, ac,
                                     spread_threshold=0.5)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(
            oracle, jb.waterfill_oracle(avail, total, demand, counts, an,
                                        ac, spread_threshold=0.5))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_cost_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        avail, total, demand, counts, an, ac = random_problem(rng, C=10)
        cost = np.where(rng.random((10, 40)) < 0.15,
                        rng.uniform(-0.7, 0.5, (10, 40)),
                        0.0).astype(np.float32)
        got = tb.BatchSolver(device="cpu").solve_matrices(
            avail, total, demand, counts, an, ac, spread_threshold=0.5,
            cost=cost)
        want = jb.BatchSolver().solve_matrices(
            avail, total, demand, counts, an, ac, spread_threshold=0.5,
            cost=cost)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tb.waterfill_oracle(
            avail, total, demand, counts, an, ac, 0.5, cost=cost))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_pack_mode_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        avail, total, demand, counts, an, ac = random_problem(rng, N=300)
        kw = dict(spread_threshold=0.0, invert_util=True, zero_shifts=True)
        got = tb.BatchSolver(device="cpu").solve_matrices(
            avail, total, demand, counts, an, ac, **kw)
        want = jb.BatchSolver().solve_matrices(
            avail, total, demand, counts, an, ac, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tb.waterfill_oracle(
            avail, total, demand, counts, an, ac, **kw))

    def test_capacity_never_violated(self):
        rng = np.random.default_rng(1)
        solver = tb.BatchSolver(device="cpu")
        for _ in range(3):
            avail, total, demand, counts, an, ac = random_problem(
                rng, C=20, N=64, R=5)
            alloc = solver.solve_matrices(avail, total, demand, counts,
                                          an, ac)
            usage = alloc.T.astype(np.float64) @ demand.astype(np.float64)
            assert (usage <= avail + 1e-3).all()
            assert (alloc.sum(axis=1) <= counts).all()

    def test_all_assigned_when_plenty_and_infeasible_left(self):
        solver = tb.BatchSolver(device="cpu")
        avail = total = np.full((8, 2), 100.0, dtype=np.float32)
        demand = np.array([[1.0, 0.0], [0.0, 2.0]], dtype=np.float32)
        alloc = solver.solve_matrices(avail, total, demand,
                                      np.array([100, 50]))
        assert alloc.sum(axis=1).tolist() == [100, 50]
        small = np.full((4, 1), 2.0, dtype=np.float32)
        alloc = solver.solve_matrices(small, small,
                                      np.array([[5.0]], np.float32),
                                      np.array([10]))
        assert alloc.sum() == 0

    def test_accel_class_on_accel_nodes_cpu_avoids(self):
        total = np.zeros((8, 3), dtype=np.float32)
        total[:, 0] = 8.0
        total[4:, 2] = 4.0
        demand = np.array([[1.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
        alloc = tb.BatchSolver(device="cpu").solve_matrices(
            total.copy(), total, demand, np.array([8, 16]),
            total[:, 2] > 0, np.array([True, False]), spread_threshold=0.5)
        assert alloc[0, :4].sum() == 0 and alloc[0].sum() == 8
        assert alloc[1, 4:].sum() == 0 and alloc[1].sum() == 16


# -- prepare_device + solve_stream ------------------------------------------

class TestTickStream:
    def test_stream_matches_jax_and_oracle(self):
        rng = np.random.default_rng(3)
        avail, total, demand, counts, an, ac = random_problem(rng)
        K = 6
        arrivals = np.stack([np.roll(counts, k) for k in range(K)])
        rho = rng.integers(1, 9, size=demand.shape[0]) / 16.0   # dyadic
        port, ref = tb.BatchSolver(device="cpu"), jb.BatchSolver()
        for s in (port, ref):
            s.prepare_device(avail, total, demand, accel_node=an,
                             accel_class=ac, spread_threshold=0.5)
        out = port.solve_stream(arrivals, nnz_max=512, rho=rho)
        _assert_stream_equal(out, ref.solve_stream(arrivals, nnz_max=512,
                                                   rho=rho))
        assert out["ok"].all()
        want = tb.stream_oracle(avail, total, demand, arrivals, rho, an, ac,
                                spread_threshold=0.5)
        for k in range(K):
            alloc = port.expand_sparse(out["idx"][k], out["vals"][k])
            np.testing.assert_array_equal(alloc, want[k], err_msg=f"tick {k}")
            assert int(out["nnz"][k]) == int((want[k] > 0).sum())
            assert int(out["placed"][k]) == int(want[k].sum())

    def test_stream_drains_then_recovers(self):
        port, ref = tb.BatchSolver(device="cpu"), jb.BatchSolver()
        avail = total = np.full((8, 1), 4.0, dtype=np.float32)
        demand = np.ones((1, 1), dtype=np.float32)
        for s in (port, ref):
            s.prepare_device(avail, total, demand)
        arrivals = np.full((4, 1), 20, dtype=np.int64)
        out = port.solve_stream(arrivals, nnz_max=64, rho=0.0)
        _assert_stream_equal(out, ref.solve_stream(arrivals, nnz_max=64))
        assert out["placed"].astype(int).tolist() == [20, 12, 0, 0]
        steady = np.full((6, 1), 8, dtype=np.int64)
        out2 = port.solve_stream(steady, nnz_max=64, rho=0.5)
        _assert_stream_equal(out2, ref.solve_stream(steady, nnz_max=64,
                                                    rho=0.5))
        assert out2["ok"].all() and out2["placed"][-1] > 0

    def test_stream_overflow_packs_identically(self):
        port, ref = tb.BatchSolver(device="cpu"), jb.BatchSolver()
        avail = total = np.full((16, 2), 100.0, dtype=np.float32)
        demand = np.ones((8, 2), dtype=np.float32)
        for s in (port, ref):
            s.prepare_device(avail, total, demand)
        stream = np.full((2, 8), 16, dtype=np.int64)
        out = port.solve_stream(stream, nnz_max=4)
        assert not out["ok"].any()
        _assert_stream_equal(out, ref.solve_stream(stream, nnz_max=4))

    def test_jax_state_carried_into_port(self):
        """prepare_device in JAX, convert its state, run the stream in
        the port: the packed output is identical."""
        rng = np.random.default_rng(5)
        avail, total, demand, counts, an, ac = random_problem(rng, N=150)
        cost = np.where(rng.random((12, 150)) < 0.1,
                        rng.uniform(-0.5, 0.5, (12, 150)),
                        0.0).astype(np.float32)
        ref = jb.BatchSolver()
        ref.prepare_device(avail, total, demand, accel_node=an,
                           accel_class=ac, spread_threshold=0.5, cost=cost)
        state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                 for k, v in ref._device_state.items()}
        port = tb.BatchSolver(device="cpu")
        port._device_state = convert.batch_state_from_numpy(state, "cpu")
        arrivals = np.stack([np.roll(counts, k) for k in range(4)])
        rho = np.full(12, 0.25)
        _assert_stream_equal(
            port.solve_stream(arrivals, nnz_max=1024, rho=rho),
            ref.solve_stream(arrivals, nnz_max=1024, rho=rho))

    def test_bench_problem_small(self):
        """The whole slice at a small size: bench.py's problem and
        arrival stream (5000 tasks, 16 classes, 300 nodes, 8
        resources, 4 ticks) through both packages."""
        rng = np.random.default_rng(42)
        avail, total, demand, counts, an, ac = build_problem(
            rng, num_tasks=5000, C=16, N=300, R=8)
        stream = arrival_stream(rng, counts, 4, per_tick=800)
        rho = rng.integers(2, 9, size=16) / 16.0
        outs = []
        for s in (tb.BatchSolver(device="cpu"), jb.BatchSolver()):
            s.prepare_device(avail, total, demand, accel_node=an,
                             accel_class=ac, spread_threshold=0.5)
            outs.append(s.solve_stream(stream, nnz_max=4096, rho=rho))
        _assert_stream_equal(*outs)
        assert outs[0]["ok"].all() and outs[0]["placed"][0] > 0


# -- DeviceRuntimeSolver -----------------------------------------------------

def _spec_cls(policy, resources):
    class _Spec:
        def __init__(self, cpu, cls, args=()):
            self.resources = resources.ResourceRequest({"CPU": cpu})
            self.scheduling_options = policy.SchedulingOptions.hybrid()
            self.scheduling_class = cls
            self.args = list(args)
    return _Spec


TSpec = _spec_cls(tpolicy, tres)
JSpec = _spec_cls(jpolicy, jres)


def _view(resources, nodes):
    view = resources.ClusterResourceView()
    for name, total, labels in nodes:
        view.add_node(name, resources.NodeResources(total, labels=labels))
    return view


def _uniform(resources, n=4, cpu=4.0):
    return _view(resources, [(f"node{i}", {"CPU": cpu, "memory": 8.0}, None)
                             for i in range(n)])


def _solver(**kw):
    return tb.DeviceRuntimeSolver(device="cpu", **kw)


class TestDeviceRuntimeSolver:
    def test_solve_then_delta_sync(self):
        view = _uniform(tres)
        solver = _solver()
        specs = [TSpec(1.0, 9101) for _ in range(8)]
        targets = solver.solve(view, specs)
        assert targets is not None and all(t is not None for t in targets)
        assert solver.stats["full_syncs"] == 1
        for t, s in zip(targets, specs):
            assert view.subtract(t, s.resources)
        targets2 = solver.solve(view, [TSpec(1.0, 9101) for _ in range(4)])
        assert targets2 is not None and all(t is not None for t in targets2)
        assert solver.stats["full_syncs"] == 1
        assert solver.stats["row_deltas"] >= 1
        assert solver.stats["fallbacks"] == 0

    def test_structural_change_forces_full_sync(self):
        view = _uniform(tres, n=2)
        solver = _solver()
        assert solver.solve(view, [TSpec(1.0, 9102)]) is not None
        view.add_node("late", tres.NodeResources({"CPU": 4.0}))
        t2 = solver.solve(view, [TSpec(1.0, 9102) for _ in range(9)])
        assert t2 is not None and all(t is not None for t in t2)
        assert solver.stats["full_syncs"] == 2
        assert "late" in t2

    def test_respects_capacity_and_reports_infeasible(self):
        view = _uniform(tres, n=2, cpu=2.0)
        targets = _solver().solve(view, [TSpec(1.0, 9103)
                                         for _ in range(10)])
        assert targets is not None
        placed = [t for t in targets if t is not None]
        assert len(placed) == 4
        assert max(Counter(placed).values()) <= 2

    def test_class_eviction_bounds_demand_matrix(self):
        view = _uniform(tres, n=4, cpu=64.0)
        solver = _solver()
        solver._CLASS_IDLE_TICKS = 4
        for wave in range(40):
            targets = solver.solve(view, [TSpec(1.0, 20000 + wave)])
            assert targets is not None and targets[0] is not None
        assert solver.stats["class_evictions"] > 0
        assert len(solver._class_reqs) < 24
        assert solver._demand_host.shape[0] <= 24
        targets = solver.solve(view, [TSpec(1.0, 20000), TSpec(1.0, 20039)])
        assert targets is not None and all(t is not None for t in targets)

    def test_class_hard_cap_falls_back(self):
        view = _uniform(tres, n=2, cpu=8.0)
        solver = _solver()
        solver._MAX_CLASS_ROWS = 8
        assert solver.solve(view, [TSpec(1.0, 30000 + i)
                                   for i in range(12)]) is None
        assert solver.stats["fallbacks"] == 1

    def test_nnz_above_largest_bucket_and_no_nodes_return_none(self):
        view = _uniform(tres, n=4, cpu=64.0)
        solver = _solver()
        solver._NNZ_BUCKETS = (2,)
        assert solver.solve(view, [TSpec(1.0, 1), TSpec(1.0, 2),
                                   TSpec(1.0, 3)]) is None
        empty = tres.ClusterResourceView()
        assert _solver().solve(empty, [TSpec(1.0, 1)]) is None

    def test_non_hybrid_specs_route_through_policy(self):
        view = _uniform(tres, n=3)
        spec = TSpec(1.0, 5)
        spec.scheduling_options = tpolicy.SchedulingOptions.affinity("node2")
        targets = _solver().solve(view, [spec, TSpec(1.0, 6)])
        assert targets[0] == "node2" and targets[1] is not None

    def test_kernel_failure_resets_session_and_raises(self, monkeypatch):
        view = _uniform(tres)
        solver = _solver()
        assert solver.solve(view, [TSpec(1.0, 1)]) is not None

        def broken(*a, **k):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(tb, "class_fill", broken)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            solver.solve(view, [TSpec(1.0, 1)])
        assert solver._state is None and solver.stats["fallbacks"] == 1

    def test_ticks_match_jax_solver(self):
        """The same ticks (grant, view.subtract, delta tick, a late
        node) through the JAX solver on a ray_tpu view and the port on a
        ray_tpu_torch view give the same targets."""
        nodes = [(f"n{i}", {"CPU": float(2 + i % 5), "memory": 16.0}, None)
                 for i in range(12)]
        tview, jview = _view(tres, nodes), _view(jres, nodes)
        port, ref = _solver(), jb.DeviceRuntimeSolver()

        def tick(make_t, make_j):
            ts, js = make_t(), make_j()
            got, want = port.solve(tview, ts), ref.solve(jview, js)
            assert got == want
            for t, s in zip(got, ts):
                if t is not None:
                    assert tview.subtract(t, s.resources)
            for t, s in zip(want, js):
                if t is not None:
                    assert jview.subtract(t, s.resources)
            return got

        def burst(Spec):
            return [Spec(1.0 + (i % 3) * 0.5, 400 + i % 3)
                    for i in range(20)]

        first = tick(lambda: burst(TSpec), lambda: burst(JSpec))
        assert all(t is not None for t in first)
        tick(lambda: burst(TSpec), lambda: burst(JSpec))
        tview.add_node("late", tres.NodeResources({"CPU": 16.0}))
        jview.add_node("late", jres.NodeResources({"CPU": 16.0}))
        last = tick(lambda: burst(TSpec), lambda: burst(JSpec))
        assert "late" in last
        assert port.stats["full_syncs"] == ref.stats["full_syncs"] == 2
        assert port.stats["row_deltas"] == ref.stats["row_deltas"] > 0

    def test_jax_runtime_state_carried_into_port(self):
        nodes = [(f"n{i}", {"CPU": 4.0, "memory": 8.0}, None)
                 for i in range(6)]
        jview, tview = _view(jres, nodes), _view(tres, nodes)
        ref = jb.DeviceRuntimeSolver()
        assert ref.solve(jview, [JSpec(1.0, 77) for _ in range(5)])
        st = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in ref._state.items()}
        moved = convert.runtime_state_from_numpy(
            st, ref._demand_host, ref._accel_host, "cpu")
        port = _solver()
        port._state = moved["state"]
        port._demand_dev, port._accel_dev = moved["demand"], moved["accel"]
        port._zero_cost_dev = moved["zero_cost"]
        port._demand_host = ref._demand_host.copy()
        port._accel_host = ref._accel_host.copy()
        port._class_rows = dict(ref._class_rows)
        port._class_reqs = [tres.ResourceRequest(r.to_dict())
                            for r in ref._class_reqs]
        tview.version = jview.version
        got = port.solve(tview, [TSpec(1.0, 77) for _ in range(7)])
        want = ref.solve(jview, [JSpec(1.0, 77) for _ in range(7)])
        assert got == want and port.stats["full_syncs"] == 0


class TestDeviceSolverCostTerms:
    def test_locality_provider_steers_targets(self):
        view = _view(tres, [(f"n{i}", {"CPU": 8.0}, None) for i in range(4)])
        solver = _solver(locality_provider=lambda specs: {"n2": 1 << 20})
        targets = solver.solve(view, [TSpec(1.0, 7001, args=["oid"])
                                      for _ in range(4)])
        assert targets == ["n2"] * 4
        assert solver.last_cost_active and solver.stats["cost_ticks"] == 1

    def test_no_cost_ships_nothing(self):
        view = _view(tres, [(f"n{i}", {"CPU": 8.0}, None) for i in range(4)])
        solver = _solver()
        targets = solver.solve(view, [TSpec(1.0, 7002) for _ in range(4)])
        assert targets is not None and all(t is not None for t in targets)
        assert not solver.last_cost_active
        assert solver.stats["cost_ticks"] == 0

    def test_throughput_labels_prefer_fast_nodes(self):
        lab = tb.NODE_THROUGHPUT_LABEL
        view = _view(tres, [("slow0", {"CPU": 8.0}, {lab: "1.0"}),
                            ("slow1", {"CPU": 8.0}, {lab: "1.0"}),
                            ("fast", {"CPU": 8.0}, {lab: "4.0"})])
        solver = _solver()
        targets = solver.solve(view, [TSpec(1.0, 7003) for _ in range(6)])
        assert targets == ["fast"] * 6
        assert solver.last_cost_active

    def test_homogeneous_rates_cost_inactive(self):
        lab = tb.NODE_THROUGHPUT_LABEL
        view = _view(tres, [("a", {"CPU": 8.0}, {lab: "2.0"}),
                            ("b", {"CPU": 8.0}, {lab: "2.0"})])
        solver = _solver()
        assert solver.solve(view, [TSpec(1.0, 7004) for _ in range(3)])
        assert not solver.last_cost_active


# -- hygiene -----------------------------------------------------------------

def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys, ray_tpu_torch\n"
        "import ray_tpu_torch.scheduler.convert\n"
        "import ray_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "assert not bad, bad\n"
        "from ray_tpu_torch.ops import _build\n"
        "assert not _build._loaded\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.BatchSolver()
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.DeviceRuntimeSolver()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.batch_state_from_numpy({}, None)
    assert tb.BatchSolver(device="cpu").device.type == "cpu"


def test_later_slices_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="sinkhorn"):
        tb.BatchSolver(mode="sinkhorn", device="cpu")
    with pytest.raises(NotImplementedError, match="bundles"):
        tb.BatchSolver(device="cpu").solve_bundles(None, None, None, "PACK")


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tick's kernel runs only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_stream_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(42)
    avail, total, demand, counts, an, ac = build_problem(
        rng, num_tasks=20_000, C=32, N=1000, R=8)
    stream = arrival_stream(rng, counts, 5, per_tick=3000)
    rho = rng.integers(2, 9, size=32) / 16.0
    outs = []
    for dev in (cuda_device, "cpu"):
        s = tb.BatchSolver(device=dev)
        s.prepare_device(avail, total, demand, accel_node=an,
                         accel_class=ac, spread_threshold=0.5)
        outs.append(s.solve_stream(stream, nnz_max=8192, rho=rho))
    _assert_stream_equal(*outs)
    assert outs[0]["ok"].all()


@pytest.mark.gpu
def test_runtime_solver_on_card_matches_cpu(cuda_device):
    nodes = [(f"n{i}", {"CPU": float(2 + i % 5), "memory": 16.0}, None)
             for i in range(200)]
    views = [_view(tres, nodes), _view(tres, nodes)]
    solvers = [tb.DeviceRuntimeSolver(device=cuda_device), _solver()]
    before = cf.class_fill.launches
    for _ in range(2):
        specs = [TSpec(1.0 + (i % 4) * 0.5, 900 + i % 4) for i in range(300)]
        got = [s.solve(v, specs) for s, v in zip(solvers, views)]
        assert got[0] == got[1]
        for v in views:
            for t, sp in zip(got[0], specs):
                if t is not None:
                    assert v.subtract(t, sp.resources)
    assert cf.class_fill.launches == before + 2
    assert solvers[0].stats["fallbacks"] == 0
