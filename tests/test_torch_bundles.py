"""The solver's bundle and sinkhorn modes, and placement-group packing,
against the JAX package.

Inputs are made with numpy from seeds and go through both packages on
the CPU (``device="cpu"`` in the port).

  * ``BatchSolver.solve_bundles``: ``node_idx`` and ``ok`` bit-equal to
    JAX's over the four strategies, random problems and exclusions.  The
    score's sum over resources runs left to right, the order of XLA's
    CPU reduction, and every other step is one IEEE operation.
  * ``bundle_packing``: a mirror of ``TestBundleKernelParity``
    (``tests/test_unified_scheduler.py:192``) on the port, the port's
    assignments against the JAX package's ``pack_bundles``, and the
    device-error divergence (counted and raised, not turned into greedy).
  * ``mode="sinkhorn"``: a mirror of ``TestSinkhornKernel``
    (``tests/test_jax_scheduler.py:126``), and allocations against
    JAX's.  The port's plan differs from JAX's in the last bits: its
    exp is built from IEEE operations (``torch_backend._exp``) and its
    sums run in a fixed pairwise order, so that the card and the CPU
    agree bit for bit, where JAX uses XLA's exp and reduction orders.
    The allocations are integers from a rounding pass over the plan's
    order, and on every problem below they come out bit-equal; the
    properties (capacity, counts) are held as well.

Tests marked ``gpu`` run the same programs on the card and skip without
one.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.scheduler import bundle_packing as tbp
from ray_tpu_torch.scheduler import resources as tres
from ray_tpu_torch.scheduler import torch_backend as tb
from ray_tpu_torch.scheduler.bench import build_problem

try:  # the card's machine has no JAX; the tests marked gpu need none
    from ray_tpu.scheduler import bundle_packing as jbp
    from ray_tpu.scheduler import jax_backend as jb
    from ray_tpu.scheduler import resources as jres
except ImportError:
    jbp = jb = jres = None

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def _bundle_problem(rng):
    """Availability, totals, bundle demands (some resources 0, halves
    among them) and an exclusion mask over a random fleet."""
    N = int(rng.integers(2, 300))
    R = int(rng.integers(1, 6))
    B = int(rng.integers(1, 40))
    total = rng.integers(0, 32, (N, R)).astype(np.float32)
    avail = np.floor(total * rng.uniform(0.2, 1, (N, R))).astype(np.float32)
    demand = (rng.integers(0, 4, (B, R)) *
              rng.choice([0.5, 1.0], (B, R))).astype(np.float32)
    excluded = rng.random(N) < 0.1
    return avail, total, demand, excluded


def _view(resources, nodes):
    view = resources.ClusterResourceView()
    for name, total in nodes:
        view.add_node(name, resources.NodeResources(total))
    return view


@pytest.fixture
def config():
    """The port's config, restored after the test."""
    cfg = get_config()
    saved = (cfg.pg_kernel_backend, cfg.pg_kernel_min_nodes)
    yield cfg
    cfg.pg_kernel_backend, cfg.pg_kernel_min_nodes = saved


# -- solve_bundles -----------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_bundles_matches_jax(seed, strategy):
    rng = np.random.default_rng(seed)
    js, ts = jb.BatchSolver(), tb.BatchSolver(device="cpu")
    for _ in range(8):
        avail, total, demand, excluded = _bundle_problem(rng)
        for exc in (None, excluded):
            want = js.solve_bundles(avail, total, demand, strategy, exc)
            got = ts.solve_bundles(avail, total, demand, strategy, exc)
            assert got[0].dtype == np.int64 and got[1].dtype == bool
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_solve_bundles_semantics():
    avail = total = np.array([[4.0, 8.0], [8.0, 8.0], [2.0, 2.0]],
                             np.float32)
    ts = tb.BatchSolver(device="cpu")
    two = np.array([[1.0, 1.0], [1.0, 1.0]], np.float32)
    # Best fit: the node with the least leftover of what is demanded.
    idx, ok = ts.solve_bundles(avail, total, two[:1], "PACK")
    assert ok.all() and idx[0] == 2
    idx, ok = ts.solve_bundles(avail, total, two, "STRICT_SPREAD")
    assert ok.all() and idx[0] != idx[1]
    idx, ok = ts.solve_bundles(avail, total, two, "PACK")
    assert ok.all() and idx[0] == idx[1] == 2
    idx, ok = ts.solve_bundles(avail, total, two, "SPREAD")
    assert ok.all() and idx[0] != idx[1]
    # Excluded and infeasible nodes are never chosen.
    idx, ok = ts.solve_bundles(avail, total, two[:1], "PACK",
                               np.array([False, False, True]))
    assert ok.all() and idx[0] == 0
    _, ok = ts.solve_bundles(avail, total,
                             np.array([[16.0, 1.0]], np.float32), "PACK")
    assert not ok.any()


# -- placement-group packing (mirror of TestBundleKernelParity) --------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_feasibility_parity_all_strategies(seed):
    rng = np.random.default_rng(seed)
    for trial in range(12):
        n = int(rng.integers(2, 9))
        view = _view(tres, [(f"n{i}",
                             {"CPU": float(rng.integers(1, 8)),
                              "memory": float(rng.integers(1, 16))})
                            for i in range(n)])
        nb = int(rng.integers(1, 6))
        bundles = [tres.ResourceRequest(
            {"CPU": float(rng.integers(1, 4)),
             "memory": float(rng.integers(0, 4))}) for _ in range(nb)]
        for strategy in STRATEGIES:
            greedy = tbp._pack_bundles_greedy(view, bundles, strategy)
            kernel = tbp.pack_bundles_kernel(view, bundles, strategy,
                                             device="cpu")
            assert (greedy is None) == (kernel is None), (
                f"seed={seed} trial={trial} {strategy}: greedy={greedy} "
                f"kernel={kernel}")
            if kernel is not None:
                assert tbp.validate_assignment(view, bundles, kernel,
                                               strategy, set())


def test_exclude_nodes_respected():
    view = _view(tres, [("a", {"CPU": 4.0}), ("b", {"CPU": 4.0})])
    bundles = [tres.ResourceRequest({"CPU": 2.0})]
    got = tbp.pack_bundles_kernel(view, bundles, "PACK", exclude_nodes={"a"},
                                  device="cpu")
    assert got == ["b"]


def test_strict_spread_needs_distinct_nodes():
    view = _view(tres, [("a", {"CPU": 8.0}), ("b", {"CPU": 8.0})])
    two = [tres.ResourceRequest({"CPU": 1.0}) for _ in range(2)]
    got = tbp.pack_bundles_kernel(view, two, "STRICT_SPREAD", device="cpu")
    assert got is not None and len(set(got)) == 2
    three = [tres.ResourceRequest({"CPU": 1.0}) for _ in range(3)]
    assert tbp.pack_bundles_kernel(view, three, "STRICT_SPREAD",
                                   device="cpu") is None


def test_strict_pack_single_node():
    view = _view(tres, [("a", {"CPU": 2.0}), ("b", {"CPU": 8.0})])
    bundles = [tres.ResourceRequest({"CPU": 2.0}) for _ in range(3)]
    got = tbp.pack_bundles_kernel(view, bundles, "STRICT_PACK", device="cpu")
    assert got == ["b"] * 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_bundles_matches_the_reference(seed, config):
    """The port's routed ``pack_bundles`` (device solve forced) gives the
    JAX package's assignment, node for node."""
    from ray_tpu._private.config import get_config as jget_config
    jcfg = jget_config()
    saved = jcfg.pg_kernel_backend
    jcfg.pg_kernel_backend = config.pg_kernel_backend = "force"
    try:
        rng = np.random.default_rng(100 + seed)
        for _ in range(6):
            nodes = [(f"n{i:03d}", {"CPU": float(rng.integers(1, 16)),
                                    "memory": float(rng.integers(1, 32)),
                                    "GPU": float(rng.integers(0, 2))})
                     for i in range(int(rng.integers(8, 60)))]
            reqs = [{"CPU": float(rng.integers(1, 4)),
                     "memory": float(rng.choice([0.5, 1.0, 2.0]))}
                    for _ in range(int(rng.integers(1, 10)))]
            exclude = {nodes[0][0]}
            for strategy in STRATEGIES:
                want = jbp.pack_bundles(
                    _view(jres, nodes), [jres.ResourceRequest(r)
                                         for r in reqs], strategy, exclude)
                got = tbp.pack_bundles(
                    _view(tres, nodes), [tres.ResourceRequest(r)
                                         for r in reqs], strategy, exclude,
                    device="cpu")
                assert got == want, strategy
    finally:
        jcfg.pg_kernel_backend = saved


def test_routing_follows_the_config(config):
    view = _view(tres, [(f"n{i}", {"CPU": 4.0}) for i in range(4)])
    bundles = [tres.ResourceRequest({"CPU": 1.0})]
    config.pg_kernel_backend, config.pg_kernel_min_nodes = "auto", 32
    assert not tbp._kernel_enabled(4) and tbp._kernel_enabled(32)
    before = dict(tbp.kernel_stats)
    assert tbp.pack_bundles(view, bundles, "PACK") is not None  # greedy
    assert tbp.kernel_stats["greedy_placements"] == \
        before["greedy_placements"] + 1
    config.pg_kernel_backend = "force"
    assert tbp.pack_bundles(view, bundles, "PACK", device="cpu") is not None
    assert tbp.kernel_stats["kernel_placements"] == \
        before["kernel_placements"] + 1
    # A data miss (the device solve finds no fit) goes to the greedy
    # solve, which finds none either.
    big = [tres.ResourceRequest({"CPU": 8.0})]
    assert tbp.pack_bundles(view, big, "PACK", device="cpu") is None
    assert tbp.kernel_stats["kernel_misses"] == before["kernel_misses"] + 1
    config.pg_kernel_backend = "off"
    assert not tbp._kernel_enabled(10 ** 6)


def test_device_error_is_counted_and_raised(config, monkeypatch):
    """The reference turns any device failure into a greedy solve
    (``ray_tpu/scheduler/bundle_packing.py:84-90``); the port counts it
    and lets it surface."""
    def broken(self, *args, **kwargs):
        raise RuntimeError("device fault")
    monkeypatch.setattr(tb.BatchSolver, "solve_bundles", broken)
    config.pg_kernel_backend = "force"
    view = _view(tres, [(f"n{i}", {"CPU": 4.0}) for i in range(4)])
    before = dict(tbp.kernel_stats)
    with pytest.raises(RuntimeError, match="device fault"):
        tbp.pack_bundles(view, [tres.ResourceRequest({"CPU": 1.0})], "PACK",
                         device="cpu")
    assert tbp.kernel_stats["kernel_errors"] == before["kernel_errors"] + 1
    assert tbp.kernel_stats["greedy_placements"] == \
        before["greedy_placements"]


def test_pack_bundles_needs_a_card_unless_told_cpu(config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.pg_kernel_backend = "force"
    view = _view(tres, [("a", {"CPU": 4.0})])
    with pytest.raises(RuntimeError, match="CUDA"):
        tbp.pack_bundles(view, [tres.ResourceRequest({"CPU": 1.0})], "PACK")


def test_bundle_resource_names_are_the_reference_s():
    class PG:
        def hex(self):
            return "ab12"
    req = {"CPU": 2.0, "memory": 0.5}
    assert tbp.bundle_resource_names(PG(), 3, tres.ResourceRequest(req)) == \
        jbp.bundle_resource_names(PG(), 3, jres.ResourceRequest(req))
    for index in (-1, 0, 2):
        assert tbp.rewrite_resources_for_bundle(req, PG(), index) == \
            jbp.rewrite_resources_for_bundle(req, PG(), index)


# -- sinkhorn (mirror of TestSinkhornKernel) ---------------------------------

def _random_problem(rng, C=12, N=40, R=4):
    """``tests/test_jax_scheduler.py``'s random problem."""
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


def test_sinkhorn_capacity_respected_and_spreads():
    solver = tb.BatchSolver(mode="sinkhorn", device="cpu")
    N = 16
    avail = total = np.full((N, 2), 8.0, dtype=np.float32)
    demand = np.array([[1.0, 0.0]], dtype=np.float32)
    counts = np.array([64])
    alloc = solver.solve_matrices(avail, total, demand, counts)
    usage = alloc.T.astype(np.float64) @ demand.astype(np.float64)
    assert (usage <= avail + 1e-3).all()
    assert alloc.sum() == 64
    # Sinkhorn balances: several nodes share the load.
    assert (alloc[0] > 0).sum() >= 4


def test_sinkhorn_feasibility_random():
    rng = np.random.default_rng(7)
    solver = tb.BatchSolver(mode="sinkhorn", device="cpu")
    for _ in range(3):
        avail, total, demand, counts, an, ac = _random_problem(rng)
        alloc = solver.solve_matrices(avail, total, demand, counts, an, ac)
        usage = alloc.T.astype(np.float64) @ demand.astype(np.float64)
        assert (usage <= avail + 1e-3).all()
        assert (alloc.sum(axis=1) <= counts).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sinkhorn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    js = jb.BatchSolver(mode="sinkhorn")
    ts = tb.BatchSolver(mode="sinkhorn", device="cpu")
    for N in (40, 300):
        problem = _random_problem(rng, N=N)
        want = js.solve_matrices(*problem)
        got = ts.solve_matrices(*problem)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_sinkhorn_matches_jax_at_the_bench_shape():
    """256 classes x 10,000 nodes x 8 resources (``build_problem``,
    seed 42): the shape ``chip_smoke.py`` runs on the card."""
    problem = build_problem(np.random.default_rng(42))
    want = jb.BatchSolver(mode="sinkhorn").solve_matrices(*problem)
    got = tb.BatchSolver(mode="sinkhorn", device="cpu").solve_matrices(
        *problem)
    np.testing.assert_array_equal(got, want)
    avail, _, demand, counts = problem[:4]
    assert (got.T.astype(np.float64) @ demand <= avail + 1e-3).all()
    assert (got.sum(axis=1) <= counts).all() and got.sum() > 0


@pytest.mark.parametrize("kw", [
    {"cost": np.zeros((1, 4), np.float32)},
    {"invert_util": True},
    {"zero_shifts": True},
])
def test_sinkhorn_refuses_waterfill_only_options(kw):
    solver = tb.BatchSolver(mode="sinkhorn", device="cpu")
    avail = total = np.full((4, 2), 4.0, np.float32)
    with pytest.raises(ValueError, match="waterfill-only"):
        solver.solve_matrices(avail, total, np.ones((1, 2), np.float32),
                              np.array([2]), **kw)


def test_sinkhorn_iters_reach_the_program(monkeypatch):
    seen = []
    real = tb._sinkhorn

    def spy(*args):
        seen.append(args[-1])
        return real(*args)
    monkeypatch.setattr(tb, "_sinkhorn", spy)
    avail = total = np.full((4, 2), 4.0, np.float32)
    for iters in (8, 3):
        tb.BatchSolver(mode="sinkhorn", sinkhorn_iters=iters,
                       device="cpu").solve_matrices(
            avail, total, np.ones((1, 2), np.float32), np.array([2]))
    assert seen == [8, 3]


# -- the IEEE building blocks ------------------------------------------------

def test_exp_is_within_two_ulps_of_exp():
    z = -torch.from_numpy(np.concatenate([
        np.random.default_rng(0).uniform(0, 87, 100_000),
        np.linspace(0, 1, 1001), [0.0, 86.99, 87.0]]).astype(np.float32))
    got = tb._exp(z)
    want = torch.exp(z.double())
    ulp = torch.finfo(torch.float32).eps * want
    assert float(((got.double() - want).abs() / ulp).max()) <= 2.0
    assert float(tb._exp(torch.tensor([-87.5, -1e9]))[0]) == 0.0


def test_fixed_order_sums():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 100, (3, 1000, 5)).astype(np.float32))
    for dim in (0, 1, 2):
        assert torch.equal(tb._sum_tree(x, dim), x.sum(dim=dim))
    assert torch.equal(tb._sum_last(x), x.sum(dim=-1))
    one = torch.ones(1, 1)
    assert torch.equal(tb._sum_tree(one, 1), torch.ones(1))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solver's card route runs "
                    "only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_solve_bundles_on_card_matches_cpu(cuda_device):
    avail, total, demand, _, _, _ = build_problem(np.random.default_rng(3))
    rng = np.random.default_rng(4)
    bundles = np.zeros((64, demand.shape[1]), np.float32)
    bundles[:, 0] = rng.choice([1, 2, 4], 64)
    bundles[:, 1] = rng.choice([2, 4, 8], 64)
    excluded = rng.random(avail.shape[0]) < 0.05
    for strategy in STRATEGIES:
        # STRICT_PACK takes the caller's one composite row.
        rows = bundles[:1] if strategy == "STRICT_PACK" else bundles
        got = tb.BatchSolver(device=cuda_device).solve_bundles(
            avail, total, rows, strategy, excluded)
        want = tb.BatchSolver(device="cpu").solve_bundles(
            avail, total, rows, strategy, excluded)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].all()


@pytest.mark.gpu
def test_sinkhorn_on_card_matches_cpu(cuda_device):
    problem = build_problem(np.random.default_rng(42))
    got = tb.BatchSolver(mode="sinkhorn", device=cuda_device).solve_matrices(
        *problem)
    want = tb.BatchSolver(mode="sinkhorn", device="cpu").solve_matrices(
        *problem)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_ieee_blocks_on_card_match_cpu(cuda_device):
    z = -torch.from_numpy(np.random.default_rng(0).uniform(
        0, 100, 1_000_000).astype(np.float32))
    assert torch.equal(tb._exp(z.to(cuda_device)).cpu(), tb._exp(z))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (256, 10_112)).astype(np.float32))
    assert torch.equal(tb._sum_tree(x.to(cuda_device), 1).cpu(),
                       tb._sum_tree(x, 1))
