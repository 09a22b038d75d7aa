"""The port's autoscaler demand solve
(``ray_tpu_torch.autoscaler.resource_demand_scheduler``) against the JAX
package's, on the CPU.

It mirrors ``TestAutoscalerKernel`` (``tests/test_unified_scheduler.py``)
on the port, and holds every function to the reference on the same
inputs: both run the same pack-mode solve, bit for bit, so the outputs
must be equal, not only "no worse".  Tests marked ``gpu`` run the solve
on the card and skip without one.
"""

import numpy as np
import pytest
import torch

from ray_tpu._private.config import get_config as jax_config
from ray_tpu.autoscaler import resource_demand_scheduler as jrds
from ray_tpu_torch._private.config import get_config as port_config
from ray_tpu_torch.autoscaler import resource_demand_scheduler as trds
from ray_tpu_torch.ops import class_fill as cf
from ray_tpu_torch.scheduler import torch_backend as tb

TYPES = {"small": {"resources": {"CPU": 4, "memory": 8}, "max_workers": 50},
         "big": {"resources": {"CPU": 32, "memory": 128}, "max_workers": 10}}


@pytest.fixture
def backend(monkeypatch):
    """Set ``autoscaler_kernel_backend`` in both packages."""
    def set_mode(mode):
        for cfg in (jax_config(), port_config()):
            monkeypatch.setattr(cfg, "autoscaler_kernel_backend", mode)
    return set_mode


def _nodes(rng, n):
    return [{"CPU": float(rng.integers(1, 9)),
             "memory": float(rng.integers(1, 17))} for _ in range(n)]


def _demands(rng, n):
    return [{"CPU": float(rng.choice([1, 2, 4])),
             "memory": float(rng.choice([1, 2, 8]))} for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_bin_pack_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        nodes = _nodes(rng, int(rng.integers(1, 10)))
        demands = [{"CPU": float(rng.integers(1, 5))}
                   for _ in range(int(rng.integers(1, 15)))]
        got = trds._kernel_bin_pack(nodes, list(demands), device="cpu")
        assert got == jrds._kernel_bin_pack(nodes, list(demands))
        # The reference's property: the pack-mode solve never fits fewer
        # demands than the numpy first-fit.
        unf_np, _ = trds.get_bin_pack_residual(nodes, list(demands),
                                               _use_kernel=False)
        assert len(got[0]) <= len(unf_np)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("mode", ["off", "auto", "force"])
def test_get_bin_pack_residual_matches_jax(seed, mode, backend):
    backend(mode)
    rng = np.random.default_rng(seed)
    for n_nodes, n_demands in ((3, 5), (16, 200), (40, 80)):
        nodes, demands = _nodes(rng, n_nodes), _demands(rng, n_demands)
        for strict in (False, True):
            before = dict(trds.kernel_stats)
            got = trds.get_bin_pack_residual(nodes, list(demands),
                                             strict_spread=strict,
                                             device="cpu")
            want = jrds.get_bin_pack_residual(nodes, list(demands),
                                              strict_spread=strict)
            assert got == want
            routed = (not strict and trds._kernel_enabled(n_nodes,
                                                          n_demands))
            assert trds.kernel_stats["kernel_solves"] - \
                before["kernel_solves"] == int(routed)
            assert trds.kernel_stats["numpy_solves"] - \
                before["numpy_solves"] == int(not routed)


@pytest.mark.parametrize("mode", ["off", "force"])
def test_get_nodes_for_matches_jax(mode, backend):
    backend(mode)
    rng = np.random.default_rng(5)
    for _ in range(10):
        demands = _demands(rng, int(rng.integers(1, 30)))
        for strict in (False, True):
            got = trds.get_nodes_for(TYPES, {}, 16, list(demands),
                                     strict_spread=strict, device="cpu")
            assert got == jrds.get_nodes_for(TYPES, {}, 16, list(demands),
                                             strict_spread=strict)


def test_kernel_get_nodes_for_never_over_launches():
    rng = np.random.default_rng(5)
    for _ in range(10):
        demands = _demands(rng, int(rng.integers(1, 30)))
        to_np, unf_np = trds.get_nodes_for(TYPES, {}, 16, list(demands),
                                           device="cpu")
        got = trds._kernel_get_nodes_for(TYPES, {}, 16, list(demands),
                                         device="cpu")
        assert got == jrds._kernel_get_nodes_for(TYPES, {}, 16,
                                                 list(demands))
        to_k, unf_k = got
        assert len(unf_k) <= len(unf_np)
        assert sum(to_k.values()) <= max(sum(to_np.values()), 1)


def test_kernel_enabled_thresholds(backend, monkeypatch):
    for cfg in (jax_config(), port_config()):
        monkeypatch.setattr(cfg, "autoscaler_kernel_min_cells", 100)
    backend("auto")
    cases = [(7, 1000), (8, 12), (8, 13), (100, 1), (1, 100)]
    assert [trds._kernel_enabled(*c) for c in cases] == \
        [jrds._kernel_enabled(*c) for c in cases] == \
        [False, False, True, True, False]
    backend("force")
    assert all(trds._kernel_enabled(*c) for c in cases)
    backend("off")
    assert not any(trds._kernel_enabled(*c) for c in cases)


def _launch_args():
    types = {"head": {"resources": {"CPU": 4}, "max_workers": 1},
             "worker": {"resources": {"CPU": 8, "memory": 32},
                        "min_workers": 1, "max_workers": 8},
             "tpu_worker": {"resources": {"CPU": 8, "TPU": 4},
                            "max_workers": 4}}
    demands = [{"CPU": 2}] * 10 + [{"TPU": 2}] * 3
    pgs = [{"strategy": "STRICT_SPREAD",
            "bundles": [{"CPU": 4}, {"CPU": 4}]},
           {"strategy": "STRICT_PACK", "bundles": [{"CPU": 1}, {"CPU": 2}]},
           {"strategy": "PACK", "bundles": [{"CPU": 1}]}]
    args = dict(node_type_counts={"head": 1}, launching_nodes={},
                resource_demands=[dict(d) for d in demands],
                unused_resources_by_node={"h": {"CPU": 4}},
                pending_placement_groups=pgs)
    return types, args


@pytest.mark.parametrize("mode", ["off", "auto", "force"])
def test_get_nodes_to_launch_matches_jax(mode, backend):
    """The full orchestration (``TestAutoscalerKernel``'s mix, plus a
    STRICT_PACK and a PACK group) under each backend setting."""
    backend(mode)
    types, args = _launch_args()
    sched = trds.ResourceDemandScheduler(types, max_workers=12,
                                         head_node_type="head",
                                         device="cpu")
    ref = jrds.ResourceDemandScheduler(types, max_workers=12,
                                       head_node_type="head")
    before = trds.kernel_stats["kernel_solves"]
    got = sched.get_nodes_to_launch(**args)
    assert got == ref.get_nodes_to_launch(**args)
    solves = trds.kernel_stats["kernel_solves"] - before
    assert (solves > 0) == (mode == "force")
    # TPU demand must still force TPU workers.
    assert got[0].get("tpu_worker", 0) >= 1


def test_min_workers_and_launching_nodes_match_jax(backend):
    backend("force")
    types = {"cpu": {"resources": {"CPU": 8}, "min_workers": 3,
                     "max_workers": 10},
             "gpu": {"resources": {"CPU": 8, "GPU": 2}, "min_workers": 1,
                     "max_workers": 2}}
    args = dict(node_type_counts={"cpu": 1}, launching_nodes={"gpu": 1},
                resource_demands=[{"CPU": 4}] * 9 + [{"GPU": 1}] * 5,
                unused_resources_by_node={"a": {"CPU": 2}},
                ensure_min_cluster_size=[{"CPU": 8}] * 6)
    got = trds.ResourceDemandScheduler(
        types, max_workers=20, device="cpu").get_nodes_to_launch(**args)
    want = jrds.ResourceDemandScheduler(
        types, max_workers=20).get_nodes_to_launch(**args)
    assert got == want and got[0]["cpu"] >= 2


def test_placement_groups_to_resource_demands_matches_jax():
    pgs = [{"strategy": "PACK", "bundles": [{"CPU": 1}, {"GPU": 1}]},
           {"strategy": "SPREAD", "bundles": [{"CPU": 2}, {}]},
           {"strategy": "STRICT_PACK",
            "bundles": [{"CPU": 1, "memory": 2}, {"CPU": 3}]},
           {"strategy": "STRICT_SPREAD", "bundles": [{"CPU": 4}] * 3},
           {"bundles": [{"TPU": 4}]}]
    got = trds.placement_groups_to_resource_demands(pgs)
    assert got == jrds.placement_groups_to_resource_demands(pgs)
    assert got[0][3] == {"CPU": 4, "memory": 2}


def test_pack_with_jax_kernel_matches_jax():
    rng = np.random.default_rng(6)
    nodes, demands = _nodes(rng, 30), _demands(rng, 60)
    unf, alloc = trds.pack_with_jax_kernel(nodes, demands, device="cpu")
    want_unf, want_alloc = jrds.pack_with_jax_kernel(nodes, demands)
    assert unf == want_unf
    np.testing.assert_array_equal(alloc, want_alloc)


def test_kernel_failure_is_counted_and_raised(backend, monkeypatch):
    """A failing device solve raises (the reference answers with numpy
    instead) and is counted; no numpy solve stands in for it."""
    backend("force")

    def broken(self, *a, **kw):
        raise RuntimeError("class_fill launch failed")
    monkeypatch.setattr(tb.BatchSolver, "solve_matrices", broken)
    rng = np.random.default_rng(7)
    nodes, demands = _nodes(rng, 10), _demands(rng, 20)
    before = dict(trds.kernel_stats)
    with pytest.raises(RuntimeError, match="class_fill"):
        trds.get_bin_pack_residual(nodes, demands, device="cpu")
    with pytest.raises(RuntimeError, match="class_fill"):
        trds.get_nodes_for(TYPES, {}, 16, demands, device="cpu")
    assert trds.kernel_stats["numpy_solves"] == before["numpy_solves"]
    types, args = _launch_args()
    with pytest.raises(RuntimeError, match="class_fill"):
        trds.ResourceDemandScheduler(
            types, max_workers=12, device="cpu").get_nodes_to_launch(**args)
    assert trds.kernel_stats["kernel_errors"] - before["kernel_errors"] == 3
    assert trds.kernel_stats["kernel_solves"] == before["kernel_solves"]


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    backend("force")
    with pytest.raises(RuntimeError, match="CUDA"):
        trds.ResourceDemandScheduler(TYPES, max_workers=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        trds.get_bin_pack_residual([{"CPU": 1}], [{"CPU": 1}])
    # The numpy path below the thresholds runs no device solve.
    backend("off")
    assert trds.get_bin_pack_residual([{"CPU": 1}], [{"CPU": 1}]) == \
        ([], [{"CPU": 0.0}])


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pack-mode solve's kernel runs "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_autoscaler_on_card_matches_cpu(cuda_device, backend):
    """R2 at a small size: every output of the card equals the CPU's."""
    backend("force")
    rng = np.random.default_rng(8)
    nodes, demands = _nodes(rng, 500), _demands(rng, 2000)
    launches = cf.class_fill.launches
    got = trds.get_bin_pack_residual(nodes, demands, device=cuda_device)
    assert cf.class_fill.launches == launches + 1
    assert got == trds.get_bin_pack_residual(nodes, demands, device="cpu")
    types, args = _launch_args()
    outs = [trds.ResourceDemandScheduler(
        types, max_workers=12, device=dev).get_nodes_to_launch(**args)
        for dev in (cuda_device, "cpu")]
    assert outs[0] == outs[1]
