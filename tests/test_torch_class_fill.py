"""The port's class-fill kernel module against the JAX package's fill.

The same inputs, made with numpy from a seed, go through the JAX plain
scan (``_class_fill(use_pallas=False)``), the Pallas kernel in interpret
mode, and the port's ``class_fill`` on CPU tensors (its plain PyTorch
version).  Allocations must be bit-equal; availability agrees within
1e-4, the bound ``TestPallasClassFill`` uses (it is exact for these
integer inputs).  Tests marked ``gpu`` hold the CUDA kernel against the
plain version on the card and skip without one.

``_fill_by_blocks`` is the CUDA kernel's way to the fill prefix in plain
PyTorch: eight blocks that own fixed eighths of the node ids, warps of
32-node rounds inside them, a (segment, bucket) key per node with the
segment split at the class's shift, and the rotated prefix assembled
from block and warp totals by sums alone.  It must be bit-equal to
``class_fill_reference`` at every shift, including 0, the block
boundaries and N_pad - 1, and at an N_pad that is not a multiple of 8.
"""

import numpy as np
import pytest
import torch

from ray_tpu.scheduler import jax_backend as jb
from ray_tpu_torch.ops import class_fill as cf


def _problem(seed, C=16, N=100, R=5, with_cost=False, c_pad=16, r_pad=8):
    rng = np.random.default_rng(seed)
    n_pad = jb._round_up(max(N, 8), jb._GROUP)
    avail = np.floor(rng.uniform(0, 8, (N, R))).astype(np.float32)
    total = avail + np.floor(rng.uniform(0, 4, (N, R))).astype(np.float32)
    demand = np.floor(rng.uniform(0, 2.2, (C, R))).astype(np.float32)
    counts = rng.integers(0, 50, C).astype(np.float32)
    accel_node = rng.random(N) < 0.2
    accel_class = rng.random(C) < 0.3
    if with_cost:
        cost = np.where(rng.random((c_pad, n_pad)) < 0.1,
                        rng.uniform(-0.6, 0.4, (c_pad, n_pad)), 0.0)
    else:
        cost = np.zeros((c_pad, n_pad))
    return {
        "av_t": jb._pad_to(avail, (n_pad, r_pad)).T.copy(),
        "total_t": jb._pad_to(total, (n_pad, r_pad)).T.copy(),
        "demand": jb._pad_to(demand, (c_pad, r_pad)),
        "counts": jb._pad_to(counts, (c_pad,)),
        "accel_class": jb._pad_to(accel_class, (c_pad,)),
        "accel_node": jb._pad_to(accel_node, (n_pad,)),
        "cost": cost.astype(np.float32),
        "shifts": np.asarray((np.arange(c_pad) * 977) % n_pad, np.int32),
        "dims": (c_pad, n_pad, r_pad),
    }


_ORDER = ("av_t", "total_t", "demand", "counts", "accel_class",
          "accel_node")


def _torch_args(p, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(p[k])).to(device)
            for k in _ORDER]


def _port_fill(p, thr, invert, device="cpu", fn=None):
    fn = fn or cf.class_fill
    args = _torch_args(p, device)
    cost = torch.from_numpy(p["cost"]).to(device)
    shifts = torch.from_numpy(p["shifts"]).to(device)
    return fn(*args, thr, cost, invert, shifts)


def _jax_fills(p, thr, invert):
    import jax.numpy as jnp
    c_pad, n_pad, r_pad = p["dims"]
    args = [jnp.asarray(p[k]) for k in _ORDER]
    cost, shifts = jnp.asarray(p["cost"]), jnp.asarray(p["shifts"])
    inv = jnp.float32(invert)
    plain = jb._class_fill(*args, np.float32(thr), c_pad=c_pad, n_pad=n_pad,
                           r_pad=r_pad, use_pallas=False, cost=cost,
                           invert=inv, shifts=shifts)
    fill = jb._pallas_class_fill(c_pad, n_pad, r_pad, interpret=True)
    pallas = fill(*args, np.float32(thr), cost, inv, shifts)
    return plain, pallas


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_cost", [False, True])
@pytest.mark.parametrize("invert", [0.0, 1.0])
def test_plain_fill_matches_jax_scan_and_pallas(seed, with_cost, invert):
    p = _problem(seed, with_cost=with_cost)
    thr = 0.5 if seed != 2 else 0.3   # 0.3 is not dyadic: float32 scale
    av, alloc = _port_fill(p, thr, invert)
    (av_j, alloc_j), (av_p, alloc_p) = _jax_fills(p, thr, invert)
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(alloc_j))
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(alloc_p))
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), atol=1e-4)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_p), atol=1e-4)


@pytest.mark.parametrize("zero_shifts", [False, True])
def test_plain_fill_matches_jax_at_two_node_groups(zero_shifts):
    """N_pad = 256 (two 128-node groups in the JAX blocked prefix), a
    rotation that wraps, and R = 3."""
    p = _problem(7, C=24, N=200, R=3, with_cost=True, c_pad=24)
    if zero_shifts:
        p["shifts"] = np.zeros_like(p["shifts"])
    av, alloc = _port_fill(p, 0.5, 0.0)
    (av_j, alloc_j), _ = _jax_fills(p, 0.5, 0.0)
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(alloc_j))
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), atol=1e-4)


def _sparse_demand(demand, R, per_class=3, seed=9):
    """``demand`` with ``per_class`` of its first ``R`` columns kept a
    class (the rest 0), as a task names a few of a wide view's columns."""
    rng = np.random.default_rng(seed)
    keep = np.zeros(demand.shape, bool)
    for c in range(demand.shape[0]):
        keep[c, rng.choice(R, per_class, replace=False)] = True
    return np.where(keep, demand, 0).astype(demand.dtype)


@pytest.mark.parametrize("R,r_pad", [(70, 72), (130, 136)])
def test_plain_fill_matches_jax_at_wide_resource_pads(R, r_pad):
    """A view that placement-group bundles have widened past 64 columns
    (each group of four bundles adds ten): the plain version takes any
    R_pad, as the JAX package's scan and Pallas kernel do.  Availability
    is exact here (integers)."""
    p = _problem(4, C=16, N=100, R=R, with_cost=True, r_pad=r_pad)
    p["demand"] = _sparse_demand(p["demand"], R)
    av, alloc = _port_fill(p, 0.5, 0.0)
    (av_j, alloc_j), (av_p, alloc_p) = _jax_fills(p, 0.5, 0.0)
    assert alloc.sum() > 0
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(alloc_j))
    np.testing.assert_array_equal(alloc.numpy(), np.asarray(alloc_p))
    np.testing.assert_array_equal(av.numpy(), np.asarray(av_j))


@pytest.mark.parametrize("n_pad,r_pad,route", [
    (128, 8, "shared"), (128, 240, "shared"), (10_112, 16, "shared"),
    (10_112, 24, "global"), (10_112, 136, "global"), (128, 2048, "global"),
    (32_768, 8, "global")])
def test_kernel_route_by_shape(n_pad, r_pad, route):
    """The rows stay in shared memory while a block's share fits, and
    go to the global route past it; only the node limit raises."""
    assert cf.kernel_route(n_pad, r_pad) == route
    with pytest.raises(ValueError, match="at most 4096 nodes"):
        cf.kernel_route(32_769, r_pad)


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    from ray_tpu_torch.ops import _build

    def no_build(source):
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = cf.class_fill.launches
    _port_fill(_problem(0), 0.5, 0.0)
    assert cf.class_fill.launches == before


@pytest.mark.parametrize("field,bad", [
    ("counts", lambda t: t.to(torch.float64)),
    ("accel_node", lambda t: t.to(torch.float32)),
    ("demand", lambda t: t[:, :4]),
    ("total_t", lambda t: t.t().contiguous().t()),
])
def test_wrapper_rejects_bad_inputs(field, bad):
    p = _problem(0)
    args = dict(zip(_ORDER, _torch_args(p)))
    args[field] = bad(args[field])
    with pytest.raises((TypeError, ValueError)):
        cf.class_fill(*[args[k] for k in _ORDER], 0.5,
                      torch.from_numpy(p["cost"]), 0.0,
                      torch.from_numpy(p["shifts"]))


def _raw_problem(seed, C=16, n_pad=203, R=5, r_pad=8, shifts=None,
                 sparse=False):
    """class_fill's arguments at any N_pad (no padding of the node axis),
    with the kernel's edge cases: empty nodes, accelerator nodes and
    classes, a class that demands nothing (class 1), a cost term, and
    the given shifts (default: 0, block boundaries, N_pad - 1, inside a
    block, then random).  ``sparse``: each class demands 3 columns."""
    rng = np.random.default_rng(seed)
    avail = np.floor(rng.uniform(0, 8, (n_pad, R)))
    total = avail + np.floor(rng.uniform(0, 4, (n_pad, R)))
    empty = rng.random(n_pad) < 0.05
    avail[empty] = 0.0
    total[empty] = 0.0
    demand = np.floor(rng.uniform(0, 2.2, (C, R)))
    if sparse:
        demand = _sparse_demand(demand, R, seed=seed)
    demand[1] = 0.0
    counts = rng.integers(0, 60, C).astype(np.float64)
    counts[1] = 25.0
    cost = np.where(rng.random((C, n_pad)) < 0.1,
                    rng.uniform(-0.6, 0.4, (C, n_pad)), 0.0)
    if shifts is None:
        bounds = [k * n_pad // 8 for k in range(8)]
        fixed = [0, bounds[1], bounds[4], bounds[7], n_pad - 1,
                 bounds[3] + 5, bounds[6] - 1]
        shifts = fixed + list(rng.integers(0, n_pad, C - len(fixed)))
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    pad_r = lambda x: np.pad(x, ((0, 0), (0, r_pad - R)))
    return [f32(pad_r(avail).T), f32(pad_r(total).T), f32(pad_r(demand)),
            f32(counts), torch.from_numpy(rng.random(C) < 0.3),
            torch.from_numpy(rng.random(n_pad) < 0.2), 0.5, f32(cost), 0.0,
            torch.tensor(np.asarray(shifts) % n_pad, dtype=torch.int32)]


def _fill_by_blocks(av_t, total_t, demand, counts, accel_class, accel_node,
                    thr, cost, invert, shifts, threads=1024):
    """The kernel's prefix in plain PyTorch (see the module docstring);
    ``threads`` per block sets its warps and their rounds."""
    r_pad, n_pad = av_t.shape
    nb = cf._NUM_BUCKETS
    thr_t, inv_t = torch.tensor(thr), torch.tensor(invert)
    empty = total_t.amax(dim=0) <= 0
    bounds = [k * n_pad // 8 for k in range(9)]
    warps = threads // 32
    per_warp = 32 * (-(-(-(-n_pad // 8)) // threads))   # 32 x rounds
    zero = torch.zeros(1, 2 * nb)
    av, rows = av_t, []
    for c in range(demand.shape[0]):
        cap, bucket = cf._cap_and_bucket(
            av, total_t, demand[c], counts[c], accel_class[c], cost[c],
            inv_t, accel_node, empty, thr_t)
        shift = int(shifts[c]) % n_pad
        key = (torch.arange(n_pad) >= shift).long() * nb + bucket
        cap_k = torch.zeros(n_pad, 2 * nb).scatter_(1, key[:, None],
                                                    cap[:, None])
        within = torch.zeros(n_pad)     # prefix inside the warp
        warp_off = torch.zeros(n_pad)   # the warp's offset in the block
        block_tot = torch.zeros(8, 2 * nb)
        for k in range(8):
            w_tot = torch.zeros(warps, 2 * nb)
            for w in range(warps):
                a = bounds[k] + w * per_warp
                b = min(a + per_warp, bounds[k + 1])
                if a < b:
                    incl = torch.cumsum(cap_k[a:b], dim=0)
                    ex = torch.cat([zero, incl[:-1]])
                    within[a:b] = ex.gather(1, key[a:b, None])[:, 0]
                    w_tot[w] = incl[-1]
            w_off = torch.cat([zero, torch.cumsum(w_tot, dim=0)[:-1]])
            for w in range(warps):
                a = bounds[k] + w * per_warp
                b = min(a + per_warp, bounds[k + 1])
                if a < b:
                    warp_off[a:b] = w_off[w].gather(0, key[a:b])
            block_tot[k] = w_tot.sum(dim=0)
        tot0, tot1 = block_tot[:, :nb].sum(dim=0), block_tot[:, nb:].sum(
            dim=0)
        base = torch.cat([torch.zeros(1), torch.cumsum(tot0 + tot1,
                                                       dim=0)[:-1]])
        pre = torch.cat([zero, torch.cumsum(block_tot, dim=0)[:-1]])
        goff = torch.cat([base + tot1 + pre[:, :nb], base + pre[:, nb:]],
                         dim=1)   # [block, key]
        block_of = torch.bucketize(torch.arange(n_pad),
                                   torch.tensor(bounds[1:8]), right=True)
        prefix = goff[block_of, key] + warp_off + within
        take = torch.minimum(torch.clamp_min(counts[c] - prefix, 0.0), cap)
        av = av - take[None, :] * demand[c][:, None]
        rows.append(take)
    return av, torch.stack(rows)


@pytest.mark.parametrize("n_pad,threads", [(128, 1024), (203, 1024),
                                           (1003, 64), (2048, 128)])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_prefix_emulation_is_bit_equal_to_plain_version(
        n_pad, threads, seed):
    args = _raw_problem(seed, n_pad=n_pad)
    av_e, al_e = _fill_by_blocks(*args, threads=threads)
    av_r, al_r = cf.class_fill_reference(*args)
    assert al_r.sum() > 0
    assert torch.equal(al_e, al_r)
    assert torch.equal(av_e, av_r)


def test_block_prefix_emulation_at_every_shift():
    """All shifts of a small N_pad that is not a multiple of 8."""
    n_pad = 37
    args = _raw_problem(3, C=n_pad, n_pad=n_pad, shifts=range(n_pad))
    av_e, al_e = _fill_by_blocks(*args)
    av_r, al_r = cf.class_fill_reference(*args)
    assert torch.equal(al_e, al_r)
    assert torch.equal(av_e, av_r)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the class-fill kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_cost", [False, True])
@pytest.mark.parametrize("invert", [0.0, 1.0])
def test_kernel_matches_plain_version_on_card(cuda_device, seed, with_cost,
                                              invert):
    p = _problem(seed, C=40, N=300, R=5, with_cost=with_cost, c_pad=40)
    before = cf.class_fill.launches
    av_k, alloc_k = _port_fill(p, 0.3, invert, device=cuda_device)
    torch.cuda.synchronize()
    assert cf.class_fill.launches == before + 1
    av_r, alloc_r = _port_fill(p, 0.3, invert, device=cuda_device,
                               fn=cf.class_fill_reference)
    assert torch.equal(alloc_k, alloc_r)
    assert (av_k - av_r).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad", [203, 1003, 10_112])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_edge_cases_on_card(cuda_device, n_pad, seed):
    """Shifts at 0, at block boundaries, at N_pad - 1 and inside a block;
    a class that demands nothing; accelerator classes and nodes; empty
    nodes; N_pad not a multiple of 8."""
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in _raw_problem(seed, C=24, n_pad=n_pad)]
    before = cf.class_fill.launches
    av_k, alloc_k = cf.class_fill(*args)
    torch.cuda.synchronize()
    assert cf.class_fill.launches == before + 1
    av_r, alloc_r = cf.class_fill_reference(*args)
    assert torch.equal(alloc_k, alloc_r)
    assert torch.equal(av_k, av_r)


@pytest.mark.gpu
@pytest.mark.parametrize("R,r_pad", [(3, 3), (5, 16)])
def test_kernel_at_other_resource_pads_on_card(cuda_device, R, r_pad):
    """An R_pad other than 8 takes the kernel's instance for any R_pad."""
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in _raw_problem(2, C=24, n_pad=1003, R=R, r_pad=r_pad)]
    av_k, alloc_k = cf.class_fill(*args)
    torch.cuda.synchronize()
    av_r, alloc_r = cf.class_fill_reference(*args)
    assert alloc_r.sum() > 0
    assert torch.equal(alloc_k, alloc_r)
    assert torch.equal(av_k, av_r)


@pytest.mark.gpu
@pytest.mark.parametrize("R,r_pad,n_pad", [
    (70, 72, 203), (130, 136, 1003), (230, 240, 128), (20, 24, 10_112),
    (70, 72, 10_112), (130, 136, 10_112)])
def test_kernel_at_wide_resource_pads_on_card(cuda_device, R, r_pad, n_pad):
    """Past 64 resource rows, on the shared route while a block's rows
    fit and on the global route past the shared-memory budget (N_pad
    10,112 from R_pad 24): bit-equal to the plain version."""
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in _raw_problem(5, C=24, n_pad=n_pad, R=R, r_pad=r_pad,
                                  sparse=True)]
    before = cf.class_fill.launches
    av_k, alloc_k = cf.class_fill(*args)
    torch.cuda.synchronize()
    assert cf.class_fill.launches == before + 1
    av_r, alloc_r = cf.class_fill_reference(*args)
    assert alloc_r[2:].sum() > 0   # class 1 demands nothing
    assert torch.equal(alloc_k, alloc_r)
    assert torch.equal(av_k, av_r)


@pytest.mark.gpu
def test_kernel_raises_past_its_shared_memory(cuda_device):
    """Rows past the shared memory take the global route; what still
    raises is a block's share of nodes past its 4 rounds of 1024
    threads."""
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in _raw_problem(0, C=2, n_pad=64 * 1024, R=8, r_pad=8,
                                  shifts=[0, 1])]
    with pytest.raises(ValueError, match="at most 4096 nodes"):
        cf.class_fill(*args)
