"""The port's class-fill kernel module against the JAX package's fill.

The same inputs, made with numpy from a seed, go through the JAX plain
scan (``_class_fill(use_pallas=False)``), the Pallas kernel in interpret
mode, and the port's ``class_fill`` on CPU tensors (its plain PyTorch
version).  Allocations must be bit-equal; availability agrees within
1e-4, the bound ``TestPallasClassFill`` uses (it is exact for these
integer inputs).  Tests marked ``gpu`` hold the CUDA kernel against the
plain version on the card and skip without one.
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
