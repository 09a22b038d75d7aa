"""The per-class water-fill: the hand-written Hopper kernel and its plain
PyTorch version.

``class_fill`` replaces the TPU kernel ``_pallas_class_fill``
(``ray_tpu/scheduler/jax_backend.py:252``, ``pallas_call`` at ``:374``):
the whole scan over scheduling classes in one launch, with the
availability matrix carried from class to class.  Its CUDA source is
``ray_tpu_torch/csrc/class_fill.cu``.

What bounds it on an H100: at the bench shape (C_pad=256, N_pad=10,112,
R_pad=8) one call must read ``cost`` (10.35 MB), ``av`` and ``total``
(0.32 MB each) and write ``allocs`` (10.35 MB) and ``av_out`` (0.32 MB):
about 21.7 MB, or about 6.5 us at 3.35 TB/s.  Its operations (under a
hundred flops per node and class, some 0.2 GFLOP) are far below the
card's float32 rate.  But class c+1 cannot start before class c has
updated the availability, so the work is a chain of C dependent steps,
each a scan over the whole node axis: its time is that chain's latency,
not the memory bound.  The kernel spreads each step over one
thread-block cluster of 8 SMs that own fixed eighths of the nodes, keep
their availability in shared memory for the whole call, and exchange
per-bucket totals through distributed shared memory behind one cluster
barrier per class; the rotation of the fill order is analytic (the
source note has the design).  It takes R_pad <= 64 and
R_pad * ceil(N_pad / 8) up to the shared memory it has (R_pad = 8: N_pad
up to about 26,000), and raises beyond.

``class_fill_reference`` is the plain loop of ``_bucket_fill_step``
over classes.  ``class_fill`` takes it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

_BIG = 1e9
_UTIL_LEVELS = 16
# 16 cost pre-buckets + [flat below-threshold, 16 utilization levels,
# accelerator-avoid, empty] = 35 buckets.
_COST_BUCKETS = 16
_NUM_BUCKETS = _COST_BUCKETS + _UTIL_LEVELS + 3
_EPS = 1e-6


def _cap_and_bucket(av, total, d, cnt, is_accel, cost_row, invert,
                    accel_node, empty, thr):
    """One class's capacity [N] (float32 integers) and fill bucket [N]
    (int64) of every node against the running availability.

    ``av``/``total`` are [R, N]; ``d`` [R]; ``cnt``, ``thr`` and
    ``invert`` are 0-d float32 tensors (``scale`` must be computed in
    float32, as the JAX package computes it)."""
    demanded = d > 0
    any_demand = demanded.any()
    ratios = torch.where(demanded[:, None],
                         av / torch.clamp_min(d[:, None], _EPS), _BIG)
    cap = torch.floor(ratios.amin(dim=0) + _EPS)
    cap = torch.minimum(torch.clamp_min(cap, 0.0), cnt)
    util = torch.where(total > 0,
                       (total - av) / torch.clamp_min(total, _EPS), 0.0)
    score_d = torch.where(demanded[:, None], util, -_BIG).amax(dim=0)
    score_o = util.amax(dim=0)
    score = torch.where(any_demand, score_d, score_o)
    score = torch.where(invert > 0, 1.0 - score, score)
    scale = _UTIL_LEVELS / torch.clamp_min(1.0 - thr, _EPS)
    lvl = torch.clamp(torch.floor((score - thr) * scale) + 1.0,
                      1.0, float(_UTIL_LEVELS))
    b_util = torch.where(score < thr, 0.0, lvl)
    cost_b = torch.floor(cost_row * scale + 0.5)
    bucket = torch.clamp(b_util + float(_COST_BUCKETS) + cost_b,
                         0.0, float(_COST_BUCKETS + _UTIL_LEVELS))
    bucket = torch.where(accel_node & ~is_accel,
                         float(_COST_BUCKETS + _UTIL_LEVELS + 1), bucket)
    bucket = torch.where(empty, float(_NUM_BUCKETS - 1), bucket).long()
    return cap, bucket


def _bucket_fill_step(av, total, d, cnt, is_accel, shift, cost_row, invert,
                      accel_node, empty, thr):
    """One class's water-fill against the running availability (arguments
    as for ``_cap_and_bucket``).  Nodes fill in (bucket, node id rotated
    by ``shift``) order; the prefix is a cumulative sum over the rotated
    order, exact while the class's capacities sum below 2^24.
    Returns (new_av [R, N], take [N])."""
    n_pad = av.shape[1]
    dev = av.device
    cap, bucket = _cap_and_bucket(av, total, d, cnt, is_accel, cost_row,
                                  invert, accel_node, empty, thr)
    # Position j of the rotated order holds node (shift + j) % n_pad.
    pos = torch.arange(n_pad, device=dev)
    perm = (pos + shift) % n_pad
    cap_r, b_r = cap[perm], bucket[perm]
    onehot = b_r[None, :] == torch.arange(_NUM_BUCKETS, device=dev)[:, None]
    cap_oh = torch.where(onehot, cap_r[None, :], 0.0)      # [B, N]
    incl = torch.cumsum(cap_oh, dim=1)
    btotal = incl[:, -1]
    bprefix = torch.cumsum(btotal, dim=0) - btotal
    prefix_bn = bprefix[:, None] + (incl - cap_oh)
    prefix_r = prefix_bn.gather(0, b_r[None, :])[0]
    prefix = prefix_r[(pos - shift) % n_pad]                # natural order
    take = torch.minimum(torch.clamp_min(cnt - prefix, 0.0), cap)
    return av - take[None, :] * d[:, None], take


def class_fill_reference(av_t, total_t, demand, counts, accel_class,
                         accel_node, spread_threshold, cost, invert, shifts
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``_bucket_fill_step`` over
    the classes in order.  Returns (av_after [R, N], allocs [C, N])."""
    dev = av_t.device
    thr = torch.as_tensor(spread_threshold, dtype=torch.float32).to(dev)
    inv = torch.as_tensor(invert, dtype=torch.float32).to(dev)
    empty = total_t.amax(dim=0) <= 0
    av = av_t
    rows = []
    for c in range(demand.shape[0]):
        av, take = _bucket_fill_step(
            av, total_t, demand[c], counts[c], accel_class[c], shifts[c],
            cost[c], inv, accel_node, empty, thr)
        rows.append(take)
    return av, torch.stack(rows)


def _check(av_t, total_t, demand, counts, accel_class, accel_node, cost,
           shifts):
    r_pad, n_pad = av_t.shape
    c_pad = demand.shape[0]
    want = {
        "av_t": (av_t, torch.float32, (r_pad, n_pad)),
        "total_t": (total_t, torch.float32, (r_pad, n_pad)),
        "demand": (demand, torch.float32, (c_pad, r_pad)),
        "counts": (counts, torch.float32, (c_pad,)),
        "accel_class": (accel_class, torch.bool, (c_pad,)),
        "accel_node": (accel_node, torch.bool, (n_pad,)),
        "cost": (cost, torch.float32, (c_pad, n_pad)),
        "shifts": (shifts, torch.int32, (c_pad,)),
    }
    for name, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"class_fill: {name} must be a tensor")
        if t.device != av_t.device:
            raise ValueError(f"class_fill: {name} is on {t.device}, "
                             f"av_t on {av_t.device}")
        if t.dtype != dtype:
            raise TypeError(f"class_fill: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"class_fill: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"class_fill: {name} must be contiguous")
    if r_pad > 64:
        raise ValueError(f"class_fill: at most 64 resource rows, got {r_pad}")


# Shape limits of the CUDA kernel (csrc/class_fill.cu): nodes a block of
# the 8-block cluster owns, and the shared memory those nodes' rows take.
_CLUSTER = 8
_MAX_NODES_PER_BLOCK = 4 * 1024
_SMEM_BUDGET = 212 * 1024


def _kernel_fits(n_pad: int, r_pad: int) -> bool:
    nk = -(-n_pad // _CLUSTER)
    return (nk <= _MAX_NODES_PER_BLOCK and
            2 * r_pad * nk * 4 + (-(-nk // 16) * 16) <= _SMEM_BUDGET)


def _scalar(x, dev):
    """A 0-d float32 tensor on ``dev``, without a copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def _launch(av_t, total_t, demand, counts, accel_class, accel_node,
            spread_threshold, cost, invert, shifts):
    r_pad, n_pad = av_t.shape
    c_pad = demand.shape[0]
    if not _kernel_fits(n_pad, r_pad):
        raise ValueError(
            f"class_fill: the CUDA kernel keeps each eighth of the nodes' "
            f"availability and totals in one SM's shared memory; R_pad="
            f"{r_pad} x ceil(N_pad={n_pad} / 8) does not fit "
            f"({_SMEM_BUDGET} bytes, at most {_MAX_NODES_PER_BLOCK} nodes "
            "a block)")
    from ray_tpu_torch.ops import _build
    lib = _build.load("class_fill.cu")
    fn = lib.class_fill_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = av_t.device
    scalars = torch.stack([_scalar(spread_threshold, dev),
                           _scalar(invert, dev)])
    av_out = torch.empty_like(av_t)
    allocs = torch.empty((c_pad, n_pad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(av_t.data_ptr(), total_t.data_ptr(), demand.data_ptr(),
                 counts.data_ptr(), accel_class.data_ptr(),
                 accel_node.data_ptr(), shifts.data_ptr(), cost.data_ptr(),
                 scalars.data_ptr(), av_out.data_ptr(), allocs.data_ptr(),
                 c_pad, n_pad, r_pad, stream)
    if err != 0:
        raise RuntimeError(f"class_fill kernel launch failed: CUDA error "
                           f"{err}")
    with _launches_lock:    # raylets' loop threads launch concurrently
        class_fill.launches += 1
    return av_out, allocs


def class_fill(av_t, total_t, demand, counts, accel_class, accel_node,
               spread_threshold, cost, invert, shifts
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Water-fill every class against ``av_t`` (same signature and
    returns as the JAX package's fused ``fill``).

    ``av_t``/``total_t`` [R, N] float32, ``demand`` [C, R] float32,
    ``counts`` [C] float32, ``accel_class`` [C] / ``accel_node`` [N]
    bool, ``cost`` [C, N] float32, ``shifts`` [C] int32, all contiguous
    and on one device; ``spread_threshold`` and ``invert`` are floats or
    0-d float32 tensors.  Returns (av_after [R, N], allocs [C, N]).

    On a CUDA tensor this launches the Hopper kernel (and raises if it
    cannot, or if the shape is past its limits: R_pad <= 64 and each
    eighth of the nodes' rows within one SM's shared memory); on a CPU
    tensor it runs ``class_fill_reference``."""
    _check(av_t, total_t, demand, counts, accel_class, accel_node, cost,
           shifts)
    if av_t.device.type == "cpu":
        return class_fill_reference(av_t, total_t, demand, counts,
                                    accel_class, accel_node,
                                    spread_threshold, cost, invert, shifts)
    if av_t.device.type != "cuda":
        raise ValueError(f"class_fill: unsupported device {av_t.device}")
    return _launch(av_t, total_t, demand, counts, accel_class, accel_node,
                   spread_threshold, cost, invert, shifts)


# Launches of the CUDA kernel in this process (the CPU path never counts).
class_fill.launches = 0
_launches_lock = threading.Lock()
