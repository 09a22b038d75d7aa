"""The batched scheduling tick in PyTorch, on the card.

The counterpart of ``ray_tpu/scheduler/jax_backend.py`` (waterfill path).
One tick is

    demand[C, R] x counts[C] x avail[N, R] -> alloc[C, N]

where C is the number of scheduling classes (pending tasks deduplicated
by resource shape) and N the number of nodes.  Each class is water-filled
against the availability the classes before it left, in (bucket,
rotated node id) order over 35 buckets:

    buckets 0-15   cost pre-buckets (a negative per-(class, node) cost
                   pulls a node ahead of the flat zone)
    bucket 16      below the spread threshold (hybrid policy truncation)
    buckets 17-32  critical-resource utilization quantized to 1/16
    bucket 33      accelerator nodes avoided by non-accelerator classes
    bucket 34      empty, dead or padded nodes

Within a bucket, class c starts at node ``(c * 977) % N_pad``.  The fill
of all classes is one launch of the Hopper kernel behind
``ray_tpu_torch.ops.class_fill`` (its plain PyTorch version on the CPU).

Two entry points:
  * ``BatchSolver.prepare_device`` + ``solve_stream`` — K closed-loop
    ticks on the device: pending queue, availability and inflight work
    stay resident; one upload, one device-to-host copy of the packed
    ``[K, 2*nnz_max+3]`` result, no synchronisation between ticks.
  * ``DeviceRuntimeSolver.solve`` — the raylet's per-tick dispatch path:
    world state resident between ticks, dirty rows written in place.

Every entry point takes ``device=``: the card unless the caller passes
``"cpu"``, and an error when no card is present.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.class_fill import (_BIG, _COST_BUCKETS,
                                          _NUM_BUCKETS, _UTIL_LEVELS,
                                          class_fill)
from ray_tpu_torch.scheduler.resources import accelerator_node_mask

_GROUP = 128  # node-axis padding unit
_ROT_STRIDE = 977  # per-class rotation stride (prime)

# Node labels feeding the heterogeneity cost term: a float throughput
# multiplier per node, with an optional accelerator-class override.
NODE_THROUGHPUT_LABEL = "ray_tpu.throughput"
NODE_ACCEL_THROUGHPUT_LABEL = "ray_tpu.accel_throughput"

_LATER_SLICE = ("is not ported to ray_tpu_torch yet; it belongs to the "
                "slice that ports the tick's other consumers (bundles, "
                "autoscaler, sinkhorn)")


def _label_rate(labels: Dict, key: str, default: float = 1.0) -> float:
    try:
        return max(float(labels.get(key, default)), 1e-3)
    except (TypeError, ValueError):
        return default


def _pad_to(x: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    pads = [(0, s - d) for s, d in zip(shape, x.shape)]
    return np.pad(x, pads)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _class_shifts(c_pad: int, n_pad: int, device) -> torch.Tensor:
    """Per-class within-bucket rotation offsets."""
    return (torch.arange(c_pad, dtype=torch.int32, device=device)
            * _ROT_STRIDE) % n_pad


def _check_fp32_matmul(device: torch.device) -> None:
    """The usage and release contractions must be exact float32: a TF32
    matmul rounds integer counts.  Refuse rather than flip the flag."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set; the scheduling "
            "tick needs full float32 matmuls to stay exact")


def _rn(allocs: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """einsum("cn,cr->rn") in full float32."""
    return demand.t().matmul(allocs)


# ---------------------------------------------------------------------------
# Device programs (plain functions on tensors).
# ---------------------------------------------------------------------------

def _class_fill(av_t, total_t, demand, counts, accel_class, accel_node,
                spread_threshold, cost=None, invert=None, shifts=None):
    """Water-fill all classes against ``av_t`` [R, N].  ``cost`` [C, N]
    (None = zeros), ``invert`` 0-d pack-mode flag, ``shifts`` [C]
    rotation offsets (None = the per-class stride).  Returns
    (av_after [R, N], allocs [C, N])."""
    c_pad, n_pad = demand.shape[0], av_t.shape[1]
    dev = av_t.device
    if cost is None:
        cost = torch.zeros((c_pad, n_pad), dtype=torch.float32, device=dev)
    if invert is None:
        invert = torch.zeros((), dtype=torch.float32, device=dev)
    if shifts is None:
        shifts = _class_shifts(c_pad, n_pad, dev)
    return class_fill(av_t, total_t, demand, counts, accel_class,
                      accel_node, spread_threshold, cost, invert, shifts)


def _pack_tick(allocs, counts_k, av_pre, demand, nnz_max: int):
    """On-device validation + fixed-size sparse encoding of one tick.

    Returns (packed [2*nnz_max+3], placed_c [C]).  The compaction keeps
    the first ``nnz_max`` nonzero flat positions in ascending order
    (what ``jnp.nonzero(size=nnz_max, fill_value=flat_n)`` gives) with a
    cumulative sum and a scatter into an ``nnz_max + 1`` buffer whose
    last slot takes the overflow — static sizes, no host synchronisation.
    """
    dev = allocs.device
    flat_n = allocs.shape[0] * allocs.shape[1]
    usage = _rn(allocs, demand)
    ok_cap = torch.all(usage <= av_pre + 1e-2)
    placed_c = allocs.sum(dim=1)                           # [C]
    ok_cnt = torch.all(placed_c <= counts_k + 0.5)
    placed = placed_c.sum()
    flat = allocs.reshape(flat_n)
    nz = flat > 0
    rank = torch.cumsum(nz, dim=0, dtype=torch.int64) - 1
    nnz = rank[-1] + 1
    slot = torch.where(nz & (rank < nnz_max), rank,
                       torch.full_like(rank, nnz_max))
    buf = torch.full((nnz_max + 1,), flat_n, dtype=torch.int64, device=dev)
    buf.scatter_(0, slot, torch.arange(flat_n, device=dev))
    pos = buf[:nnz_max]
    live = torch.arange(nnz_max, device=dev) < nnz
    posc = torch.clamp_max(pos, flat_n - 1)
    idx = torch.where(live, posc, flat_n)
    vals = torch.where(live, flat[posc], 0.0)
    ok = ok_cap & ok_cnt & (nnz <= nnz_max)
    packed = torch.cat([
        idx.to(torch.float32), vals,
        torch.stack([placed, ok.to(torch.float32), nnz.to(torch.float32)])])
    return packed, placed_c


def _waterfill(avail, total, demand, counts, accel_node, accel_class,
               spread_threshold, cost, invert, shifts):
    """One solve on [N, R] inputs; returns (allocs [C, N], avail [N, R])."""
    av_after, allocs = _class_fill(
        avail.t().contiguous(), total.t().contiguous(), demand, counts,
        accel_class, accel_node, spread_threshold, cost=cost, invert=invert,
        shifts=shifts)
    return allocs, av_after.t()


def _waterfill_stream(av0_t, total_t, demand, pending0, arrivals, rho,
                      accel_node, accel_class, spread_threshold, cost,
                      nnz_max: int):
    """K scheduler ticks closed-loop in state, as
    ``_jit_waterfill_stream``: pending [C], avail [R, N] and inflight
    [C, N] carry from tick to tick; a geometric completion process with
    per-class rate ``rho`` releases ``ceil(inflight * rho)`` tasks per
    (class, node) each tick.  Returns packed [K, 2*nnz_max+3] on the
    device; nothing here waits for the device."""
    c_pad, n_pad = cost.shape
    assert c_pad * n_pad < (1 << 24), "sparse idx must stay exact in f32"
    dev = av0_t.device
    K = arrivals.shape[0]
    out = torch.empty((K, 2 * nnz_max + 3), dtype=torch.float32, device=dev)
    shifts = _class_shifts(c_pad, n_pad, dev)
    invert = torch.zeros((), dtype=torch.float32, device=dev)
    pending, av = pending0, av0_t
    inflight = torch.zeros((c_pad, n_pad), dtype=torch.float32, device=dev)
    for k in range(K):
        # Completions first: release resources held by finished work.
        release = torch.minimum(torch.ceil(inflight * rho[:, None]),
                                inflight)
        av = torch.minimum(av + _rn(release, demand), total_t)
        inflight = inflight - release
        counts_k = pending + arrivals[k]
        av_after, allocs = _class_fill(
            av, total_t, demand, counts_k, accel_class, accel_node,
            spread_threshold, cost=cost, invert=invert, shifts=shifts)
        packed, placed_c = _pack_tick(allocs, counts_k, av, demand, nnz_max)
        out[k] = packed
        pending = torch.clamp_min(counts_k - placed_c, 0.0)
        inflight = inflight + allocs
        av = av_after
    return out


def _solve_tick(avail_t, total_t, demand, counts, accel_node, accel_class,
                spread_threshold, cost, nnz_max: int):
    """One runtime tick against resident [R, N] state; returns packed."""
    c_pad, n_pad = cost.shape
    assert c_pad * n_pad < (1 << 24), "sparse idx must stay exact in f32"
    _, allocs = _class_fill(avail_t, total_t, demand, counts, accel_class,
                            accel_node, spread_threshold, cost=cost)
    packed, _ = _pack_tick(allocs, counts, avail_t, demand, nnz_max)
    return packed


def _apply_rows(avail_t, idx, rows):
    """Write k dirty node rows into the resident [R, N] availability IN
    PLACE (the JAX package donated the buffer and got a new one back).
    Padding duplicates the last real entry, so duplicate indices carry
    equal values and the write order does not matter."""
    avail_t.index_copy_(1, idx, rows.t().contiguous())
    return avail_t


# ---------------------------------------------------------------------------
# numpy oracles (golden references for the tests).
# ---------------------------------------------------------------------------

def bucket_oracle(score: np.ndarray, accel_avoid: np.ndarray,
                  empty: np.ndarray, spread_threshold: float,
                  cost: Optional[np.ndarray] = None) -> np.ndarray:
    """Quantize scores into fill-priority buckets (same spec as device)."""
    thr = np.float32(spread_threshold)
    scale = np.float32(_UTIL_LEVELS) / max(np.float32(1.0) - thr,
                                           np.float32(1e-6))
    lvl = np.clip(np.floor((score - thr) * scale) + 1.0, 1.0, _UTIL_LEVELS)
    b_util = np.where(score < thr, np.float32(0.0), lvl)
    if cost is None:
        cost_b = np.float32(0.0)
    else:
        cost_b = np.floor(cost.astype(np.float32) * scale +
                          np.float32(0.5))
    bucket = np.clip(b_util + np.float32(_COST_BUCKETS) + cost_b,
                     0.0, _COST_BUCKETS + _UTIL_LEVELS)
    bucket = np.where(accel_avoid, _COST_BUCKETS + _UTIL_LEVELS + 1,
                      bucket)
    bucket = np.where(empty, _NUM_BUCKETS - 1, bucket)
    return bucket.astype(np.int32)


def waterfill_oracle(avail: np.ndarray, total: np.ndarray,
                     demand: np.ndarray, counts: np.ndarray,
                     accel_node: np.ndarray, accel_class: np.ndarray,
                     spread_threshold: float,
                     cost: Optional[np.ndarray] = None,
                     invert_util: bool = False,
                     zero_shifts: bool = False,
                     n_pad: Optional[int] = None) -> np.ndarray:
    """Pure-numpy reference of the bucketized waterfill, float32
    throughout so bucket boundaries match the device bit for bit."""
    avail = avail.astype(np.float32).copy()
    total = total.astype(np.float32)
    C, R = demand.shape
    N = avail.shape[0]
    if n_pad is None:
        n_pad = _round_up(max(N, 8), _GROUP)
    alloc = np.zeros((C, N), dtype=np.int64)
    eps = np.float32(1e-6)
    empty = total.max(axis=1) <= 0
    node_ids = np.arange(N)
    for c in range(C):
        d = demand[c].astype(np.float32)
        cnt = int(counts[c])
        if cnt == 0:
            continue
        demanded = d > 0
        if demanded.any():
            ratios = np.where(demanded[None, :],
                              avail / np.maximum(d[None, :], eps), _BIG)
            cap = np.floor(ratios.min(axis=1) + eps)
        else:
            cap = np.full(N, _BIG, dtype=np.float32)
        cap = np.clip(cap, 0, cnt).astype(np.int64)
        util = np.where(total > 0, (total - avail) / np.maximum(total, eps),
                        np.float32(0.0)).astype(np.float32)
        if demanded.any():
            score = np.where(demanded[None, :], util,
                             np.float32(-_BIG)).max(axis=1)
        else:
            score = util.max(axis=1)
        score = score.astype(np.float32)
        if invert_util:
            score = (np.float32(1.0) - score).astype(np.float32)
        accel_avoid = accel_node & (not accel_class[c])
        bucket = bucket_oracle(score, accel_avoid, empty, spread_threshold,
                               cost=None if cost is None else cost[c])
        shift = 0 if zero_shifts else (c * _ROT_STRIDE) % n_pad
        rot_key = (node_ids - shift) % n_pad
        order = np.lexsort((rot_key, bucket))
        remaining = cnt
        for n in order:
            if remaining <= 0:
                break
            take = min(remaining, int(cap[n]))
            if take > 0:
                alloc[c, n] = take
                avail[n] -= take * d
                remaining -= take
    return alloc


def stream_oracle(avail: np.ndarray, total: np.ndarray, demand: np.ndarray,
                  arrivals: np.ndarray, rho: np.ndarray,
                  accel_node: np.ndarray, accel_class: np.ndarray,
                  spread_threshold: float,
                  pending0: Optional[np.ndarray] = None,
                  cost: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Numpy replay of the closed-loop tick stream; each tick's dense
    alloc[C, N].  Exact when all quantities are dyadic rationals."""
    C, R = demand.shape
    N = avail.shape[0]
    avail = avail.astype(np.float32).copy()
    total = total.astype(np.float32)
    demand = demand.astype(np.float32)
    rho = np.broadcast_to(np.asarray(rho, dtype=np.float32), (C,))
    pending = (np.zeros(C, dtype=np.float32) if pending0 is None
               else pending0.astype(np.float32))
    inflight = np.zeros((C, N), dtype=np.float32)
    out = []
    for k in range(arrivals.shape[0]):
        release = np.minimum(np.ceil(inflight * rho[:, None]), inflight)
        avail = np.minimum(
            avail + np.einsum("cn,cr->nr", release, demand), total)
        inflight = inflight - release
        queue_k = pending + arrivals[k]
        alloc = waterfill_oracle(avail, total, demand, queue_k,
                                 accel_node, accel_class, spread_threshold,
                                 cost=cost)
        af = alloc.astype(np.float32)
        avail = avail - np.einsum("cn,cr->nr", af, demand)
        inflight = inflight + af
        pending = np.maximum(queue_k - af.sum(axis=1), 0.0)
        out.append(alloc)
    return out


# ---------------------------------------------------------------------------
# Host-side entry points.
# ---------------------------------------------------------------------------

def _f32(x: np.ndarray, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(_pad_to(x.astype(np.float32), shape))
    ).to(device)


def _bool(x: np.ndarray, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(_pad_to(x.astype(bool), shape))).to(device)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


class BatchSolver:
    """Groups pending specs by scheduling class, runs the device solve,
    expands the allocation back to per-task node targets."""

    def __init__(self, mode: Optional[str] = None, device=None):
        self.mode = mode or "waterfill"
        if self.mode != "waterfill":
            raise NotImplementedError(f"mode={self.mode!r} {_LATER_SLICE}")
        self.device = resolve_device(device)
        self._device_state = None  # set by prepare_device

    # -- raw matrix interface --------------------------------------------
    def solve_matrices(self, avail: np.ndarray, total: np.ndarray,
                       demand: np.ndarray, counts: np.ndarray,
                       accel_node: Optional[np.ndarray] = None,
                       accel_class: Optional[np.ndarray] = None,
                       spread_threshold: Optional[float] = None,
                       cost: Optional[np.ndarray] = None,
                       invert_util: bool = False,
                       zero_shifts: bool = False):
        """Returns alloc[C,N] int64 for one tick.

        ``cost`` [C, N] adds per-(class, node) score offsets (negative =
        preferred); ``invert_util`` + ``zero_shifts`` select pack mode
        (most-utilized-first, first-fit within a bucket)."""
        C, R = demand.shape
        N = avail.shape[0]
        accel_node, accel_class, spread_threshold = self._defaults(
            N, C, accel_node, accel_class, spread_threshold)
        c_pad, n_pad, r_pad = self._pads(C, N, R)
        dev = self.device
        _check_fp32_matmul(dev)
        cost_p = np.zeros((c_pad, n_pad), np.float32) if cost is None \
            else cost
        shifts = np.zeros(c_pad, np.int32) if zero_shifts else \
            np.asarray((np.arange(c_pad) * _ROT_STRIDE) % n_pad, np.int32)
        allocs, _ = _waterfill(
            _f32(avail, (n_pad, r_pad), dev),
            _f32(total, (n_pad, r_pad), dev),
            _f32(demand, (c_pad, r_pad), dev),
            _f32(counts, (c_pad,), dev),
            _bool(accel_node, (n_pad,), dev),
            _bool(accel_class, (c_pad,), dev),
            _scalar(spread_threshold, dev),
            _f32(cost_p, (c_pad, n_pad), dev),
            _scalar(1.0 if invert_util else 0.0, dev),
            torch.from_numpy(shifts).to(dev))
        allocs = allocs.cpu().numpy()[:C, :N]
        return np.rint(allocs).astype(np.int64)

    def solve_bundles(self, *args, **kwargs):
        raise NotImplementedError(f"solve_bundles {_LATER_SLICE}")

    # -- device-resident tick-stream interface ---------------------------
    def prepare_device(self, avail: np.ndarray, total: np.ndarray,
                       demand: np.ndarray,
                       accel_node: Optional[np.ndarray] = None,
                       accel_class: Optional[np.ndarray] = None,
                       spread_threshold: Optional[float] = None,
                       cost: Optional[np.ndarray] = None) -> None:
        """Upload the cluster world state once (with the static
        per-(class, node) cost matrix); later ``solve_stream`` calls
        ship only the per-tick arrivals.  Availability and totals are
        kept in the kernel's [R, N] layout."""
        C, R = demand.shape
        N = avail.shape[0]
        c_pad, n_pad, r_pad = self._pads(C, N, R)
        accel_node, accel_class, spread_threshold = self._defaults(
            N, C, accel_node, accel_class, spread_threshold)
        dev = self.device
        cost_p = np.zeros((c_pad, n_pad), np.float32) if cost is None \
            else cost
        self._device_state = {
            "cost": _f32(cost_p, (c_pad, n_pad), dev),
            "avail_t": _f32(avail, (n_pad, r_pad), dev).t().contiguous(),
            "total_t": _f32(total, (n_pad, r_pad), dev).t().contiguous(),
            "demand": _f32(demand, (c_pad, r_pad), dev),
            "accel_node": _bool(accel_node, (n_pad,), dev),
            "accel_class": _bool(accel_class, (c_pad,), dev),
            "thr": _scalar(spread_threshold, dev),
            "shape": (C, N, R), "pads": (c_pad, n_pad, r_pad),
        }

    def solve_stream(self, arrivals: np.ndarray,
                     pending0: Optional[np.ndarray] = None,
                     nnz_max: int = 32768,
                     rho: float | np.ndarray = 0.0) -> Dict[str, np.ndarray]:
        """Run K closed-loop ticks on the device (see
        ``_waterfill_stream``).  Returns per tick ``idx`` [K, nnz_max]
        in the PADDED flat space (class*N_pad + node; decode with
        ``expand_sparse``), ``vals``, ``placed``, ``ok`` and ``nnz``."""
        assert self._device_state is not None, "call prepare_device first"
        dev = self._device_state
        C, N, R = dev["shape"]
        c_pad, n_pad, r_pad = dev["pads"]
        device = dev["avail_t"].device
        _check_fp32_matmul(device)
        K = arrivals.shape[0]
        if pending0 is None:
            pending0 = np.zeros(C, dtype=np.float32)
        rho_vec = np.broadcast_to(np.asarray(rho, dtype=np.float32),
                                  (C,)).copy()
        packed = _waterfill_stream(
            dev["avail_t"], dev["total_t"], dev["demand"],
            _f32(pending0, (c_pad,), device),
            _f32(arrivals, (K, c_pad), device),
            _f32(rho_vec, (c_pad,), device),
            dev["accel_node"], dev["accel_class"], dev["thr"], dev["cost"],
            nnz_max).cpu().numpy()
        return {
            "idx": np.rint(packed[:, :nnz_max]).astype(np.int64),
            "vals": packed[:, nnz_max:2 * nnz_max],
            "placed": packed[:, 2 * nnz_max],
            "ok": packed[:, 2 * nnz_max + 1] > 0.5,
            "nnz": np.rint(packed[:, 2 * nnz_max + 2]).astype(np.int64),
        }

    def expand_sparse(self, idx: np.ndarray, vals: np.ndarray
                      ) -> np.ndarray:
        """Decode one tick's sparse assignment to dense alloc[C, N]."""
        assert self._device_state is not None
        C, N, R = self._device_state["shape"]
        c_pad, n_pad, _ = self._device_state["pads"]
        alloc = np.zeros((c_pad, n_pad), dtype=np.int64)
        live = idx < c_pad * n_pad
        alloc.reshape(-1)[idx[live]] = np.rint(vals[live]).astype(np.int64)
        return alloc[:C, :N]

    @staticmethod
    def _pads(C: int, N: int, R: int) -> Tuple[int, int, int]:
        return (_round_up(max(C, 1), 8), _round_up(max(N, 8), _GROUP),
                _round_up(max(R, 1), 8))

    @staticmethod
    def _defaults(N, C, accel_node, accel_class, spread_threshold):
        if accel_node is None:
            accel_node = np.zeros(N, dtype=bool)
        if accel_class is None:
            accel_class = np.zeros(C, dtype=bool)
        if spread_threshold is None:
            spread_threshold = get_config().scheduler_spread_threshold
        return accel_node, accel_class, spread_threshold

    # -- spec interface ----------------------------------------------------
    def assign(self, view, specs: Sequence) -> List:
        """Per-spec node targets (None = infeasible/unassigned)."""
        from ray_tpu_torch.scheduler import policy as policy_mod
        node_ids, total, avail, columns = view.snapshot()
        if not node_ids:
            return [None] * len(specs)
        groups: Dict[int, List[int]] = {}
        fallback: List[int] = []
        for i, spec in enumerate(specs):
            if spec.scheduling_options.scheduling_type is \
                    policy_mod.SchedulingType.HYBRID:
                groups.setdefault(spec.scheduling_class, []).append(i)
            else:
                fallback.append(i)
        targets: List = [None] * len(specs)
        if groups:
            classes = list(groups.keys())
            reqs = [specs[groups[c][0]].resources for c in classes]
            demand = view.demand_matrix(reqs)
            # demand_matrix may have added columns; re-snapshot widths.
            node_ids, total, avail, columns = view.snapshot()
            if demand.shape[1] < total.shape[1]:
                demand = _pad_to(demand, (demand.shape[0], total.shape[1]))
            counts = np.array([len(groups[c]) for c in classes])
            accel_node = accelerator_node_mask(total)
            accel_class = np.array([r.uses_accelerator() for r in reqs])
            alloc = self.solve_matrices(avail, total, demand, counts,
                                        accel_node, accel_class)
            for ci, cls in enumerate(classes):
                members = groups[cls]
                k = 0
                for n in range(len(node_ids)):
                    for _ in range(int(alloc[ci, n])):
                        if k < len(members):
                            targets[members[k]] = node_ids[n]
                            k += 1
        for i in fallback:
            targets[i] = policy_mod.schedule(
                view, specs[i].resources, specs[i].scheduling_options,
                local_node_id=None)
        return targets


class DeviceRuntimeSolver:
    """Device-resident scheduling session for the runtime dispatch path.

    The cluster world state lives on the device between ticks:

      * full upload only on structural change (node joined/left, new
        resource column, capacity growth), detected via the view's
        version counter;
      * otherwise only DIRTY node rows are written in (``_apply_rows``);
      * per tick, only the [C] counts vector goes down and one packed
        sparse assignment, with on-device validation bits, comes back.

    The solver never applies its own placements to the device
    availability: the host view stays authoritative (``view.subtract``
    on commit marks rows dirty, which re-syncs them next tick).
    ``solve`` returns None for the data conditions the caller answers
    with its greedy path: invalid output (``ok`` false), an assignment
    larger than the largest ``_NNZ_BUCKETS`` entry, more live classes
    than ``_MAX_CLASS_ROWS``, or no nodes.  A device or kernel failure
    resets the session and is raised.
    """

    _NNZ_BUCKETS = (256, 2048, 16384, 131072)
    # A class row idle this many ticks is an eviction candidate when the
    # demand matrix would otherwise have to grow.
    _CLASS_IDLE_TICKS = 256
    # Hard bound on interned class rows; past it the tick returns None.
    _MAX_CLASS_ROWS = 4096

    def __init__(self, locality_provider=None, device=None):
        self.device = resolve_device(device)
        self._state: Optional[dict] = None
        # scheduling_class -> demand row.
        self._class_rows: Dict[int, int] = {}
        self._class_reqs: List = []
        self._class_last_used: Dict[int, int] = {}
        self._demand_host: Optional[np.ndarray] = None   # [c_cap, r_pad]
        self._accel_host: Optional[np.ndarray] = None    # [c_cap]
        self._demand_dev = None
        self._accel_dev = None
        self._zero_cost_dev = None                       # [c_cap, n_pad]
        # Callable(list_of_specs) -> Dict[node_id, arg_bytes]: the
        # arg-locality signal.  None disables the locality cost term.
        self._locality_provider = locality_provider
        # True when the LAST solve used a nonzero cost matrix.
        self.last_cost_active = False
        self.stats = {"ticks": 0, "full_syncs": 0, "row_deltas": 0,
                      "fallbacks": 0, "class_evictions": 0,
                      "cost_ticks": 0}

    # -- public ----------------------------------------------------------
    def solve(self, view, specs: Sequence) -> Optional[List]:
        """Per-spec node targets, or None if the device path produced no
        valid assignment (the caller falls back to its greedy path)."""
        from ray_tpu_torch.scheduler import policy as policy_mod
        self.last_cost_active = False
        groups: Dict[int, List[int]] = {}
        fallback: List[int] = []
        for i, spec in enumerate(specs):
            opts = spec.scheduling_options
            if opts.scheduling_type is policy_mod.SchedulingType.HYBRID:
                groups.setdefault(spec.scheduling_class, []).append(i)
            else:
                fallback.append(i)
        targets: List = [None] * len(specs)
        if groups:
            try:
                ok = self._solve_groups(view, specs, groups, targets)
            except Exception:
                # The session may hold a half-synced device buffer and
                # the view's dirty set was already drained: force a full
                # resync next tick, and let the failure surface.
                self._state = None
                self.stats["fallbacks"] += 1
                raise
            if not ok:
                self.stats["fallbacks"] += 1
                return None
        for i in fallback:
            targets[i] = policy_mod.schedule(
                view, specs[i].resources, specs[i].scheduling_options,
                local_node_id=None)
        return targets

    # -- internals -------------------------------------------------------
    def _solve_groups(self, view, specs, groups, targets) -> bool:
        self.stats["ticks"] += 1
        ver, dirty_idx, dirty_rows = view.drain_dirty()
        st = self._state
        if (st is None or ver != st["version"]
                or view.num_nodes() > st["n_pad"]
                or view.num_columns() > st["r_pad"]):
            self._full_sync(view)
            st = self._state
        elif dirty_idx:
            self._apply_deltas(dirty_idx, dirty_rows)
        if st is None or not st["node_ids"]:
            return False
        tick = self.stats["ticks"]
        for cls in groups:
            self._class_last_used[cls] = tick
        new_classes = [c for c in groups if c not in self._class_rows]
        if new_classes and (len(self._class_reqs) + len(new_classes)
                            > self._demand_host.shape[0]):
            # Growth would widen c_cap: first reclaim idle rows.
            self._evict_stale_classes(set(groups), st)
            if (len(self._class_reqs) + len(new_classes)
                    > self._MAX_CLASS_ROWS):
                self._evict_stale_classes(set(groups), st, force_lru=True)
            if (len(self._class_reqs) + len(new_classes)
                    > self._MAX_CLASS_ROWS):
                return False
        for cls, members in groups.items():
            if cls not in self._class_rows:
                req = specs[members[0]].resources
                if any(name not in st["columns"] for name in req.names()):
                    view.demand_matrix([req])   # creates columns
                    self._full_sync(view)
                    st = self._state
                self._register_class(cls, req, st)
        c_cap = self._demand_host.shape[0]
        counts = np.zeros(c_cap, dtype=np.float32)
        for cls, members in groups.items():
            counts[self._class_rows[cls]] = len(members)
        total_q = int(counts.sum())
        nnz_bound = min(total_q, len(groups) * len(st["node_ids"]))
        nnz_max = next((b for b in self._NNZ_BUCKETS if b >= nnz_bound),
                       None)
        if nnz_max is None:
            return False
        cfg = get_config()
        cost = self._build_cost(specs, groups, st, c_cap, cfg)
        if isinstance(cost, np.ndarray):
            cost = torch.from_numpy(cost).to(self.device)
        n_pad = st["n_pad"]
        _check_fp32_matmul(self.device)
        packed = _solve_tick(
            st["avail_t"], st["total_t"], self._demand_dev,
            torch.from_numpy(counts).to(self.device), st["accel_node"],
            self._accel_dev, _scalar(cfg.scheduler_spread_threshold,
                                     self.device),
            cost, nnz_max).cpu().numpy()
        if not packed[2 * nnz_max + 1] > 0.5:
            return False
        # Decode the sparse assignment and expand per-spec targets.
        idx = np.rint(packed[:nnz_max]).astype(np.int64)
        vals = packed[nnz_max:2 * nnz_max]
        live = idx < c_cap * n_pad
        idx, vals = idx[live], vals[live]
        alloc = np.zeros((c_cap, n_pad), dtype=np.int64)
        alloc.reshape(-1)[idx] = np.rint(vals).astype(np.int64)
        node_ids = st["node_ids"]
        n_real = len(node_ids)
        for cls, members in groups.items():
            row = alloc[self._class_rows[cls]]
            k = 0
            for n in range(n_real):
                for _ in range(int(row[n])):
                    if k < len(members):
                        targets[members[k]] = node_ids[n]
                        k += 1
        return True

    def _build_cost(self, specs, groups, st, c_cap: int, cfg):
        """Per-(class, node) cost matrix for this tick (numpy), or the
        cached device-resident zeros when no cost term is live.

        Two terms, in utilization units (1/16 = one fill bucket):
          * heterogeneity: ``w_het * (1 - rate/max_rate)`` from the node
            throughput labels, per class (accelerator classes read the
            accelerator rate);
          * arg-locality: ``-w_loc * bytes_on_node / max_bytes`` over
            the class's queued specs, from the locality provider.
        """
        w_het = cfg.scheduler_het_weight
        w_loc = cfg.scheduler_locality_weight
        het = st["het_active"] and w_het > 0.0
        loc_rows: Dict[int, Dict] = {}
        if w_loc > 0.0 and self._locality_provider is not None:
            for cls, members in groups.items():
                with_args = [specs[i] for i in members
                             if getattr(specs[i], "args", None)]
                if not with_args:
                    continue
                try:
                    by_node = self._locality_provider(with_args)
                except Exception:
                    # A locality hint is advisory: without it the class
                    # simply fills without the locality preference.
                    by_node = None
                if by_node:
                    loc_rows[cls] = by_node
        if not het and not loc_rows:
            self.last_cost_active = False
            return self._zero_cost_dev
        self.last_cost_active = True
        self.stats["cost_ticks"] += 1
        n_pad = st["n_pad"]
        cost = np.zeros((c_cap, n_pad), dtype=np.float32)
        if het:
            accel = self._accel_host
            cost[:] = np.where(accel[:, None], st["het_accel"][None, :],
                               st["het_cpu"][None, :]) * np.float32(w_het)
        node_index = st["node_index"]
        for cls, by_node in loc_rows.items():
            row = self._class_rows.get(cls)
            if row is None:
                continue
            top = max(by_node.values())
            if top <= 0:
                continue
            for nid, nbytes in by_node.items():
                idx = node_index.get(nid)
                if idx is not None:
                    cost[row, idx] -= np.float32(w_loc) * \
                        np.float32(nbytes / top)
        return cost

    def _full_sync(self, view):
        self.stats["full_syncs"] += 1
        ver, node_ids, total, avail, columns = view.snapshot_versioned()
        N, R = total.shape
        prev = self._state
        # Keep padded dims monotone across node churn.
        n_pad = _round_up(max(N, 8), _GROUP)
        r_pad = _round_up(max(R, 1), 8)
        if prev is not None:
            n_pad = max(n_pad, prev["n_pad"])
            r_pad = max(r_pad, prev["r_pad"])
        accel_node = accelerator_node_mask(total)
        # Per-node throughput rates, normalized to the fleet max so a
        # homogeneous fleet costs zero; padded nodes carry the max rate.
        rates_cpu = np.ones(n_pad, dtype=np.float32)
        rates_accel = np.ones(n_pad, dtype=np.float32)
        for i, nid in enumerate(node_ids):
            res = view.node_resources(nid)
            labels = getattr(res, "labels", None) or {}
            r = _label_rate(labels, NODE_THROUGHPUT_LABEL)
            rates_cpu[i] = r
            rates_accel[i] = _label_rate(
                labels, NODE_ACCEL_THROUGHPUT_LABEL, default=r)
        rates_cpu[N:] = rates_cpu[:max(N, 1)].max()
        rates_accel[N:] = rates_accel[:max(N, 1)].max()
        het_cpu = 1.0 - rates_cpu / rates_cpu.max()
        het_accel = 1.0 - rates_accel / rates_accel.max()
        dev = self.device
        self._state = {
            "version": ver, "node_ids": node_ids, "columns": columns,
            "node_index": {nid: i for i, nid in enumerate(node_ids)},
            "n_pad": n_pad, "r_pad": r_pad,
            "het_cpu": het_cpu.astype(np.float32),
            "het_accel": het_accel.astype(np.float32),
            "het_active": bool(het_cpu.any() or het_accel.any()),
            "avail_t": _f32(avail, (n_pad, r_pad), dev).t().contiguous(),
            "total_t": _f32(total, (n_pad, r_pad), dev).t().contiguous(),
            "accel_node": _bool(accel_node, (n_pad,), dev),
        }
        self._rebuild_demand(columns, r_pad)

    def _rebuild_demand(self, columns: Dict[str, int], r_pad: int):
        c_cap = max(8, _round_up(max(len(self._class_reqs), 1), 8))
        demand = np.zeros((c_cap, r_pad), dtype=np.float32)
        accel = np.zeros(c_cap, dtype=bool)
        for row, req in enumerate(self._class_reqs):
            for name, v in req.to_dict().items():
                col = columns.get(name)
                if col is not None:
                    demand[row, col] = v
            accel[row] = req.uses_accelerator()
        self._demand_host, self._accel_host = demand, accel
        self._upload_demand()
        n_pad = self._state["n_pad"] if self._state else _GROUP
        # Device-resident zero cost: the common no-cost tick passes this.
        self._zero_cost_dev = torch.zeros((c_cap, n_pad), dtype=torch.float32,
                                          device=self.device)

    def _upload_demand(self):
        self._demand_dev = torch.tensor(self._demand_host,
                                        device=self.device)
        self._accel_dev = torch.tensor(self._accel_host, device=self.device)

    def _evict_stale_classes(self, keep: set, st: dict,
                             force_lru: bool = False) -> bool:
        """Drop demand rows of classes idle for ``_CLASS_IDLE_TICKS``
        ticks (all outside ``keep`` with ``force_lru``).  Returns True if
        anything moved; a re-appearing class is simply re-registered."""
        tick = self.stats["ticks"]
        row_to_cls = {row: c for c, row in self._class_rows.items()}
        survivors = []
        for row in range(len(self._class_reqs)):
            cls = row_to_cls[row]
            idle = tick - self._class_last_used.get(cls, tick)
            if cls in keep or (not force_lru
                               and idle < self._CLASS_IDLE_TICKS):
                survivors.append((cls, self._class_reqs[row]))
        if len(survivors) == len(self._class_reqs):
            return False
        self.stats["class_evictions"] += \
            len(self._class_reqs) - len(survivors)
        self._class_rows = {c: i for i, (c, _) in enumerate(survivors)}
        self._class_reqs = [req for _, req in survivors]
        self._class_last_used = {
            c: self._class_last_used.get(c, tick) for c, _ in survivors}
        self._rebuild_demand(st["columns"], st["r_pad"])
        return True

    def _register_class(self, cls: int, req, st: dict):
        row = len(self._class_reqs)
        self._class_rows[cls] = row
        self._class_reqs.append(req)
        if row >= self._demand_host.shape[0]:
            self._rebuild_demand(st["columns"], st["r_pad"])
            return
        for name, v in req.to_dict().items():
            col = st["columns"].get(name)
            if col is not None:
                self._demand_host[row, col] = v
        self._accel_host[row] = req.uses_accelerator()
        # Registration is rare; re-upload the small demand matrix whole.
        self._upload_demand()

    def _apply_deltas(self, dirty_idx: List[int], dirty_rows: np.ndarray):
        st = self._state
        self.stats["row_deltas"] += len(dirty_idx)
        n_pad, r_pad = st["n_pad"], st["r_pad"]
        if len(dirty_idx) > n_pad // 2:
            # Cheaper to re-upload than to scatter half the matrix.
            avail = st["avail_t"].cpu().numpy().T.copy()
            avail[dirty_idx, :dirty_rows.shape[1]] = dirty_rows
            st["avail_t"] = _f32(avail, (n_pad, r_pad),
                                 self.device).t().contiguous()
            return
        k_pad = 1
        while k_pad < len(dirty_idx):
            k_pad *= 2
        idx = np.full(k_pad, dirty_idx[-1], dtype=np.int64)
        idx[:len(dirty_idx)] = dirty_idx
        rows = np.zeros((k_pad, r_pad), dtype=np.float32)
        rows[:, :dirty_rows.shape[1]] = dirty_rows[-1]
        rows[:len(dirty_idx), :dirty_rows.shape[1]] = dirty_rows
        _apply_rows(st["avail_t"], torch.from_numpy(idx).to(self.device),
                    torch.from_numpy(rows).to(self.device))
