#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the package's CUDA kernel from the sources in this checkout,
holds it against its plain PyTorch version on the card, then drives the
scheduling tick through both entry points at the bench's full width
(1M tasks x 256 classes x 10,000 nodes x 8 resources):

  A. ``BatchSolver.prepare_device`` + ``solve_stream``: 40 closed-loop
     ticks, checked on the host and against a CPU run of the first 3;
  B. ``DeviceRuntimeSolver.solve`` on a 10,000-node view: a burst of
     20,000 specs in 64 classes, every grant committed, a delta tick,
     targets checked against a CPU-device solver on a copy of the view.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA, or without the package beside
this file, it exits non-zero at once.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
# outside the tensor cores (the kernel does no matrix products).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def build_problem(rng, num_tasks=1_000_000, C=256, N=10_000, R=8):
    """The bench problem: heterogeneous fleet (small CPU nodes, big CPU
    nodes, accelerator hosts), power-law class counts."""
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
    """Tick 0 delivers the whole backlog; later ticks about the
    placement rate, with a rotating per-class mix."""
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


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fill_inputs(avail, total, demand, counts, accel_node, accel_class,
                cost, device):
    import torch
    from ray_tpu_torch.scheduler.torch_backend import BatchSolver, _pad_to
    C, R = demand.shape
    N = avail.shape[0]
    c_pad, n_pad, r_pad = BatchSolver._pads(C, N, R)

    def f32(x, shape):
        return torch.from_numpy(np.ascontiguousarray(
            _pad_to(x.astype(np.float32), shape))).to(device)

    return dict(
        av_t=f32(avail, (n_pad, r_pad)).t().contiguous(),
        total_t=f32(total, (n_pad, r_pad)).t().contiguous(),
        demand=f32(demand, (c_pad, r_pad)),
        counts=f32(counts, (c_pad,)),
        accel_class=f32(accel_class, (c_pad,)) > 0,
        accel_node=f32(accel_node, (n_pad,)) > 0,
        cost=f32(cost, (c_pad, n_pad)),
        shifts=torch.from_numpy(np.asarray(
            (np.arange(c_pad) * 977) % n_pad, np.int32)).to(device),
    )


def fill_call(fn, x, thr, invert):
    return fn(x["av_t"], x["total_t"], x["demand"], x["counts"],
              x["accel_class"], x["accel_node"], thr, x["cost"], invert,
              x["shifts"])


def fill_bound(x, allocs):
    """Least time for one call on these inputs: bytes read once and
    written once over HBM bandwidth, against the float32 operations
    this data needs, over the float32 rate."""
    r_pad, n_pad = x["av_t"].shape
    c_pad = x["demand"].shape[0]
    read = sum(t.numel() * t.element_size() for t in x.values()) + 8
    written = (r_pad * n_pad + c_pad * n_pad) * 4
    # Per (class, node) and demanded resource: a ratio (div), a min, a
    # utilization (sub, div) and a max; about 20 more per (class, node)
    # for cap, score, bucket, prefix and take; per placed (class, node)
    # and demanded resource the availability update (mul, sub).
    demanded = (x["demand"] > 0).sum(dim=1).double()
    placed = (allocs > 0).sum(dim=1).double()
    ops = float((n_pad * (5 * demanded + 20) + 2 * demanded * placed).sum())
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", read + written)


def phase_kernel(torch, cf):
    """The kernel against its plain version on the card."""
    dev = torch.device("cuda")
    worst = 0.0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        C, N, R = 40, 300 + 37 * seed, 5 if seed % 2 else 8
        avail = np.floor(rng.uniform(0, 8, (N, R))).astype(np.float32)
        total = avail + np.floor(rng.uniform(0, 4, (N, R))).astype(
            np.float32)
        demand = np.floor(rng.uniform(0, 2.2, (C, R))).astype(np.float32)
        counts = rng.integers(0, 50, C).astype(np.float32)
        an, ac = rng.random(N) < 0.2, rng.random(C) < 0.3
        for with_cost in (False, True):
            cost = (np.where(rng.random((C, N)) < 0.1,
                             rng.uniform(-0.6, 0.4, (C, N)), 0.0)
                    if with_cost else np.zeros((C, N)))
            x = fill_inputs(avail, total, demand, counts, an, ac, cost, dev)
            for invert in (0.0, 1.0):
                thr = 0.3 if seed == 3 else 0.5
                av_k, al_k = fill_call(cf.class_fill, x, thr, invert)
                torch.cuda.synchronize()
                av_r, al_r = fill_call(cf.class_fill_reference, x, thr,
                                       invert)
                if not torch.equal(al_k, al_r):
                    bad = (al_k != al_r).nonzero()[:5].tolist()
                    raise AssertionError(
                        f"allocs differ (seed={seed} cost={with_cost} "
                        f"invert={invert}) at {bad}")
                err = (av_k - av_r).abs().max().item()
                if err > 1e-4:
                    raise AssertionError(f"availability differs by {err}")
                worst = max(worst, err)
    log(f"[kernel] 16 random problems: allocs bit-equal, max |av| diff "
        f"{worst}")

    rng = np.random.default_rng(42)
    avail, total, demand, counts, an, ac = build_problem(rng)
    x = fill_inputs(avail, total, demand, counts, an, ac,
                    np.zeros((demand.shape[0], avail.shape[0])), dev)
    av_k, al_k = fill_call(cf.class_fill, x, 0.5, 0.0)
    torch.cuda.synchronize()
    av_r, al_r = fill_call(cf.class_fill_reference, x, 0.5, 0.0)
    torch.cuda.synchronize()
    if not torch.equal(al_k, al_r):
        raise AssertionError("allocs differ at the bench shape: "
                             f"{int((al_k != al_r).sum())} entries")
    err = (av_k - av_r).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"availability differs by {err} at the bench "
                             "shape")
    worst = max(worst, err)
    placed = int(al_k.sum().item())
    ms = cuda_ms(lambda: fill_call(cf.class_fill, x, 0.5, 0.0), iters=50)
    plain_ms = cuda_ms(lambda: fill_call(cf.class_fill_reference, x, 0.5,
                                         0.0), iters=3, warmup=1)
    bound_ms, bound_by, nbytes = fill_bound(x, al_k)
    log(f"[kernel] bench shape C_pad={x['demand'].shape[0]} "
        f"N_pad={x['av_t'].shape[1]} R_pad={x['av_t'].shape[0]}: "
        f"bit-equal, {placed} tasks placed; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB, {bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_stream(torch, cf, tb):
    """Path A: the closed-loop stream at full width."""
    rng = np.random.default_rng(42)
    avail, total, demand, counts, an, ac = build_problem(rng)
    stream = arrival_stream(rng, counts, 40, per_tick=130_000)
    ticks = stream.shape[0]
    rho = rng.integers(2, 9, size=demand.shape[0]) / 16.0

    cf.class_fill.launches = 0
    solver = tb.BatchSolver(device="cuda")
    solver.prepare_device(avail, total, demand, accel_node=an,
                          accel_class=ac, spread_threshold=0.5)
    out = solver.solve_stream(stream, rho=rho)
    if not out["ok"].all():
        raise AssertionError(f"on-device validation failed on ticks "
                             f"{np.nonzero(~out['ok'])[0].tolist()}")
    alloc0 = solver.expand_sparse(out["idx"][0], out["vals"][0])
    usage = alloc0.T.astype(np.float64) @ demand.astype(np.float64)
    if not (usage <= avail.astype(np.float64) + 1e-2).all():
        raise AssertionError("capacity violated on tick 0")
    if not (alloc0.sum(axis=1) <= stream[0]).all():
        raise AssertionError("count violated on tick 0")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        again = solver.solve_stream(stream, rho=rho)
    torch.cuda.synchronize()
    ms_tick = (time.perf_counter() - t0) / (reps * ticks) * 1e3
    launches = cf.class_fill.launches
    for key in ("idx", "vals", "placed", "ok", "nnz"):
        if not np.array_equal(out[key], again[key]):
            raise AssertionError(f"stream not deterministic in {key}")
    if launches != (reps + 1) * ticks:
        raise AssertionError(f"class_fill launched {launches} times, "
                             f"expected {(reps + 1) * ticks}")

    cpu = tb.BatchSolver(device="cpu")
    cpu.prepare_device(avail, total, demand, accel_node=an,
                       accel_class=ac, spread_threshold=0.5)
    ref = cpu.solve_stream(stream[:3], rho=rho)
    for key in ("idx", "vals", "placed", "ok", "nnz"):
        if not np.array_equal(out[key][:3], ref[key]):
            raise AssertionError(f"ticks 0-2 differ from the CPU run in "
                                 f"{key}")
    log(f"[path A] solve_stream {ticks} ticks x {reps} reps: "
        f"{ms_tick:.3f} ms/tick; placed tick0={int(out['placed'][0])} "
        f"total={int(out['placed'].sum())}; max nnz="
        f"{int(out['nnz'].max())}; class_fill launches={launches}; "
        f"ticks 0-2 bit-identical to device='cpu'")
    return launches, ms_tick


def _view_from(tres, names, total, avail):
    view = tres.ClusterResourceView()
    for i in range(total.shape[0]):
        nr = tres.NodeResources({names[r]: float(total[i, r])
                                 for r in range(total.shape[1])})
        nr.available = {names[r]: tres._quantize(avail[i, r])
                        for r in range(total.shape[1])
                        if tres._quantize(avail[i, r]) > 0}
        view.add_node(f"node{i:05d}", nr)
    return view


def phase_runtime(torch, cf, tb, tres, tpolicy):
    """Path B: the raylet's per-tick session on a 10,000-node view."""
    rng = np.random.default_rng(7)
    avail, total, demand, _, _, _ = build_problem(rng)
    names = ["CPU", "memory", "TPU", "GPU"] + [
        f"custom_{r}" for r in range(4, total.shape[1])]
    t0 = time.perf_counter()
    views = [_view_from(tres, names, total, avail) for _ in range(2)]
    log(f"[path B] two 10,000-node views built in "
        f"{time.perf_counter() - t0:.1f} s")

    class Spec:
        def __init__(self, cls):
            d = demand[cls]
            self.resources = tres.ResourceRequest(
                {names[r]: float(d[r]) for r in range(len(names))
                 if d[r] > 0})
            self.scheduling_options = tpolicy.SchedulingOptions.hybrid()
            self.scheduling_class = 5000 + cls

    def burst(n):
        cls = rng.integers(0, 64, size=n)
        return [Spec(int(c)) for c in cls]

    cf.class_fill.launches = 0
    gpu = tb.DeviceRuntimeSolver(device="cuda")
    cpu = tb.DeviceRuntimeSolver(device="cpu")
    tick_ms = []
    launches_before_cpu = None
    for n in (20_000, 20_000):
        specs = burst(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.solve(views[0], specs)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        launches_before_cpu = cf.class_fill.launches
        want = cpu.solve(views[1], specs)
        if got is None or want is None:
            raise AssertionError("runtime solver returned None")
        if got != want:
            diff = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"{diff} targets differ from the CPU "
                                 "solver")
        granted = 0
        for view in views:
            for t, s in zip(got, specs):
                if t is not None:
                    if not view.subtract(t, s.resources):
                        raise AssertionError(f"grant on {t} did not commit")
                    granted += 1
        log(f"[path B] tick: {n} specs, {granted // 2} granted and "
            f"committed, {tick_ms[-1]:.1f} ms")
    launches = cf.class_fill.launches
    if launches != launches_before_cpu or launches != 2:
        raise AssertionError(f"class_fill launched {launches} times in "
                             "path B, expected 2")
    st = gpu.stats
    if st["fallbacks"] != 0 or st["full_syncs"] != 1 or \
            st["row_deltas"] <= 0:
        raise AssertionError(f"runtime solver stats {st}")
    log(f"[path B] stats {st}; ms/tick full-sync {tick_ms[0]:.3f}, "
        f"delta {tick_ms[1]:.3f}; class_fill launches={launches}")
    return launches, tick_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: run from a checkout that holds ray_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[setup] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.scheduler import policy as tpolicy
    from ray_tpu_torch.scheduler import resources as tres
    from ray_tpu_torch.scheduler import torch_backend as tb
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "ray_tpu" \
                or mod.startswith("ray_tpu."):
            raise AssertionError(f"{mod} imported")

    t0 = time.perf_counter()
    _build.load("class_fill.cu")
    log(f"[setup] class_fill.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    k = phase_kernel(torch, cf)
    launches_a, ms_a = phase_stream(torch, cf, tb)
    launches_b, ms_b = phase_runtime(torch, cf, tb, tres, tpolicy)

    kernels = [{
        "name": "class_fill",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/class_fill.cu",
        "replaces": "ray_tpu/scheduler/jax_backend.py:374",
        "launches": launches_a + launches_b,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_us": k["bound_ms"] * 1e3,
        "bound_by": k["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"path_a_ms_per_tick": ms_a,
                    "path_b_ms_per_tick": ms_b,
                    "launches": {"path_a": launches_a,
                                 "path_b": launches_b}}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
