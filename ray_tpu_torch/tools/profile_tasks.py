"""C1 and C2: the task API (``init`` -> ``@remote`` -> ``get``) through
the raylets' batched tick, on one node and over 64.

    python -m ray_tpu_torch.tools.profile_tasks [--phase c1|c2|both]
        [--device cuda] [--tasks 100000] [--raylets 64] [--profile]

``single_node`` is ``chip_smoke.py``'s C1, the JAX package's
``bench_runtime.py`` single-node rows (``BASELINE.json``:
"benchmarks/single_node: 10k no-op @ray.remote tasks, 1 raylet"): one
head raylet with ``os.cpu_count()`` CPUs; 200 warm-up and 10,000 no-op
tasks (tasks/s); 2,000 tasks that return the time they started, for the
submit-to-running latency; one task with 10,000 ``ObjectRef`` arguments
from ``put``; one task with 3,000 returns; one ``get`` of 10,000 refs.
Every value is checked.

``cluster_tasks`` is C2, ``BASELINE.json``'s "benchmarks/scheduling.yaml:
100k heterogeneous-resource tasks over 64 simulated nodes", through the
real submitter: a ``LocalCluster`` of 64 raylets with R3's node shapes
(``build_problem(default_rng(7))``, its first 64 rows) under ``init``,
and R3's 64 classes as ``.options(...)`` of one no-op function that
returns its index, 100,000 tasks submitted from the driver.  Classes
that no node of the 64 can hold would park for ever: they are dropped
before submitting and counted as a cut.  Every result must equal its
index and is read once (one ``get`` of all the refs); the latency is
from a task's submission to its return being sealed in the owner's
memory store (a ``get_async`` callback).

Both report the raylets' batched ticks and ``class_fill`` launches and
raise when a tick fell back or a device solve raised.  With
``--profile`` each phase runs once more under ``torch.profiler``
(device activity only), for its device time, ``class_fill``'s share of
it and the device's idle share against the wall.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ray_tpu_torch.tools.profile_cluster import bench_names, row_dict

# R3's configuration: 64 raylets, 100,000 tasks in 64 classes.
C2_TASKS = 100_000
C2_RAYLETS = 64


def _noop():
    return None


def _started():
    return time.perf_counter()


def _count(*args):
    return len(args), sum(args)


def _spread(n):
    return list(range(n))


def _index(i):
    return i


def _tick_totals(cluster):
    """Batched ticks a raylet (its ``class_fill`` launches on the card)
    and the tick counters that must stay 0."""
    ticks, bad = {}, {"jnp_fallbacks": 0, "device_errors": 0,
                      "dispatch_errors": 0, "handler_errors": 0,
                      "solver_fallbacks": 0}
    for r in cluster.raylets():
        solver = r.cluster_task_manager._solver
        ticks[r.node_name] = solver.stats["ticks"] if solver else 0
        ts = r.cluster_task_manager.tick_stats
        for k in ("jnp_fallbacks", "device_errors", "dispatch_errors"):
            bad[k] += ts[k]
        bad["handler_errors"] += sum(h["errors"] for h in
                                     r.loop.handler_stats.values())
        bad["solver_fallbacks"] += solver.stats["fallbacks"] if solver \
            else 0
    return ticks, bad


def _check_clean(name, bad):
    if any(bad.values()):
        raise AssertionError(f"{name}: the raylets counted errors {bad}")


def _percentiles(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def single_node(device="cuda", n_tasks=10_000, n_latency=2_000,
                n_args=10_000, n_returns=3_000, n_get=10_000,
                num_cpus=None):
    """C1 (module docstring).  Returns its numbers; raises
    AssertionError on a wrong value or a raylet error."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ops import class_fill as cf
    num_cpus = os.cpu_count() if num_cpus is None else num_cpus
    rt.init(num_cpus=num_cpus, device=device)
    try:
        cluster = global_worker().cluster
        launches0 = cf.class_fill.launches
        noop = rt.remote(_noop)
        if rt.get([noop.remote() for _ in range(200)]) != [None] * 200:
            raise AssertionError("C1: a warm-up task returned a value")
        t0 = time.perf_counter()
        out = rt.get([noop.remote() for _ in range(n_tasks)])
        tasks_s = n_tasks / (time.perf_counter() - t0)
        if out != [None] * n_tasks:
            raise AssertionError("C1: a no-op task returned a value")

        started = rt.remote(_started)
        submitted, refs = [], []
        for _ in range(n_latency):
            submitted.append(time.perf_counter())
            refs.append(started.remote())
        lat = (np.array(rt.get(refs)) - np.array(submitted)) * 1e3
        if not (lat > 0).all():
            raise AssertionError("C1: a task started before its submit")
        p50, p99 = _percentiles(lat)

        puts = [rt.put(i) for i in range(n_args)]
        t0 = time.perf_counter()
        got = rt.get(rt.remote(_count).remote(*puts), timeout=600)
        args_s = time.perf_counter() - t0
        if got != (n_args, n_args * (n_args - 1) // 2):
            raise AssertionError(f"C1: {n_args} args gave {got}")

        spread = rt.remote(num_returns=n_returns)(_spread)
        t0 = time.perf_counter()
        values = rt.get(spread.remote(n_returns), timeout=600)
        returns_s = time.perf_counter() - t0
        if values != list(range(n_returns)):
            raise AssertionError(f"C1: {n_returns} returns are wrong")

        refs = [rt.put(i) for i in range(n_get)]
        t0 = time.perf_counter()
        values = rt.get(refs, timeout=600)
        get_s = time.perf_counter() - t0
        if values != list(range(n_get)):
            raise AssertionError(f"C1: a get of {n_get} refs is wrong")

        ticks, bad = _tick_totals(cluster)
        _check_clean("C1", bad)
        head = cluster.head_node
        return {"num_cpus": num_cpus, "tasks": n_tasks,
                "tasks_per_s": tasks_s, "latency_p50_ms": p50,
                "latency_p99_ms": p99, "args": n_args, "args_s": args_s,
                "returns": n_returns, "returns_s": returns_s,
                "get_many": n_get, "get_many_s": get_s,
                "batched_ticks": ticks[head.node_name],
                "busy_ticks": head.cluster_task_manager.tick_stats[
                    "busy_ticks"],
                "launches": cf.class_fill.launches - launches0,
                "lease_stats": dict(head.lease_stats),
                "peak_workers": head.worker_pool.peak_workers, **bad}
    finally:
        rt.shutdown()


def feasible_classes(total, demand):
    """Which rows of ``demand`` fit some node's totals."""
    return [bool((total >= demand[c]).all(axis=1).any())
            for c in range(demand.shape[0])]


def _options(names, row):
    res = row_dict(names, row)
    return dict(num_cpus=res.pop("CPU", 0), num_gpus=res.pop("GPU", 0),
                memory=res.pop("memory", 0), resources=res)


def cluster_tasks(n_tasks=C2_TASKS, n_raylets=C2_RAYLETS, device="cuda"):
    """C2 (module docstring).  Returns its numbers; raises
    AssertionError on a wrong or missing value or a raylet error."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.cluster import LocalCluster
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.scheduler import bench as sb
    rng = np.random.default_rng(7)
    _, total, demand, _, _, _ = sb.build_problem(rng)
    classes = rng.integers(0, 64, size=n_tasks)
    names = bench_names(total)
    fits = feasible_classes(total[:n_raylets], demand[:64])
    keep = np.array([fits[int(c)] for c in classes])
    cluster = LocalCluster(device=device)
    for i in range(n_raylets):
        cluster.add_node(row_dict(names, total[i]), node_name=f"c2-{i}")
    rt.init(_cluster=cluster)
    try:
        launches0 = cf.class_fill.launches
        core = global_worker().core_worker
        index = rt.remote(_index)
        fns = [index.options(**_options(names, demand[c])) if fits[c]
               else None for c in range(64)]
        kept = np.flatnonzero(keep)
        submitted = np.zeros(len(kept))
        ready = np.full(len(kept), np.nan)

        def on_sealed(j):
            def cb(_entry):
                ready[j] = time.perf_counter()
            return cb
        refs = []
        t0 = time.perf_counter()
        for j, i in enumerate(kept.tolist()):
            submitted[j] = time.perf_counter()
            ref = fns[int(classes[i])].remote(i)
            core.memory_store.get_async(ref.object_id(), on_sealed(j))
            refs.append(ref)
        submit_s = time.perf_counter() - t0
        values = rt.get(refs, timeout=1800)
        wall = time.perf_counter() - t0
        if len(values) != len(kept) or \
                (np.asarray(values) != kept).any():
            bad = int((np.asarray(values) != kept).sum())
            raise AssertionError(f"C2: {bad} results differ from their "
                                 "index")
        if np.isnan(ready).any():
            raise AssertionError("C2: a result was read before it was "
                                 "sealed")
        p50, p99 = _percentiles((ready - submitted) * 1e3)
        ticks, bad = _tick_totals(cluster)
        _check_clean("C2", bad)
        spills = sum(r.cluster_task_manager.tick_stats["spillbacks"]
                     for r in cluster.raylets())
        rejected = sum(r.cluster_task_manager.tick_stats[
            "spillback_rejections"] for r in cluster.raylets())
        return {"raylets": n_raylets, "tasks": n_tasks,
                "submitted": len(kept),
                "dropped_infeasible": int(n_tasks - len(kept)),
                "dropped_share": float(1 - len(kept) / n_tasks),
                "dropped_classes": int(sum(not fits[c]
                                           for c in set(classes.tolist()))),
                "cpus": float(total[:n_raylets, 0].sum()),
                "tasks_per_s": len(kept) / wall, "wall_s": wall,
                "submit_s": submit_s, "latency_p50_ms": p50,
                "latency_p99_ms": p99,
                "launches": cf.class_fill.launches - launches0,
                "batched_ticks": {k: v for k, v in ticks.items() if v},
                "raylets_with_batched_ticks": sum(v > 0 for v in
                                                  ticks.values()),
                "spillbacks": spills, "spillback_rejections": rejected,
                "submitter": dict(core.task_submitter.submitter_stats),
                # Each pool's peak, summed: at least the peak of worker
                # threads alive at once.
                "peak_workers": sum(r.worker_pool.peak_workers
                                    for r in cluster.raylets()),
                **bad}
    finally:
        rt.shutdown()


def _profiled(torch, phase):
    """``phase()`` under ``torch.profiler``: its numbers, plus the device
    time summed over every operation the card ran and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = phase()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the profiler saw no device operation")
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    out.update(device_ms=device_ms, device_ops=len(ops),
               class_fill_device_ms=sum(
                   e.time_range.elapsed_us() for e in ops
                   if "class_fill" in e.name) / 1e3,
               profiled_wall_ms=wall_ms,
               idle_share=max(0.0, 1 - device_ms / wall_ms))
    return out


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=("c1", "c2", "both"))
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    parser.add_argument("--tasks", type=int, default=C2_TASKS)
    parser.add_argument("--raylets", type=int, default=C2_RAYLETS)
    parser.add_argument("--profile", action="store_true",
                        help="each phase once more under torch.profiler")
    args = parser.parse_args(argv)
    if args.profile and args.device == "cpu":
        parser.error("--profile traces the card")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_tasks: needs a CUDA device")
        print(card(), flush=True)
    phases = []
    if args.phase in ("c1", "both"):
        phases.append(("C1", lambda: single_node(args.device)))
    if args.phase in ("c2", "both"):
        phases.append(("C2", lambda: cluster_tasks(
            args.tasks, args.raylets, args.device)))
    for name, phase in phases:
        print(json.dumps({"phase": name, **phase()}), flush=True)
        if args.profile:
            print(json.dumps({"phase": name, "profiled": True,
                              **_profiled(torch, phase)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
