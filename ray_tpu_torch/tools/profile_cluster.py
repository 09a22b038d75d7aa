"""R3, the burst of leases across a ``Cluster`` of 64 raylets, run
again and again.

    python -m ray_tpu_torch.tools.profile_cluster [--runs 10] [--profile]
        [--leases 100000] [--device cuda]

``cluster_burst`` is ``chip_smoke.py``'s R3: 64 raylets with the first
64 node shapes of the bench fleet (``build_problem(default_rng(7))``,
Path B's fleet and 64 classes), the default knobs, and a lessee with the
reference submitter's protocol (``ray_tpu/_private/direct_task_submitter.py``)
on this thread.  The lessee sends the leases to the head raylet in
batches, at most ``MAX_PENDING_PER_CLASS`` a class in flight and
``LEASE_BATCH`` a batch; it re-sends each spillback at once to the
raylet it names, with ``grant_or_reject``, so that the lease is granted
there or rejected, and a rejected lease goes back to the front of its
class's queue, for the head again; a backlogged entry goes back there
too and its class waits ``BACKLOG_RETRY_S``; a granted worker is
returned at once; infeasible leases are counted apart.  Every feasible
lease must be granted exactly once within ``WALL_S``, no raylet may
count an error, and the solvers may not fall back.

``main`` runs the burst ``--runs`` times, each in a new cluster, and
prints one JSON line a run (its numbers, or the failure) and a summary
with the count of runs that failed; with ``--profile`` one more run goes
under ``torch.profiler`` (device activity only), for the device time of
the whole burst and the device's idle share against its wall.  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json
import queue as queue_mod
import time

import numpy as np

# The reference submitter's defaults (``ray_tpu/_private/config.py``,
# ``direct_task_submitter.py``): at most 10 lease requests in flight per
# scheduling class, 10 entries a batch, a backlogged class retried after
# 20 ms.
MAX_PENDING_PER_CLASS = 10
LEASE_BATCH = 10
BACKLOG_RETRY_S = 0.020
# R3's lease count: the configuration's 100,000, nothing cut.
R3_LEASES = 100_000
# A burst not resolved within this wall has stalled.
WALL_S = 400.0
N_RAYLETS = 64


def bench_names(total):
    """Column names of the bench fleet's resource rows."""
    return ["CPU", "memory", "TPU", "GPU"] + [
        f"custom_{r}" for r in range(4, total.shape[1])]


def row_dict(names, row):
    return {names[r]: float(row[r]) for r in range(len(names)) if row[r] > 0}


def make_specs(names, demand, classes):
    """One no-op ``TaskSpec`` a lease, its resources ``demand[class]``."""
    from ray_tpu_torch._private import ids, task_spec
    job, owner = ids.JobID.from_int(1), ids.WorkerID.from_random()
    fn = ids.FunctionID.from_random()
    rows = [row_dict(names, demand[c]) for c in range(demand.shape[0])]
    return [task_spec.make_spec(job_id=job, owner_id=owner, function_id=fn,
                                function_name="noop", args=[],
                                num_returns=1, resources=rows[int(c)])
            for c in classes]


def raylet_errors(raylet):
    """Handler failures on the raylet's loop and its tick's error
    counters (all 0 on a clean run)."""
    ts = raylet.cluster_task_manager.tick_stats
    return (sum(h["errors"] for h in raylet.loop.handler_stats.values()) +
            ts["jnp_fallbacks"] + ts["device_errors"] + ts["dispatch_errors"])


def cluster_burst(n_leases=R3_LEASES, device="cuda"):
    """One R3 burst (module docstring).  Returns its numbers; raises
    AssertionError when a lease is unresolved after ``WALL_S`` (with the
    raylets the open leases were last sent to), granted more than once,
    or a raylet or solver counted an error."""
    from ray_tpu_torch._private.cluster import Cluster
    from ray_tpu_torch.scheduler import bench as sb
    rng = np.random.default_rng(7)
    _, total, demand, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    classes = rng.integers(0, 64, size=n_leases)
    specs = make_specs(names, demand, classes)
    cluster = Cluster(device=device)
    try:
        for i in range(N_RAYLETS):
            cluster.add_node(row_dict(names, total[i]), node_name=f"r3-{i}")
        head = cluster.head_node
        inbox = queue_mod.Queue()
        unsent = collections.defaultdict(collections.deque)
        for k, c in enumerate(classes.tolist()):
            unsent[c].append(k)
        pending = collections.Counter()
        backoff_until = collections.defaultdict(float)
        first_submit = np.full(n_leases, np.nan)
        granted_at = np.full(n_leases, np.nan)
        grants = np.zeros(n_leases, np.int64)
        infeasible = np.zeros(n_leases, bool)
        last_sent = {}
        spills = rejections = backlogs = resolved = 0

        def pump(now):
            for c, q in unsent.items():
                room = MAX_PENDING_PER_CLASS - pending[c]
                if not q or room <= 0 or backoff_until[c] > now:
                    continue
                keys = [q.popleft() for _ in range(min(room, len(q),
                                                       LEASE_BATCH))]
                pending[c] += len(keys)
                for k in keys:
                    last_sent[k] = head.node_name
                    if np.isnan(first_submit[k]):
                        first_submit[k] = time.perf_counter()
                head.request_worker_lease_batch(
                    [specs[k] for k in keys],
                    lambda rep, keys=keys: inbox.put((keys, rep["results"])))

        def back_to_queue(key, c):
            pending[c] -= 1
            unsent[c].appendleft(key)

        t_start = time.perf_counter()
        deadline = time.monotonic() + WALL_S
        while resolved < n_leases:
            pump(time.monotonic())
            if time.monotonic() > deadline:
                open_keys = np.flatnonzero((grants == 0) & ~infeasible)
                where = collections.Counter(last_sent[int(k)]
                                            for k in open_keys)
                raise AssertionError(
                    f"R3: {len(open_keys)} leases unresolved after {WALL_S} "
                    f"s, last sent to {dict(where.most_common(8))}")
            try:
                keys, results = inbox.get(timeout=BACKLOG_RETRY_S)
            except queue_mod.Empty:
                continue
            now = time.perf_counter()
            for key, res in zip(keys, results):
                c = int(classes[key])
                if "worker" in res:
                    grants[key] += 1
                    granted_at[key] = now
                    pending[c] -= 1
                    resolved += 1
                    res["raylet"].return_worker(res["worker"])
                elif "retry_at" in res:
                    spills += 1
                    target = cluster.raylet(res["retry_at"])
                    if target is None:
                        back_to_queue(key, c)
                        continue
                    last_sent[key] = target.node_name
                    target.request_worker_lease(
                        specs[key],
                        lambda r, key=key: inbox.put(([key], [r])),
                        grant_or_reject=True)
                elif res.get("grant_or_reject"):
                    rejections += 1
                    back_to_queue(key, c)
                elif res.get("infeasible"):
                    infeasible[key] = True
                    pending[c] -= 1
                    resolved += 1
                elif res.get("backlog"):
                    backlogs += 1
                    back_to_queue(key, c)
                    backoff_until[c] = time.monotonic() + BACKLOG_RETRY_S
                else:
                    raise AssertionError(f"R3: lease {key} rejected: {res}")
        wall = time.perf_counter() - t_start
        feasible = ~infeasible
        errors = {r.node_name: raylet_errors(r) for r in cluster.raylets()}
        if any(errors.values()):
            raise AssertionError(f"R3: errors on the raylets {errors}")
        if not (grants[feasible] == 1).all() or grants[infeasible].any():
            raise AssertionError(
                f"R3: grants per feasible lease {np.bincount(grants)}")
        solver_stats = collections.Counter()
        batched_at = 0
        for r in cluster.raylets():
            s = r.cluster_task_manager._solver
            if s is not None:
                solver_stats.update(s.stats)
                batched_at += s.stats["ticks"] > 0
        if solver_stats["fallbacks"]:
            raise AssertionError(f"R3: solvers fell back {solver_stats}")
        lat = (granted_at - first_submit)[feasible] * 1e3
        return {"leases": n_leases, "granted": int(grants.sum()),
                "infeasible": int(infeasible.sum()),
                "leases_per_s": int(feasible.sum()) / wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "spillbacks": spills, "rejections": rejections,
                "backlog_replies": backlogs, "wall_s": wall,
                "raylets_with_batched_ticks": batched_at,
                "solver": dict(solver_stats)}
    finally:
        cluster.shutdown()


def _profiled_burst(torch, n_leases, device):
    """One burst under ``torch.profiler``: its numbers, plus the device
    time summed over every operation the card ran and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = cluster_burst(n_leases, device)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the profiler saw no device operation")
    device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    fill_ms = sum(e.time_range.elapsed_us() for e in ops
                  if "class_fill" in e.name) / 1e3
    out.update(device_ms=device_ms, class_fill_device_ms=fill_ms,
               device_ops=len(ops),
               idle_share=max(0.0, 1 - device_ms / (out["wall_s"] * 1e3)))
    return out


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.tools.timing import card

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--leases", type=int, default=R3_LEASES)
    parser.add_argument("--profile", action="store_true",
                        help="one more run under torch.profiler")
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    args = parser.parse_args(argv)
    if args.profile and args.device == "cpu":
        parser.error("--profile traces the card")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_cluster: needs a CUDA device")
        print(card(), flush=True)
    failed = 0
    for run in range(args.runs):
        cf.class_fill.launches = 0
        try:
            out = cluster_burst(args.leases, args.device)
            out["launches"] = cf.class_fill.launches
            print(json.dumps({"run": run, "ok": True, **out}), flush=True)
        except AssertionError as e:
            failed += 1
            print(json.dumps({"run": run, "ok": False, "error": str(e)}),
                  flush=True)
    if args.profile:
        cf.class_fill.launches = 0
        out = _profiled_burst(torch, args.leases, args.device)
        out["launches"] = cf.class_fill.launches
        print(json.dumps({"run": "profiled", "ok": True, **out}), flush=True)
    print(json.dumps({"runs": args.runs, "failed": failed,
                      "leases": args.leases}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
