"""G1 and A1: placement groups and the autoscaler's loop through
``ray_tpu_torch`` on the card.

    python -m ray_tpu_torch.tools.profile_groups [--phase g1|a1|both]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``groups`` (G1): ``init(_cluster=...)`` on a ``Cluster`` of R3's
  64 raylets (``profile_cluster``'s node shapes).  Placement groups are
  created one after another, each waited before the next: four each of
  PACK, SPREAD, STRICT_PACK and STRICT_SPREAD of four ``{"CPU": 1}``
  bundles, then one SPREAD group of 32 (a 32-worker job).  The 64 nodes
  reach ``pg_kernel_min_nodes``, so every solve is the device bundle
  solve; one broadcast round after each group keeps the GCS-side view
  current, so the run is the same on any device.  Every group must be
  CREATED; one task into each bundle runs on that bundle's node and
  sees the group as ``get_current_placement_group()``.  The groups'
  formatted resources widen every raylet's view past 64 columns: the
  head's batched tick places the tasks through ``class_fill`` at that
  ``R_pad``.  After every group is removed, ``available_resources()``
  equals its value before the first.  Reported: ms from
  ``placement_group()`` to the end of ``wait()`` (p50, p99), ms per
  bundle solve, tasks/s into bundles, the widest ``R_pad`` a raylet's
  solver held, the solvers' full uploads, and the bundle solve's
  counters; no raylet may count an error.
* ``autoscaler_loop`` (A1): a ``Monitor`` with ``FakeMultiNodeProvider``
  on a ``Cluster`` with a 1-CPU head and ``tests/test_autoscaler.py``'s
  worker type (``{"CPU": 4, "bigmem": 1}``), ``max_workers`` 64.  Load:
  a burst of 2,048 tasks of 50 ms that need ``bigmem`` (64 shapes,
  0.0125-0.8 of it: each shape is a scheduling class, and the head
  holds about one pending lease a class while the class cannot run,
  so 64 shapes make the nodes the autoscaler weighs times the demands
  pass ``autoscaler_kernel_min_cells``), one STRICT_SPREAD group
  of 8 ``{"CPU": 1}`` bundles that the head alone cannot hold, and one
  ``request_resources`` of 8 worker shapes.  The first round waits for
  a lease of every shape at the head.  Each round reads the load
  (``update_load_metrics``), asks a ``device="cpu"`` twin of the
  autoscaler what it would launch from the same provider and load
  metrics, then runs the monitor's autoscaler on the device, whose
  launches must be the twin's.  Every task must finish on a launched
  node and the group must be placed; then the group is removed, the
  request withdrawn and the idle timeout set to 0, and the rounds go on
  until the workers are terminated down to ``min_workers`` (0).
  Reported: ms per ``update_all``, the autoscaler's device solves (each
  one ``class_fill`` launch on the card) and the raylets' batched ticks,
  nodes launched and terminated, and seconds from the burst to the last
  result.

``device="cpu"`` rehearses a phase on the plain class fill.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ray_tpu_torch.tools.profile_cluster import (N_RAYLETS, bench_names,
                                                 row_dict)
from ray_tpu_torch.tools.profile_tasks import (_check_clean, _percentiles,
                                              _tick_totals)

G1_GROUPS = ([(s, 4) for s in ("PACK", "SPREAD", "STRICT_PACK",
                               "STRICT_SPREAD") for _ in range(4)] +
             [("SPREAD", 32)])
A1_TYPES = {
    "head": {"resources": {"CPU": 1}, "max_workers": 0},
    "worker": {"resources": {"CPU": 4, "bigmem": 1}, "min_workers": 0,
               "max_workers": 64},
}
A1_TASKS = 2048
A1_SHAPES = 64
# Each A1 task works this long, so that the burst's demand outlives the
# first rounds.
A1_TASK_S = 0.05
A1_MAX_WORKERS = 64
WALL_S = 300.0


def _where(_index):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import get_current_placement_group
    pg = get_current_placement_group()
    return rt.get_runtime_context().get_node_id(), \
        pg.id.hex() if pg is not None else None


class _Runtime:
    """``init`` on a fresh ``Cluster`` whose node stores spill
    under a temporary directory (and whose GCS journals to a file there
    with ``file_gcs``); ``close`` shuts both down."""

    def __init__(self, device, file_gcs=False, system_config=None):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private.cluster import Cluster
        from ray_tpu_torch._private.config import initialize_config
        self.rt = rt
        self.temp_dir = tempfile.mkdtemp(prefix="ray_tpu_torch-groups-")
        self.system_config = {"temp_dir": self.temp_dir,
                              **(system_config or {})}
        initialize_config(self.system_config)
        self.cluster = Cluster(
            device=device, gcs_storage_path=os.path.join(
                self.temp_dir, "gcs.bin") if file_gcs else None)

    def start(self):
        self.rt.init(_cluster=self.cluster,
                     _system_config=self.system_config)

    def close(self):
        from ray_tpu_torch._private.config import initialize_config
        try:
            if self.rt.is_initialized():
                self.rt.shutdown()
            else:
                self.cluster.shutdown()
        finally:
            initialize_config()
            shutil.rmtree(self.temp_dir, ignore_errors=True)


def _bundles_idle(cluster) -> bool:
    """Whether every bundle's formatted resources are all available, on
    the raylets' own ledgers (the GCS view's totals, which
    ``cluster_resources`` reads, never gain a bundle's columns, as in the
    reference)."""
    for raylet in cluster.raylets():
        res = raylet.local_resources
        total, avail = res.to_float_dict("total"), res.to_float_dict()
        if any(avail.get(k) != v for k, v in total.items()
               if "_group_" in k):
            return False
    return True


def groups(device="cuda"):
    """G1 (module docstring)."""
    from ray_tpu_torch.scheduler import bench as sb
    from ray_tpu_torch.scheduler import bundle_packing
    from ray_tpu_torch.util import (placement_group, placement_group_table,
                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy
    rng = np.random.default_rng(7)
    _, total, _, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    env = _Runtime(device)
    solve_ms = []
    pack = bundle_packing.pack_bundles

    def timed_pack(*args, **kw):
        t0 = time.perf_counter()
        try:
            return pack(*args, **kw)
        finally:
            solve_ms.append((time.perf_counter() - t0) * 1e3)
    stats0 = dict(bundle_packing.kernel_stats)
    bundle_packing.pack_bundles = timed_pack
    try:
        cluster = env.cluster
        for i in range(N_RAYLETS):
            cluster.add_node(row_dict(names, total[i]), node_name=f"r3-{i}")
        env.start()
        rt = env.rt
        node_name = {r.node_id.hex(): r.node_name for r in cluster.raylets()}
        before = rt.available_resources()
        pgs, create_ms = [], []
        for strategy, n in G1_GROUPS:
            t0 = time.perf_counter()
            pg = placement_group([{"CPU": 1}] * n, strategy=strategy)
            if not pg.wait(60):
                raise AssertionError(f"G1: a {strategy} group of {n} was "
                                     f"not created: "
                                     f"{placement_group_table(pg)}")
            create_ms.append((time.perf_counter() - t0) * 1e3)
            cluster.broadcast_now()
            pgs.append(pg)
        placements = []
        for pg in pgs:
            info = placement_group_table(pg)
            if info["state"] != "CREATED":
                raise AssertionError(f"G1: group state {info['state']}")
            placements.append([node_name[info["bundle_nodes"][i]]
                               for i in range(len(info["bundle_nodes"]))])
        where = rt.remote(num_cpus=1)(_where)
        t0 = time.perf_counter()
        refs, expect = [], []
        for pg, nodes in zip(pgs, placements):
            for i, node in enumerate(nodes):
                refs.append(where.options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=i)).remote(len(refs)))
                expect.append((node, pg.id.hex()))
        got = rt.get(refs, timeout=WALL_S)
        tasks_s = time.perf_counter() - t0
        wrong = [(k, node_name.get(n, n), g, e) for k, ((n, g), e) in
                 enumerate(zip(got, expect)) if (node_name.get(n), g) != e]
        if wrong:
            raise AssertionError(f"G1: tasks off their bundles: "
                                 f"{wrong[:5]} ({len(wrong)} of "
                                 f"{len(refs)})")
        ticks, bad = _tick_totals(cluster)
        _check_clean("G1", bad)
        solvers = [r.cluster_task_manager._solver for r in cluster.raylets()]
        r_pad = max((s.pads()[1] for s in solvers
                     if s is not None and s.pads() is not None), default=0)
        full_syncs = sum(s.stats["full_syncs"] for s in solvers
                         if s is not None)
        columns = max(len(r.cluster_view.columns) for r in cluster.raylets())
        # A result is sealed before its worker's lease returns: wait for
        # every bundle's resources to come back before the removal.
        deadline = time.monotonic() + 30
        while not _bundles_idle(cluster):
            if time.monotonic() > deadline:
                raise AssertionError("G1: bundle leases never returned")
            time.sleep(0.01)
        for pg in pgs:
            remove_placement_group(pg)
        cluster.broadcast_now()
        after = rt.available_resources()
        if after != before:
            raise AssertionError(f"G1: resources not restored after the "
                                 f"groups were removed: {before} -> "
                                 f"{after}")
        stats = {k: bundle_packing.kernel_stats[k] - stats0.get(k, 0)
                 for k in bundle_packing.kernel_stats}
        if stats["kernel_placements"] < 1 or stats["kernel_errors"]:
            raise AssertionError(f"G1: bundle solve counters {stats}")
        create_p50, create_p99 = _percentiles(create_ms)
        return {"groups": len(pgs), "bundles": len(refs),
                "placements": placements,
                "create_wait_p50_ms": create_p50,
                "create_wait_p99_ms": create_p99,
                "bundle_solves": len(solve_ms),
                "bundle_solve_ms": float(np.mean(solve_ms)),
                "tasks_per_s": len(refs) / tasks_s,
                "view_columns": columns, "r_pad": r_pad,
                "full_syncs": full_syncs,
                "batched_ticks": sum(ticks.values()),
                "bundle_stats": stats}
    finally:
        bundle_packing.pack_bundles = pack
        env.close()


def _bigmem_task(_index):
    import ray_tpu_torch as rt
    time.sleep(A1_TASK_S)
    return rt.get_runtime_context().get_node_id()


def _worker_count(monitor):
    from ray_tpu_torch.autoscaler.node_provider import (NODE_KIND_WORKER,
                                                        TAG_NODE_KIND)
    return len(monitor.provider.non_terminated_nodes(
        {TAG_NODE_KIND: NODE_KIND_WORKER}))


def autoscaler_loop(device="cuda", n_tasks=A1_TASKS):
    """A1 (module docstring)."""
    from ray_tpu_torch.autoscaler import (Monitor, StandardAutoscaler,
                                          request_resources)
    from ray_tpu_torch.autoscaler import resource_demand_scheduler as rds
    from ray_tpu_torch.util import placement_group, remove_placement_group
    env = _Runtime(device)
    monitor = None
    try:
        head = env.cluster.add_node({"CPU": 1.0}, node_name="head")
        env.start()
        rt = env.rt
        monitor = Monitor(env.cluster, A1_TYPES, max_workers=A1_MAX_WORKERS,
                          idle_timeout_minutes=60, device=device)
        twin = StandardAutoscaler(monitor.provider, monitor.load_metrics,
                                  A1_TYPES, max_workers=A1_MAX_WORKERS,
                                  idle_timeout_minutes=60, device="cpu")
        rounds = {"ms": [], "solves": 0, "launched": {}, "mismatch": []}

        def one_round():
            monitor.update_load_metrics()
            want = twin.nodes_to_launch()
            solves = rds.kernel_stats["kernel_solves"]
            t0 = time.perf_counter()
            got = monitor.autoscaler.update()
            rounds["ms"].append((time.perf_counter() - t0) * 1e3)
            rounds["solves"] += rds.kernel_stats["kernel_solves"] - solves
            if got != want:
                rounds["mismatch"].append((len(rounds["ms"]), got, want))
            for t, c in got.items():
                rounds["launched"][t] = rounds["launched"].get(t, 0) + c

        pg = placement_group([{"CPU": 1}] * 8, strategy="STRICT_SPREAD")
        request_resources(bundles=[A1_TYPES["worker"]["resources"]] * 8)
        shapes = [rt.remote(num_cpus=0, resources={
            "bigmem": 0.0125 * (k + 1)})(_bigmem_task)
            for k in range(A1_SHAPES)]
        t_burst = time.perf_counter()
        refs = [shapes[i % A1_SHAPES].remote(i) for i in range(n_tasks)]
        # The first round reads the burst once a lease of every shape
        # waits at the head.
        deadline = time.monotonic() + WALL_S
        while len(head.cluster_task_manager.resource_load()) < A1_SHAPES:
            if time.monotonic() > deadline:
                raise AssertionError("A1: the burst never reached the head")
            time.sleep(0.01)
        pending = list(refs)
        while pending or not pg.wait(0):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"A1: {len(pending)} tasks left, group placed "
                    f"{pg.wait(0)}, after {WALL_S} s; "
                    f"{monitor.autoscaler.summary()}")
            one_round()
            time.sleep(0.2)
            _done, pending = rt.wait(pending, num_returns=len(pending),
                                     timeout=0)
        nodes = rt.get(refs)
        burst_s = time.perf_counter() - t_burst
        head_id = head.node_id.hex()
        on_head = sum(n == head_id for n in nodes)
        if on_head:
            raise AssertionError(f"A1: {on_head} tasks ran on the head")
        peak_workers = _worker_count(monitor)
        # The raylets' batched ticks, before the drain removes workers.
        ticks, _ = _tick_totals(env.cluster)
        remove_placement_group(pg)
        request_resources(bundles=[])
        monitor.autoscaler.idle_timeout_s = 0.0
        twin.idle_timeout_s = 0.0
        drain_rounds = 0
        while _worker_count(monitor) > A1_TYPES["worker"]["min_workers"]:
            if time.monotonic() > deadline + 60:
                raise AssertionError(
                    f"A1: {_worker_count(monitor)} workers left after the "
                    f"drain; {monitor.autoscaler.summary()}")
            one_round()
            drain_rounds += 1
            time.sleep(0.05)
        if rounds["mismatch"]:
            raise AssertionError(f"A1: rounds whose launches differ from "
                                 f"the CPU twin's: {rounds['mismatch']}")
        _, bad = _tick_totals(env.cluster)
        _check_clean("A1", bad)
        ms_p50, _ = _percentiles(rounds["ms"])
        return {"tasks": n_tasks, "burst_to_last_result_s": burst_s,
                "rounds": len(rounds["ms"]), "drain_rounds": drain_rounds,
                "update_ms_mean": float(np.mean(rounds["ms"])),
                "update_ms_p50": ms_p50,
                "update_ms_max": float(np.max(rounds["ms"])),
                "autoscaler_solves": rounds["solves"],
                "batched_ticks": sum(ticks.values()),
                "launched": rounds["launched"],
                "nodes_launched": monitor.autoscaler.num_launches,
                "nodes_terminated": monitor.autoscaler.num_terminations,
                "peak_workers": peak_workers,
                "workers_left": _worker_count(monitor),
                "distinct_nodes_used": len(set(nodes))}
    finally:
        if monitor is not None:
            monitor.stop()
        env.close()


PHASES = {"g1": groups, "a1": autoscaler_loop}


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=sorted(PHASES) + ["both"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_groups: needs a CUDA device")
        print(card(), flush=True)
    names = sorted(PHASES) if args.phase == "both" else [args.phase]
    for name in names:
        t0 = time.perf_counter()
        out = PHASES[name](args.device)
        check_no_threads(name.upper())
        print(json.dumps({"phase": name.upper(),
                          "wall_s": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
