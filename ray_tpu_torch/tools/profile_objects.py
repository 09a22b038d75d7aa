"""O1-O5: the object plane through ``ray_tpu_torch.init`` on the card.

    python -m ray_tpu_torch.tools.profile_objects [--phase o1|...|all]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``large_objects`` (O1) is the JAX package's ``bench_runtime.py``
  ``large_object_roundtrip`` row at its full 1 GiB: on one head raylet,
  a cold put, then the least of 3 warm puts (ms, and the bytes the put
  copied: none while the store is python-held, which keeps views of the
  caller's buffers); the get's view (ms) and the get streamed into a
  pre-faulted buffer (GB/s); the bytes equal to what was put.  Then
  ``tests/test_basic.py``'s large argument and return, at 16 MiB each:
  a task takes a 16 MiB literal argument (which the submit promotes to a
  node-store object) and returns a 16 MiB array, both values checked.
* ``broadcast`` (O2) is ``bench_runtime.py``'s ``broadcast_object`` row
  at its full 256 MiB to 8 raylets (relay on, by default): one put, then
  every raylet pulls it at once, cold and again warm (the replicas
  dropped in between); GB/s, the bytes each source served, relay pulls
  and cross-node bytes; every replica byte-equal to the origin.
* ``spilling`` (O3) is ``tests/test_spill.py:47-66``'s workload at a
  size users spill: one raylet with a 1 GiB store, 64 seeded arrays of
  32 MiB (2 GiB) put, then each read back equal; objects and bytes
  spilled and restored, spill batches and files, create-queue waits,
  and seconds per GiB each way.  Its spill directory is a temporary
  directory the phase removes, even when it fails.
* ``reconstruction`` (O4) is ``tests/test_failure.py:71-91`` and
  ``:104-133`` at their shapes: an 8 MB return that only its raylet
  holds is recomputed after that raylet is removed (seconds to
  recover); with lineage pinning off the same loss raises
  ``ObjectLostError`` with the reference's message, promptly.
* ``locality`` (O5) is ``tests/test_unified_scheduler.py:377-417`` at
  its shape: 2 raylets, a 4.8 MB object on B and 4 consumers of one
  function, all on B within 3 attempts with no cross-node bytes; then
  the same on R3's 64-raylet cluster (``profile_cluster``'s node
  shapes), the object on one named raylet and a burst of consumers as
  large as its CPUs: the share that ran there and the cross-node bytes.
  A one-class burst is leased one task at a time and never reaches the
  batched tick, so its cost launches are reported (0).  After each, on
  the same cluster, a probe gives every consumer a class of its own:
  the burst meets one batched tick, whose solver counts a cost tick and
  launches ``class_fill`` with a non-zero cost (``tb.class_fill`` is
  wrapped for the phase: a call on the card that returns is one launch,
  and its cost is read after it).  No raylet counts a device error.

Each phase reports the raylets' ``class_fill`` launches and checks that
they counted no error; ``check_no_threads`` after a phase checks that no
thread of the port outlived its shutdown.  ``device="cpu"``
rehearses a phase on the plain class fill (launches stay 0).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

from ray_tpu_torch.tools.profile_cluster import (N_RAYLETS, bench_names,
                                                 row_dict)
from ray_tpu_torch.tools.profile_tasks import _check_clean, _tick_totals

GIB = 1024 ** 3
MIB = 1024 ** 2


def _pattern(nbytes: int, seed: int) -> np.ndarray:
    """``nbytes`` seeded bytes: one random MiB tiled, plus ``seed``."""
    block = np.random.default_rng(seed).integers(0, 256, MIB, dtype=np.uint8)
    reps = -(-nbytes // MIB)
    return np.tile(block, reps)[:nbytes]


def _flip(a):
    return a ^ np.uint8(0xFF)


def _sum(a):
    return float(a.sum())


def _ones_f32(n):
    return np.ones(n, dtype=np.float32)


def _first_and_node(x):
    import ray_tpu_torch as rt
    return float(x[0]), rt.get_runtime_context().get_node_id()


def _launches():
    from ray_tpu_torch.ops import class_fill as cf
    return cf.class_fill.launches


# -- O1 -----------------------------------------------------------------------

def large_objects(device="cuda", gib=1.0, arg_mib=16):
    """O1 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    rt.init(device=device)
    try:
        cluster = global_worker().cluster
        launches0 = _launches()
        data = _pattern(int(gib * GIB), 1)

        def one_put():
            t0 = time.perf_counter()
            ref = rt.put(data)
            return ref, time.perf_counter() - t0

        ref, cold_dt = one_put()
        t0 = time.perf_counter()
        out = rt.get(ref)
        view_dt = time.perf_counter() - t0
        # The python-held store keeps views of the caller's buffers: a
        # put copies nothing until the native segment (A.4b.2b) exists.
        put_copied = 0 if np.shares_memory(out, data) else data.nbytes
        scratch = np.empty_like(data)
        scratch.fill(0)
        t0 = time.perf_counter()
        np.copyto(scratch, out)
        read_dt = time.perf_counter() - t0
        if out.nbytes != data.nbytes or not np.array_equal(scratch, data):
            raise AssertionError("O1: the get's bytes differ from the put's")
        in_store = cluster.head_node.object_store.contains(ref.object_id())
        del out, scratch, ref
        gc.collect()
        put_dts = []
        for _ in range(3):
            ref2, dt = one_put()
            put_dts.append(dt)
            del ref2
            gc.collect()
        del data
        gc.collect()

        arg = _pattern(arg_mib * MIB, 2)
        t0 = time.perf_counter()
        ret = rt.remote(_flip).remote(arg)
        spec = global_worker().core_worker.task_manager.get_spec(
            ret.task_id())
        promoted = not spec.args[0].is_inline
        back = rt.get(ret, timeout=120)
        task_s = time.perf_counter() - t0
        ret_located = bool(cluster.object_directory.get_locations(
            ret.object_id()))
        if not promoted or not ret_located:
            raise AssertionError(f"O1: the {arg_mib} MiB argument promoted "
                                 f"{promoted}, the return in a node store "
                                 f"{ret_located}")
        if back.nbytes != arg.nbytes or not np.array_equal(back,
                                                           _flip(arg)):
            raise AssertionError("O1: the task's return is wrong")
        if rt.get(rt.remote(_sum).remote(arg)) != float(arg.sum()):
            raise AssertionError("O1: the promoted argument read wrong")
        ticks, bad = _tick_totals(cluster)
        _check_clean("O1", bad)
        return {"gib": gib, "in_node_store": in_store,
                "cold_put_ms": cold_dt * 1e3,
                "put_ms": min(put_dts) * 1e3,
                "put_bytes_copied": put_copied,
                "put_s": put_dts, "get_view_ms": view_dt * 1e3,
                "get_gbps": gib / (view_dt + read_dt),
                "arg_mib": arg_mib, "task_s": task_s,
                "batched_ticks": sum(ticks.values()),
                "launches": _launches() - launches0}
    finally:
        rt.shutdown()


# -- O2 -----------------------------------------------------------------------

def broadcast(device="cuda", mb=256, n_nodes=8):
    """O2 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.object_store import entry_value
    from ray_tpu_torch._private.worker import global_worker
    rt.init(device=device)
    try:
        cluster = global_worker().cluster
        launches0 = _launches()
        per_node_store = max(4 * mb, 64) * MIB
        nodes = [cluster.add_node({}, node_name=f"o2-{i}",
                                  object_store_memory=per_node_store)
                 for i in range(n_nodes)]
        head = cluster.head_node
        data = _pattern(mb * MIB, 3)
        gib = data.nbytes / GIB
        warm = rt.put(data)
        del warm
        gc.collect()
        t0 = time.perf_counter()
        ref = rt.put(data)
        put_dt = time.perf_counter() - t0
        oid = ref.object_id()

        def stores():
            return [head] + nodes

        def broadcast_once():
            done = threading.Event()
            pending = [len(nodes)]
            failures = [0]
            lock = threading.Lock()

            def cb(ok):
                with lock:
                    failures[0] += not ok
                    pending[0] -= 1
                    if pending[0] == 0:
                        done.set()

            served0 = [r.object_store.stats["outbound_served_bytes"]
                       for r in stores()]
            t0 = time.perf_counter()
            for node in nodes:
                node.object_manager.pull_async(oid, cb)
            if not done.wait(timeout=600):
                raise AssertionError("O2: broadcast pulls timed out")
            dt = time.perf_counter() - t0
            if failures[0]:
                raise AssertionError(f"O2: {failures[0]} pulls failed")
            served = [r.object_store.stats["outbound_served_bytes"] - s
                      for r, s in zip(stores(), served0)]
            return dt, served

        def counters():
            return (sum(n.object_manager.stats["cross_node_fetch_bytes"]
                        for n in nodes),
                    sum(n.object_manager.stats["relay_pulls"]
                        for n in nodes))

        cross0, relay0 = counters()
        cold_dt, cold_served = broadcast_once()
        cross1, relay1 = counters()
        for node in nodes:
            value = entry_value(node.object_store.get(oid))
            if not np.array_equal(value, data):
                raise AssertionError(f"O2: {node.node_name}'s replica "
                                     "differs from the origin")
            del value
            node.object_store.delete(oid)
            cluster.object_directory.remove_location(oid, node.node_id)
        warm_dt, warm_served = broadcast_once()
        cross2, relay2 = counters()
        for node in nodes:
            if not np.array_equal(entry_value(node.object_store.get(oid)),
                                  data):
                raise AssertionError(f"O2: {node.node_name}'s warm replica "
                                     "differs from the origin")
        names = ["head"] + [n.node_name for n in nodes]
        out = {"mib": mb, "nodes": n_nodes, "put_ms": put_dt * 1e3,
               "cold_fetch_gbps": gib * n_nodes / cold_dt,
               "fetch_gbps": gib * n_nodes / warm_dt,
               "cold_fetch_s": cold_dt, "fetch_s": warm_dt,
               "served_cold": dict(zip(names, cold_served)),
               "served_warm": dict(zip(names, warm_served)),
               "relay_pulls": [relay1 - relay0, relay2 - relay1],
               "cross_node_fetch_bytes": [cross1 - cross0, cross2 - cross1],
               "object_bytes": head.object_store.get(oid).size,
               "launches": _launches() - launches0}
        del ref
        _check_clean("O2", _tick_totals(cluster)[1])
        for node in nodes:
            cluster.remove_node(node)
        return out
    finally:
        rt.shutdown()


# -- O3 -----------------------------------------------------------------------

def spilling(device="cuda", store_gib=1, n_objects=64, mib=32):
    """O3 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    tmp = tempfile.mkdtemp(prefix="profile_objects_")
    try:
        rt.init(device=device, object_store_memory=int(store_gib * GIB),
                _system_config={"temp_dir": tmp})
        try:
            cluster = global_worker().cluster
            head = cluster.head_node
            store, spiller = head.object_store, head.local_object_manager
            total_gib = n_objects * mib / 1024
            t0 = time.perf_counter()
            refs = [rt.put(_pattern(mib * MIB, 100 + i))
                    for i in range(n_objects)]
            put_s = time.perf_counter() - t0
            files_after_puts = sum(
                1 for f in os.listdir(store.spill_dir)
                if f.startswith("batch-"))
            spilled = dict(store.stats)
            t0 = time.perf_counter()
            for i, ref in enumerate(refs):
                if not np.array_equal(rt.get(ref),
                                      _pattern(mib * MIB, 100 + i)):
                    raise AssertionError(f"O3: object {i} read back wrong")
            get_s = time.perf_counter() - t0
            st = store.stats
            if spilled["spilled_objects"] < 1 or st["restored_objects"] < 1:
                raise AssertionError(f"O3: nothing spilled or restored: {st}")
            _check_clean("O3", _tick_totals(cluster)[1])
            return {"store_gib": store_gib, "objects": n_objects,
                    "object_mib": mib,
                    "spilled_objects": st["spilled_objects"],
                    "spilled_bytes": st["spilled_bytes"],
                    "restored_objects": st["restored_objects"],
                    "restored_bytes": st["restored_bytes"],
                    "spill_batches": spiller.stats["spill_batches"],
                    "spill_files_after_puts": files_after_puts,
                    "queued_creates": st["queued_creates"],
                    "create_queue_wait_ms": st["create_queue_wait_ms"],
                    "create_queue_timeouts": st["create_queue_timeouts"],
                    "spill_errors": st["spill_errors"],
                    "put_s_per_gib": put_s / total_gib,
                    "get_s_per_gib": get_s / total_gib}
        finally:
            rt.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- O4 -----------------------------------------------------------------------

def _lost_copy(rt, cluster, max_retries):
    """An 8 MB return only its raylet holds, and that raylet removed
    (with a replacement that can run the task).  Returns the ref and the
    time of the removal."""
    producer = cluster.add_node({"CPU": 1.0, "prod": 1.0},
                                node_name="o4-producer")
    produce = rt.remote(resources={"prod": 0.1}, num_cpus=0,
                        max_retries=max_retries)(_ones_f32)
    ref = produce.remote(2_000_000)
    ready, _ = rt.wait([ref], timeout=30)
    if not ready or not producer.object_store.contains(ref.object_id()):
        raise AssertionError("O4: the producer never held its return")
    cluster.add_node({"CPU": 1.0, "prod": 1.0}, node_name="o4-spare")
    t0 = time.perf_counter()
    cluster.remove_node(producer)
    return ref, t0


def reconstruction(device="cuda"):
    """O4 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private.cluster import Cluster
    from ray_tpu_torch._private.worker import global_worker
    out = {}
    for pinning in (True, False):
        cluster = Cluster(device=device)
        cluster.add_node({"CPU": 1.0}, node_name="head")
        rt.init(_cluster=cluster,
                _system_config={"lineage_pinning_enabled": pinning})
        try:
            ref, t0 = _lost_copy(rt, cluster, max_retries=2)
            if pinning:
                value = rt.get(ref, timeout=30)
                out["recover_s"] = time.perf_counter() - t0
                if value.sum() != 2_000_000:
                    raise AssertionError("O4: the recomputed value is wrong")
                out["reconstructions"] = global_worker().core_worker \
                    .metrics["lineage_reconstructions"]
                if out["reconstructions"] < 1:
                    raise AssertionError("O4: nothing was reconstructed")
                _check_clean("O4", _tick_totals(cluster)[1])
                continue
            try:
                rt.get(ref, timeout=20)
            except exceptions.ObjectLostError as e:
                out["lost_s"] = time.perf_counter() - t0
                out["lost_message"] = str(e)
            else:
                raise AssertionError("O4: an unrecoverable loss returned")
            if out["lost_s"] >= 10 or "all copies lost and lineage " \
                    "reconstruction unavailable" not in out["lost_message"] \
                    or "lineage=not pinned" not in out["lost_message"]:
                raise AssertionError(f"O4: the loss took {out['lost_s']} s "
                                     f"and said {out['lost_message']!r}")
            _check_clean("O4", _tick_totals(cluster)[1])
        finally:
            rt.shutdown()
    return out


# -- O5 -----------------------------------------------------------------------

@contextlib.contextmanager
def cost_launches():
    """Count the solvers' ``class_fill`` calls on the card that returned
    (one launch each) and those of them whose cost was not zero."""
    from ray_tpu_torch.scheduler import torch_backend as tb
    seen = {"card_calls": 0, "cost_launches": 0}
    lock = threading.Lock()
    inner = tb.class_fill

    def counted(av_t, total_t, demand, counts, accel_class, accel_node,
                spread_threshold, cost, invert, shifts):
        out = inner(av_t, total_t, demand, counts, accel_class, accel_node,
                    spread_threshold, cost, invert, shifts)
        if av_t.device.type == "cuda":
            live = bool(cost.ne(0).any())
            with lock:
                seen["card_calls"] += 1
                seen["cost_launches"] += live
        return out

    tb.class_fill = counted
    try:
        yield seen
    finally:
        tb.class_fill = inner


def _solver_totals(cluster):
    totals = {"cost_ticks": 0, "ticks": 0}
    for r in cluster.raylets():
        solver = r.cluster_task_manager._solver
        if solver is not None:
            for k in totals:
                totals[k] += solver.stats[k]
    return totals


def _locality_burst(rt, cluster, home, n_consumers, attempts, one_class):
    """A 4.8 MB object produced on ``home`` and ``n_consumers`` one-CPU
    consumers of it, up to ``attempts`` times until all ran on ``home``
    with no cross-node bytes.  Returns the last attempt's numbers.

    ``one_class`` is the source's burst: one function, one scheduling
    class.  The submitter leases a task with object arguments alone, one
    lease in flight a class, so such consumers reach a raylet one tick at
    a time, below the batched solve's depth: the lease policy and the
    greedy tick place them and the arg-locality cost never reaches
    ``class_fill``.  Otherwise each consumer is a class of its own (CPU
    demands a hundredth apart), and the burst reaches the holder's tick
    together, whose batched solve builds the locality cost."""
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    def fetched():
        return sum(r.object_manager.stats["cross_node_fetch_bytes"]
                   for r in cluster.raylets())

    produce = rt.remote(num_cpus=0, scheduling_strategy=(
        NodeAffinitySchedulingStrategy(home.node_id, soft=False)))(
        lambda: np.ones(600_000, dtype=np.float64))
    if one_class:
        consumer = rt.remote(num_cpus=1)(_first_and_node)
        consumers = [consumer] * n_consumers
    else:
        consumers = [rt.remote(num_cpus=1 - 0.01 * k)(_first_and_node)
                     for k in range(n_consumers)]
    home_hex = home.node_id.hex()
    for attempt in range(1, attempts + 1):
        ref = produce.remote()
        rt.wait([ref], timeout=60)
        if not home.object_store.contains(ref.object_id()):
            raise AssertionError("O5: the object is not on its raylet")
        before = fetched()
        out = rt.get([c.remote(ref) for c in consumers], timeout=300)
        if [v for v, _ in out] != [1.0] * n_consumers:
            raise AssertionError("O5: a consumer read a wrong value")
        share = sum(n == home_hex for _, n in out) / n_consumers
        moved = fetched() - before
        if share == 1.0 and moved == 0:
            break
    return {"attempts": attempt, "share_on_home": share,
            "cross_node_fetch_bytes": moved, "consumers": n_consumers}


def locality(device="cuda", attempts=3):
    """O5 (module docstring).  Per shape, the source's one-class burst
    (``two``, ``r3``), then the probe of one class a consumer
    (``two_classes``, ``r3_classes``) on the same cluster; each burst's
    solver counts are its own."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.cluster import Cluster
    from ray_tpu_torch.scheduler import bench as sb
    out = {}
    rng = np.random.default_rng(7)
    _, total, _, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    shapes = {
        "two": [{"CPU": 4.0}, {"CPU": 4.0, "b": 1.0}],
        "r3": [row_dict(names, total[i]) for i in range(N_RAYLETS)],
    }
    for key, rows in shapes.items():
        cluster = Cluster(device=device)
        for i, row in enumerate(rows):
            cluster.add_node(row, node_name=f"o5-{key}-{i}")
        rt.init(_cluster=cluster)
        try:
            raylets = cluster.raylets()
            if key == "two":
                home, n = raylets[1], 4
            else:
                # The largest CPU-only raylet: the policy keeps tasks
                # that need no accelerator off accelerator nodes.
                def cpus(r):
                    t = r.local_resources.to_float_dict("total")
                    return -1.0 if t.get("TPU") or t.get("GPU") \
                        else t.get("CPU", 0.0)
                home = max(raylets, key=cpus)
                n = int(cpus(home))
            for one_class in (True, False):
                name = key if one_class else f"{key}_classes"
                totals0 = _solver_totals(cluster)
                with cost_launches() as seen:
                    launches0 = _launches()
                    res = _locality_burst(rt, cluster, home, n, attempts,
                                          one_class)
                    res.update(home=home.node_name,
                               launches=_launches() - launches0, **seen)
                res.update({k: v - totals0[k]
                            for k, v in _solver_totals(cluster).items()})
                out[name] = res
            ticks, bad = _tick_totals(cluster)
            _check_clean(f"O5 {key}", bad)
        finally:
            rt.shutdown()
        for name in ("two", "two_classes") if key == "two" else ():
            if out[name]["share_on_home"] != 1.0 or \
                    out[name]["cross_node_fetch_bytes"] != 0:
                raise AssertionError(f"O5 {name}: locality never converged "
                                     f"in {attempts} attempts: {out[name]}")
        probe = out[f"{key}_classes"]
        if probe["cost_ticks"] < 1:
            raise AssertionError(f"O5 {key}_classes: no cost tick: {probe}")
        if device != "cpu" and probe["cost_launches"] < 1:
            raise AssertionError(f"O5 {key}_classes: no class_fill launch "
                                 f"with the locality cost: {probe}")
    return out


def port_threads():
    """The names of the port's threads still alive."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]


def check_no_threads(name):
    """Raises when a thread of the port outlived the phase's shutdown."""
    left = port_threads()
    if left:
        raise AssertionError(f"{name}: threads outlived shutdown: {left}")


PHASES = {"o1": large_objects, "o2": broadcast, "o3": spilling,
          "o4": reconstruction, "o5": locality}


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="all",
                        choices=sorted(PHASES) + ["all"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_objects: needs a CUDA device")
        print(card(), flush=True)
    names = sorted(PHASES) if args.phase == "all" else [args.phase]
    for name in names:
        t0 = time.perf_counter()
        out = PHASES[name](args.device)
        check_no_threads(name.upper())
        print(json.dumps({"phase": name.upper(),
                          "wall_s": time.perf_counter() - t0, **out},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
