"""D1 and U1: the device-object plane and ``ray_tpu_torch.util`` through
``ray_tpu_torch.init`` on the card.

    python -m ray_tpu_torch.tools.profile_device [--phase d1|u1|both]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``device_objects`` (D1): one head raylet (a 4 GiB node store) and 8
  more (1 GiB each, the last 256 MiB) under ``init`` on the card.  A
  1 GiB float32 CUDA tensor is put: the put's ms with the bytes it
  copied on the device (one private copy, 1 GiB: ROADMAP C.19) and on
  the host (none); ``get`` on the head gives a CUDA tensor equal to the
  original, the same object twice, and writing into the original after
  the put leaves it unchanged.  An actor on the head takes the ref and
  gets the stored CUDA tensor (its data pointer), with no host byte
  copied.  A task on the head returns a 256 MiB CUDA tensor: a device
  entry in the head's store, no entry in the owner's memory store,
  ready for ``wait``.  A task on another raylet reads it through a pull
  and checks it bit for bit against the same seeded draw on the card,
  then the same in bf16: the GB/s of the pull's device-to-host copy
  (``copy_stats``) and of the whole read.  A small CUDA tensor passed
  by value arrives as a CPU tensor.  The 256 MiB raylet holds 128 MiB
  of device returns, then takes 256 MiB of numpy returns: the spill
  thread spills numpy entries and no device entry, and every numpy
  return reads back equal.  ``cluster_resources()["GPU"]`` is
  ``torch.cuda.device_count()``, and a ``num_gpus=1`` task sees
  ``get_gpu_ids() == [0]``.
* ``util_library`` (U1): 8 actors in a collective group, each with a
  CUDA tensor of 16 MiB float32 (4,194,304 elements, a seeded draw in
  [0.5, 1.5)), run ``allreduce`` under every ``ReduceOp`` (the
  reduction on the card: ``collective.reduce_stats``), then
  ``reducescatter`` and ``broadcast`` at the same size, ``allgather`` at
  2 MiB a rank, ``send``/``recv`` of 16 MiB around the ring, and
  ``barrier``; each result held to numpy on the same inputs (MIN, MAX,
  gather, broadcast and send exactly; SUM, PRODUCT and MEAN at rtol
  1e-6) and the ms of each; before them the reduction alone
  (``_reduce_stack`` on 8 host arrays of 16 MiB), each op's first and
  second call.  Then an ``ActorPool.map`` of 1,000 calls
  over the 8 actors, in order; a ``Queue`` (bounded at 1,000) of 10,000
  items from two producer tasks to one consumer task; a
  ``ParallelIterator`` over 8 shards; and a ``metrics`` counter, gauge
  and histogram in the registry's render.

Each phase reports the raylets' batched ticks and ``class_fill``
launches, and checks that they counted no error.  ``device="cpu"``
rehearses a phase (the GPU checks then read 0 cards).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from ray_tpu_torch.tools.profile_objects import (GIB, MIB, _launches,
                                                 check_no_threads)
from ray_tpu_torch.tools.profile_tasks import (_check_clean, _Members,
                                               _tick_totals)

D1_GIB = 1.0
D1_RETURN_MIB = 256
D1_RAYLETS = 8
D1_SPILL_MIB = 32
U1_RANKS = 8
U1_ELEMS = 4_194_304
U1_GATHER_ELEMS = 524_288
U1_POOL_CALLS = 1_000
U1_QUEUE_ITEMS = 10_000
RTOL = 1e-6
OPS = ("SUM", "PRODUCT", "MIN", "MAX", "MEAN")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _draw(n, seed, device, dtype=torch.float32):
    """``n`` seeded normal values on ``device`` (the same on every call
    on one card)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=g, device=device).to(dtype)


# -- D1 bodies (module level: exported by reference) ---------------------------

def _draw_task(n, seed, device, dtype=torch.float32):
    return _draw(n, seed, device, dtype)


def _draws(n, count, seed, device):
    return tuple(_draw(n, seed + i, device) for i in range(count))


def _check_pulled(t, n, seed, device, dtype):
    """On another raylet: the pulled host form against the same draw."""
    want = _draw(n, seed, device, dtype)
    return t.device.type, t.dtype, bool(torch.equal(t.to(device), want))


def _describe(t):
    return t.device.type, t.dtype


def _pattern_return(nbytes, seed):
    return np.random.default_rng(seed).integers(0, 255, nbytes,
                                                dtype=np.uint8)


def _gpu_ids():
    import ray_tpu_torch
    return ray_tpu_torch.get_gpu_ids()


class Reader:
    def read(self, t):
        return t.device.type, t.data_ptr()


def device_objects(device="cuda", gib=D1_GIB, ret_mib=D1_RETURN_MIB,
                   spill_mib=D1_SPILL_MIB):
    """D1 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.serialization import copy_stats
    from ray_tpu_torch._private.worker import global_worker
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="profile_device_")
    rt.init(device=device, num_cpus=8, resources={"d1_head": 100},
            object_store_memory=4 * GIB, _system_config={"temp_dir": tmp})
    try:
        cluster = global_worker().cluster
        core = global_worker().core_worker
        head = cluster.head_node
        for i in range(D1_RAYLETS):
            cluster.add_node(
                {"CPU": 2, f"d1_r{i}": 100}, node_name=f"d1_r{i}",
                object_store_memory=(8 * spill_mib * MIB
                                     if i == D1_RAYLETS - 1 else GIB))
        members = _Members(cluster.raylets())
        spill_raylet = members.raylets()[-1]
        puller = members.raylets()[1]
        on_head = {"resources": {"d1_head": 1}}
        launches0 = _launches()
        out = {"gib": gib, "return_mib": ret_mib}

        # The 1 GiB put, its private copy, and get on the head.
        n = int(gib * GIB) // 4
        x = _draw(n, 1, device)
        t = x.clone()
        _sync(device)
        host0 = copy_stats["bytes_copied"]
        dev0 = copy_stats["device_bytes_copied"]
        t0 = time.perf_counter()
        ref = rt.put(t)
        _sync(device)
        out["put_ms"] = (time.perf_counter() - t0) * 1e3
        out["put_device_bytes"] = copy_stats["device_bytes_copied"] - dev0
        out["put_host_bytes"] = copy_stats["bytes_copied"] - host0
        t.fill_(0)
        del t
        got = rt.get(ref)
        if out["put_device_bytes"] != n * 4 or out["put_host_bytes"]:
            raise AssertionError(f"D1: the put copied {out}")
        if got.device.type != torch.device(device).type or \
                not torch.equal(got, x) or got is not rt.get(ref):
            raise AssertionError("D1: get did not give the stored tensor "
                                 "equal to the original")
        entry = head.object_store.get(ref.object_id())
        if not entry.is_device or entry.size != n * 4:
            raise AssertionError("D1: the put is not a device entry")

        # An actor on the head reads the stored tensor: no host copy.
        reader = rt.remote(Reader).options(**on_head).remote()
        rt.get(reader.read.remote(rt.put(torch.zeros(1, device=device))))
        host0 = copy_stats["bytes_copied"]
        kind, ptr = rt.get(reader.read.remote(ref))
        out["actor_host_bytes"] = copy_stats["bytes_copied"] - host0
        if kind != got.device.type or ptr != got.data_ptr() or \
                out["actor_host_bytes"]:
            raise AssertionError(f"D1: the actor read ({kind}, {ptr}) "
                                 f"copying {out['actor_host_bytes']} host "
                                 "bytes")
        del got, x

        # A 256 MiB return on the head, then pulled by another raylet.
        m = ret_mib * MIB // 4
        ret = rt.remote(_draw_task).options(**on_head).remote(m, 2, device)
        ready, _ = rt.wait([ret], timeout=120)
        entry = head.object_store.get(ret.object_id())
        if ready != [ret] or entry is None or not entry.is_device or \
                core.memory_store.get_entry(ret.object_id()) is not None:
            raise AssertionError("D1: the return is not a device entry "
                                 "on the head alone")
        reader_far = rt.remote(_check_pulled).options(
            resources={"d1_r0": 1})
        # The raylet's first pull and task (its worker's start, the
        # lease's spillback) timed apart from the measured pulls.
        t0 = time.perf_counter()
        warm = rt.put(_draw(1 << 18, 4, device))
        if rt.get(reader_far.remote(warm, 1 << 18, 4, device,
                                    torch.float32), timeout=300) != \
                ("cpu", torch.float32, True):
            raise AssertionError("D1: the first 1 MiB pull read wrong")
        out["first_pull_ms"] = (time.perf_counter() - t0) * 1e3
        pulls = {}
        for dtype, src in ((torch.float32, ret),
                           (torch.bfloat16, rt.remote(_draw_task).options(
                               **on_head).remote(m, 2, device,
                                                 torch.bfloat16))):
            rt.wait([src], timeout=120)
            d2h0 = dict(copy_stats)
            t0 = time.perf_counter()
            seen = rt.get(reader_far.remote(src, m, 2, device, dtype),
                          timeout=300)
            wall = time.perf_counter() - t0
            nbytes = copy_stats["device_to_host_bytes"] - \
                d2h0["device_to_host_bytes"]
            secs = copy_stats["device_to_host_s"] - d2h0["device_to_host_s"]
            if seen != ("cpu", dtype, True):
                raise AssertionError(f"D1: the {dtype} pull read {seen}")
            want = m * torch.tensor([], dtype=dtype).element_size()
            if on_card and nbytes != want:
                raise AssertionError(f"D1: the {dtype} pull copied "
                                     f"{nbytes} bytes off the card")
            pulls[str(dtype).replace("torch.", "")] = {
                "bytes": want, "d2h_gbps": nbytes / secs / 1e9 if secs
                else None, "read_gbps": want / wall / 1e9,
                "read_ms": wall * 1e3,
                "transfer_gbps": puller.object_manager.stats[
                    "transfer_gbps_last"]}
        out["pulls"] = pulls
        small = rt.get(rt.remote(_describe).remote(
            _draw(16, 3, device)))
        if small != ("cpu", torch.float32):
            raise AssertionError(f"D1: a small inline tensor arrived as "
                                 f"{small}")

        # Spill pressure on a store half full of device entries.
        on_spill = {"resources": {f"d1_r{D1_RAYLETS - 1}": 1}}
        k = spill_mib * MIB // 4
        devs = rt.remote(_draws).options(num_returns=4, **on_spill).remote(
            k, 4, 10, device)
        rt.wait(devs, num_returns=4, timeout=120)
        store = spill_raylet.object_store
        half = store.used_bytes()
        hosts = [rt.remote(_pattern_return).options(**on_spill).remote(
            spill_mib * MIB, 100 + i) for i in range(8)]
        rt.wait(hosts, num_returns=len(hosts), timeout=300)
        spilled = store.stats["spilled_objects"]
        kept = [store.get(r.object_id()) for r in devs]
        if spilled < 1 or any(e is None or not e.is_device or
                              e.spilled_path is not None for e in kept):
            raise AssertionError(f"D1: {spilled} spilled; device entries "
                                 f"{[(e and e.is_device) for e in kept]}")
        for i, r in enumerate(hosts):
            if not np.array_equal(rt.get(r, timeout=120),
                                  _pattern_return(spill_mib * MIB,
                                                  100 + i)):
                raise AssertionError(f"D1: numpy return {i} read wrong")
        out["spill"] = {"capacity_mib": store.capacity // MIB,
                        "device_mib": half // MIB,
                        "numpy_mib": 8 * spill_mib,
                        "spilled_objects": spilled,
                        "device_entries_spilled": 0}

        # The GPU resource.
        cards = torch.cuda.device_count() if on_card else 0
        out["gpus"] = rt.cluster_resources().get("GPU", 0.0)
        if out["gpus"] != cards:
            raise AssertionError(f"D1: {out['gpus']} GPUs for {cards} "
                                 "cards")
        if on_card:
            ids = rt.get(rt.remote(num_gpus=1)(_gpu_ids).remote())
            if ids != [0]:
                raise AssertionError(f"D1: a num_gpus=1 task saw {ids}")
        ticks, bad = _tick_totals(members)
        _check_clean("D1", bad)
        out["batched_ticks"] = sum(ticks.values())
        out["launches"] = _launches() - launches0
        return out
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# -- U1 ----------------------------------------------------------------------------

def _rank_input(rank, seed, n):
    return np.random.default_rng(seed * 100 + rank).uniform(
        0.5, 1.5, n).astype(np.float32)


class Rank:
    """One member of U1's group; its inputs are CUDA tensors (a rank's
    host form travels to the rendezvous)."""

    def __init__(self, device):
        from ray_tpu_torch.util import collective
        self.col = collective
        self.device = device
        self.rank = None

    def init_collective_group(self, world_size, rank, backend, group_name):
        self.col.init_collective_group(world_size, rank, backend,
                                       group_name)
        self.rank = rank
        return rank

    def _input(self, seed, n):
        return torch.from_numpy(_rank_input(self.rank, seed, n)).to(
            self.device)

    def allreduce(self, seed, op, group):
        return self.col.allreduce(self._input(seed, U1_ELEMS), group,
                                  getattr(self.col.ReduceOp, op))

    def reducescatter(self, seed, group):
        return self.col.reducescatter(self._input(seed, U1_ELEMS), group)

    def allgather(self, seed, group):
        return self.col.allgather(self._input(seed, U1_GATHER_ELEMS), group)

    def broadcast(self, seed, src, group):
        return self.col.broadcast(self._input(seed, U1_ELEMS), src, group)

    def ring(self, seed, group):
        world = self.col.get_collective_group_size(group)
        self.col.send(self._input(seed, U1_ELEMS), (self.rank + 1) % world,
                      group)
        return self.col.recv((self.rank - 1) % world, group, timeout=120)

    def barrier(self, group):
        self.col.barrier(group)
        return self.rank

    def double(self, v):
        return 2 * v


def _numpy_reduce(xs, op):
    stack = np.stack(xs)
    return {"SUM": lambda: stack.sum(0, dtype=np.float32),
            "PRODUCT": lambda: stack.prod(0, dtype=np.float32),
            "MIN": lambda: stack.min(0), "MAX": lambda: stack.max(0),
            "MEAN": lambda: stack.mean(0, dtype=np.float32)}[op]()


def _check(name, got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ok = got.dtype == want.dtype and got.shape == want.shape and (
        np.array_equal(got, want) if exact else
        np.allclose(got, want, rtol=RTOL, atol=0))
    if not ok:
        err = np.max(np.abs(got.astype(np.float64) - want) /
                     np.abs(want)) if got.shape == want.shape else None
        raise AssertionError(f"U1: {name} differs from numpy (max rel "
                             f"{err})")


def _produce(q, start, n):
    for i in range(start, start + n):
        q.put(i, timeout=120)
    return n


def _consume(q, n):
    return [q.get(timeout=120) for _ in range(n)]


def util_library(device="cuda", ranks=U1_RANKS, queue_items=U1_QUEUE_ITEMS,
                 pool_calls=U1_POOL_CALLS):
    """U1 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.metrics_agent import get_metrics_registry
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import ActorPool, Queue, collective
    from ray_tpu_torch.util import iter as rit
    from ray_tpu_torch.util import metrics
    from ray_tpu_torch.util.collective import collective as col_impl
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="profile_device_")
    rt.init(device=device, num_cpus=16, _system_config={"temp_dir": tmp})
    try:
        members = _Members(global_worker().cluster.raylets())
        launches0 = _launches()
        out = {"ranks": ranks, "elements": U1_ELEMS}
        # The reduction alone on the ranks' host arrays, each op's first
        # call in this process and its second: ms of the upload, the
        # stack, the reduction and the copy back.
        xs = [_rank_input(r, 99, U1_ELEMS) for r in range(ranks)]
        reduce_ms = {}
        for op in OPS:
            reduce_ms[op] = []
            for _ in range(2):
                _sync(device)
                t0 = time.perf_counter()
                col_impl._reduce_stack(xs, getattr(collective.ReduceOp, op))
                reduce_ms[op].append((time.perf_counter() - t0) * 1e3)
        out["reduce_ms_first_second"] = reduce_ms
        reductions0 = dict(col_impl.reduce_stats)
        actors = [rt.remote(Rank).remote(device) for _ in range(ranks)]
        t0 = time.perf_counter()
        collective.create_collective_group(actors, ranks, list(range(ranks)),
                                           "nccl", "u1")
        out["create_group_ms"] = (time.perf_counter() - t0) * 1e3
        ms = {}
        for i, op in enumerate(OPS):
            t0 = time.perf_counter()
            res = rt.get([a.allreduce.remote(i, op, "u1") for a in actors],
                         timeout=600)
            ms[op] = (time.perf_counter() - t0) * 1e3
            want = _numpy_reduce(
                [_rank_input(r, i, U1_ELEMS) for r in range(ranks)], op)
            for r, got in enumerate(res):
                _check(f"allreduce {op} rank {r}", got, want,
                       op in ("MIN", "MAX"))
        seed = len(OPS)
        xs = [_rank_input(r, seed, U1_ELEMS) for r in range(ranks)]
        t0 = time.perf_counter()
        res = rt.get([a.reducescatter.remote(seed, "u1") for a in actors],
                     timeout=600)
        ms["reducescatter"] = (time.perf_counter() - t0) * 1e3
        for r, (got, want) in enumerate(zip(res, np.array_split(
                _numpy_reduce(xs, "SUM"), ranks))):
            _check(f"reducescatter rank {r}", got, want, False)
        t0 = time.perf_counter()
        res = rt.get([a.broadcast.remote(seed, 3, "u1") for a in actors],
                     timeout=600)
        ms["broadcast"] = (time.perf_counter() - t0) * 1e3
        for r, got in enumerate(res):
            _check(f"broadcast rank {r}", got, xs[3], True)
        t0 = time.perf_counter()
        res = rt.get([a.ring.remote(seed, "u1") for a in actors],
                     timeout=600)
        ms["send_recv"] = (time.perf_counter() - t0) * 1e3
        for r, got in enumerate(res):
            _check(f"recv rank {r}", got, xs[(r - 1) % ranks], True)
        t0 = time.perf_counter()
        res = rt.get([a.allgather.remote(seed, "u1") for a in actors],
                     timeout=600)
        ms["allgather"] = (time.perf_counter() - t0) * 1e3
        small = [_rank_input(r, seed, U1_GATHER_ELEMS) for r in range(ranks)]
        for r, gathered in enumerate(res):
            for s, got in enumerate(gathered):
                _check(f"allgather rank {r} shard {s}", got, small[s], True)
        del res, gathered
        t0 = time.perf_counter()
        ranks_seen = sorted(rt.get([a.barrier.remote("u1") for a in actors],
                                   timeout=600))
        ms["barrier"] = (time.perf_counter() - t0) * 1e3
        if ranks_seen != list(range(ranks)):
            raise AssertionError(f"U1: barrier saw {ranks_seen}")
        reductions = {k: col_impl.reduce_stats[k] - reductions0.get(k, 0)
                      for k in col_impl.reduce_stats}
        if reductions.get(dev.type, 0) != len(OPS) + 1 or \
                sum(reductions.values()) != len(OPS) + 1:
            raise AssertionError(f"U1: reductions by device {reductions}")
        out["reductions"] = reductions
        out["ms"] = ms

        pool = ActorPool(actors)
        t0 = time.perf_counter()
        doubled = list(pool.map(lambda a, v: a.double.remote(v),
                                range(pool_calls)))
        out["pool_calls_per_s"] = pool_calls / (time.perf_counter() - t0)
        if doubled != [2 * v for v in range(pool_calls)]:
            raise AssertionError("U1: ActorPool.map out of order or wrong")

        q = Queue(maxsize=1000)
        half = queue_items // 2
        t0 = time.perf_counter()
        consumer = rt.remote(_consume).remote(q, queue_items)
        producers = [rt.remote(_produce).remote(q, s, half)
                     for s in (0, 10 * queue_items)]
        items = rt.get(consumer, timeout=600)
        rt.get(producers, timeout=60)
        out["queue_items_per_s"] = queue_items / (time.perf_counter() - t0)
        by_source = [[i for i in items if i < 10 * queue_items],
                     [i for i in items if i >= 10 * queue_items]]
        if by_source != [list(range(half)),
                         list(range(10 * queue_items,
                                    10 * queue_items + half))]:
            raise AssertionError("U1: the queue lost, duplicated or "
                                 "reordered a producer's items")
        q.shutdown()

        t0 = time.perf_counter()
        it = rit.from_range(80_000, num_shards=8)
        batches = it.for_each(lambda v: v * 3).batch(1000) \
            .gather_async().take(80)
        flat = sorted(v for b in batches for v in b)
        out["iter_items_per_s"] = 80_000 / (time.perf_counter() - t0)
        if flat != [3 * v for v in range(80_000)]:
            raise AssertionError("U1: the parallel iterator's items")

        c = metrics.Counter("u1_calls", description="U1 calls",
                            tag_keys=("kind",))
        c.inc(pool_calls, tags={"kind": "pool"})
        metrics.Gauge("u1_queue_items").set(queue_items)
        h = metrics.Histogram("u1_allreduce_ms", boundaries=[10, 100, 1000])
        for v in ms.values():
            h.observe(v)
        text = get_metrics_registry().render_prometheus()
        want = [f'u1_calls{{kind="pool"}} {float(pool_calls)}',
                f"u1_queue_items {float(queue_items)}",
                f"u1_allreduce_ms_count {len(ms)}"]
        missing = [w for w in want if w not in text]
        if missing:
            raise AssertionError(f"U1: the render lacks {missing}")
        ticks, bad = _tick_totals(members)
        _check_clean("U1", bad)
        out["batched_ticks"] = sum(ticks.values())
        out["launches"] = _launches() - launches0
        return out
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


PHASES = {"d1": device_objects, "u1": util_library}


def main(argv=None) -> int:
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=sorted(PHASES) + ["both"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses a phase")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_device: needs a CUDA device")
        print(card(), flush=True)
        # The raylets' first batched tick would build the class fill
        # inside a phase's timings.
        from ray_tpu_torch.ops import _build
        _build.build("class_fill.cu")
        _build.load("class_fill.cu")
    names = sorted(PHASES) if args.phase == "both" else [args.phase]
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
