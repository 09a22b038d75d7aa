"""H1 and H2: node death by missed heartbeats and a GCS restart, on R3's
cluster through ``ray_tpu_torch.init``.

    python -m ray_tpu_torch.tools.profile_gcs [--phase h1|h2|both|trace]
        [--device cuda] [--runs N --hogs K]

Both run on a ``Cluster`` of R3's 64 raylets (``build_problem(
default_rng(7))``'s first 64 node shapes, ``profile_cluster``) under
``init``, at the config's heartbeat (100 ms, SUSPECT at 15 missed beats,
DEAD at 30).  Each is a function ``chip_smoke.py`` calls, and each raises
on a wrong value.

* ``heartbeat_death`` (H1): four STRICT_SPREAD groups of four
  ``{"CPU": 1}`` bundles; 64 tasks, each returning an 8 MiB array made
  from its index, soft-pinned one to a raylet and held by the driver
  unread (so the only copy of each is on its raylet); then a burst of
  20,000 no-op tasks in R3's classes (those no node fits cut, as in
  C2), and, a quarter into the burst, ``kill_node`` of 8 raylets other
  than the head: one bundle node of each group and four more from a
  seeded draw.  As soon as the GCS publishes a victim SUSPECT (before
  DEAD), the tool sends a burst of fresh leases in R3's classes straight
  to the first survivors whose views mask it (``_MaskProbe``), so that a
  batched tick runs under the mask in every run, whatever the main
  burst's leases are doing then.  Checks: each victim published SUSPECT, then DEAD, within
  ``num_heartbeats_timeout`` periods plus two of its kill; a device solve
  ran under a mask, and none placed a lease on a node its view masked
  when it started (``ClusterTaskManager.mask_stats``); every task
  returned its index, through retries; every array is byte-equal, the
  lost ones recomputed from lineage; every group that had a bundle on a
  victim is CREATED again, on live nodes; no survivor counted an error.
  Reported: ms from each kill to SUSPECT and to DEAD, from the last
  death to the last array read back and to the last group CREATED
  again, the batched ticks (every raylet's, the victims' too) and the
  device solves under a mask.
* ``gcs_restart`` (H2): G1's 16 groups and its 32-bundle SPREAD group on
  a GCS journaled to a file; one group's table row is deleted (an
  outage that ate its removal), then ``restart_gcs``.  Checks: every
  other group is CREATED on the bundle nodes it had; the deleted
  group's bundles are released on its raylets; 1,000 tasks into the
  groups' bundles all run on their bundle's node and see their group,
  their leases placed by the raylets' batched ticks.  With the groups,
  64 live actors (16 of them named) have counted to 3, and one actor's
  worker is killed without telling the GCS just before the restart.
  Checks, after it: every other actor is re-attached ALIVE and its next
  call returns 4; every named actor is found by ``get_actor``; the
  killed one is ALIVE again on a new worker with one restart, and its
  next call returns 1.  Reported: the restart's ms (shutdown, reload,
  reconcile, and the reconcile's actor share) and the journal's bytes.

``--phase trace`` (``beat_trace``, ROADMAP C.33's diagnostic) runs H1
``--runs`` times beside ``--hogs`` spinning processes with every beat,
heartbeat check and kill recorded, and prints for each victim its last
beat's stamp and landing, the checks after it and its death, in ms from
its kill, and for each run the tasks pushed to stopped workers and the
task failures (ROADMAP C.36).

``device="cpu"`` rehearses a phase on the plain class fill.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ray_tpu_torch.tools.profile_cluster import (N_RAYLETS, bench_names,
                                                 make_specs, row_dict)
from ray_tpu_torch.tools.profile_groups import G1_GROUPS, _Runtime, _where
from ray_tpu_torch.tools.profile_tasks import (_check_clean, _index,
                                              _Members, _options,
                                              _tick_totals,
                                              feasible_classes)

H1_TASKS = 20_000
H1_ARRAYS = 64
# 2**20 float64: 8 MiB.
H1_ARRAY_ELEMS = 1 << 20
H1_VICTIMS = 8
H1_GROUPS = 4
# The mask probe's burst: this many leases to each of at most
# H1_PROBE_RAYLETS survivors whose views mask a victim.
H1_PROBE_LEASES = 32
H1_PROBE_RAYLETS = 4
H2_TASKS = 1_000
H2_ACTORS = 64
H2_NAMED = 16
WALL_S = 600.0


def _array(seed):
    return np.random.default_rng(seed).standard_normal(H1_ARRAY_ELEMS)


def _r3_cluster(env):
    """R3's 64 raylets on ``env``'s cluster; (node shapes, demands)."""
    from ray_tpu_torch.scheduler import bench as sb
    rng = np.random.default_rng(7)
    _, total, demand, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    for i in range(N_RAYLETS):
        env.cluster.add_node(row_dict(names, total[i]), node_name=f"r3-{i}")
    return names, total, demand


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} never held")
        time.sleep(0.005)


def _ms(t):
    return t * 1e3


def heartbeat_death(device="cuda", n_tasks=H1_TASKS, n_arrays=H1_ARRAYS,
                    n_victims=H1_VICTIMS):
    """H1 (module docstring).  Returns its numbers."""
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.gcs.pubsub import NODE_CHANNEL
    from ray_tpu_torch.util import placement_group, placement_group_table
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy
    env = _Runtime(device)
    try:
        names, total, demand = _r3_cluster(env)
        env.start()
        rt, cluster = env.rt, env.cluster
        gcs = cluster.gcs
        raylets = cluster.raylets()
        head = cluster.head_node
        published = {}
        gcs.publisher.subscribe(
            NODE_CHANNEL, None, lambda key, msg: published.setdefault(
                key, []).append((msg["state"], time.monotonic())))

        pgs = []
        for _ in range(H1_GROUPS):
            pg = placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
            if not pg.wait(60):
                raise AssertionError(f"H1: a group was not created: "
                                     f"{placement_group_table(pg)}")
            pgs.append(pg)
        homes = [placement_group_table(pg)["bundle_nodes"] for pg in pgs]

        rng = np.random.default_rng(12)
        victims = []
        for bundle_nodes in homes:
            for i in sorted(bundle_nodes):
                r = cluster.raylet(_node_id(bundle_nodes[i]))
                if r is not head and r not in victims:
                    victims.append(r)
                    break
        others = [r for r in raylets if r is not head and r not in victims]
        for j in rng.permutation(len(others))[:n_victims - len(victims)]:
            victims.append(others[int(j)])
        victim_ids = {v.node_id for v in victims}

        array = rt.remote(num_cpus=0)(_array)
        array_refs = [array.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                raylets[j % len(raylets)].node_id.hex(), soft=True)).remote(j)
            for j in range(n_arrays)]
        ready, _ = rt.wait(array_refs, num_returns=n_arrays, timeout=WALL_S,
                           fetch_local=False)
        if len(ready) != n_arrays:
            raise AssertionError(f"H1: {len(ready)} of {n_arrays} arrays")
        homes_of = [cluster.object_directory.get_locations(ref.object_id())
                    for ref in array_refs]
        lost = [j for j, at in enumerate(homes_of) if at and at <= victim_ids]
        core = global_worker().core_worker
        recon0 = core.metrics["lineage_reconstructions"]

        classes = rng.integers(0, 64, size=n_tasks)
        fits = feasible_classes(total[:N_RAYLETS], demand[:64])
        index = rt.remote(_index)
        fns = [index.options(**_options(names, demand[c])) if fits[c]
               else None for c in range(64)]
        kept = [i for i in range(n_tasks) if fits[int(classes[i])]]
        kill_at = len(kept) // 4
        killed = {}
        refs = []
        probe = _MaskProbe(
            gcs, [r for r in raylets if r.node_id not in victim_ids],
            make_specs(names, demand, rng.choice(
                np.flatnonzero(fits), size=H1_PROBE_LEASES)))
        t0 = time.perf_counter()
        for j, i in enumerate(kept):
            if j == kill_at:
                probe.start()
                for v in victims:
                    killed[v.node_id] = time.monotonic()
                    cluster.kill_node(v)
            refs.append(fns[int(classes[i])].remote(i))
        submit_s = time.perf_counter() - t0

        period = get_config().raylet_heartbeat_period_milliseconds / 1e3
        bound_s = (get_config().num_heartbeats_timeout + 2) * period
        _wait(lambda: victim_ids <= set(gcs.node_manager.dead_nodes),
              30, "H1: every victim's death")
        probed = probe.join(60)
        to_suspect, to_dead = [], []
        for v in victims:
            states = published.get(v.node_id.binary(), [])
            order = [s for s, _t in states]
            if order[-2:] != ["SUSPECT", "DEAD"]:
                raise AssertionError(f"H1: {v.node_name} published "
                                     f"{order}, not SUSPECT then DEAD")
            to_suspect.append(states[-2][1] - killed[v.node_id])
            to_dead.append(states[-1][1] - killed[v.node_id])
        gcs_loop = {name: {"count": st["count"], "max_ms": _ms(st["max_s"]),
                           "mean_ms": _ms(st["total_s"] / st["count"])}
                    for name, st in list(gcs.loop.handler_stats.items())
                    if st["count"]}
        if max(to_dead) > bound_s:
            raise AssertionError(
                f"H1: a death took {max(to_dead):.3f} s after its kill; "
                f"bound {bound_s:.3f} s; kill to dead "
                f"{[round(t, 3) for t in to_dead]}; GCS loop lag max "
                f"{_ms(gcs.loop.lag_max_s):.1f} ms, handlers {gcs_loop}")
        last_dead = max(t for s in published.values() for st, t in s
                        if st == "DEAD")

        got = rt.get(array_refs, timeout=WALL_S)
        arrays_s = time.monotonic() - last_dead
        wrong = [j for j, a in enumerate(got)
                 if a.tobytes() != _array(j).tobytes()]
        if wrong:
            raise AssertionError(f"H1: arrays {wrong} differ")
        reconstructed = core.metrics["lineage_reconstructions"] - recon0
        if reconstructed < len(lost):
            raise AssertionError(f"H1: {len(lost)} arrays lost, "
                                 f"{reconstructed} reconstructions")

        moved = [pg for pg, bundle_nodes in zip(pgs, homes)
                 if {_node_id(n) for n in bundle_nodes.values()}
                 & victim_ids]

        def regrouped():
            for pg in moved:
                info = placement_group_table(pg)
                nodes = {_node_id(n) for n in info["bundle_nodes"].values()}
                if info["state"] != "CREATED" or nodes & victim_ids or \
                        len(nodes) != 4:
                    return False
            return True
        try:
            _wait(regrouped, 60, "H1: the groups CREATED again")
        except AssertionError:
            raise AssertionError(
                f"H1: the groups moved off the victims are "
                f"{[placement_group_table(pg) for pg in moved]}; GCS loop "
                f"{gcs.loop.handler_stats}") from None
        groups_s = time.monotonic() - last_dead

        values = rt.get(refs, timeout=WALL_S)
        wall = time.perf_counter() - t0
        if values != kept:
            bad = sum(a != b for a, b in zip(values, kept))
            raise AssertionError(f"H1: {bad} results differ from their "
                                 "index")
        out = {"raylets": len(raylets), "victims": len(victims),
               "victim_names": [v.node_name for v in victims],
               "tasks": len(kept), "arrays": n_arrays,
               "arrays_lost": len(lost), "reconstructions": reconstructed,
               "groups_moved": len(moved),
               "kill_to_suspect_ms": [_ms(t) for t in to_suspect],
               "kill_to_dead_ms": [_ms(t) for t in to_dead],
               "bound_ms": _ms(bound_s),
               "dead_to_arrays_ms": _ms(arrays_s),
               "dead_to_created_ms": _ms(groups_s),
               "wall_s": wall, "submit_s": submit_s,
               "tasks_per_s": len(kept) / wall,
               "gcs_loop": gcs_loop,
               "gcs_loop_lag_max_ms": _ms(gcs.loop.lag_max_s),
               "mask_probe": probed,
               "submitter": dict(core.task_submitter.submitter_stats)}
    finally:
        env.close()
    # Read once every loop stopped, so that no tick is in flight: its
    # launch would be counted and its tick and placements not yet.
    survivors = [r for r in raylets if r.node_id not in victim_ids]
    _, bad = _tick_totals(_Members(survivors))
    _check_clean("H1", bad)
    ticks, _ = _tick_totals(_Members(raylets))
    masked_placements = sum(
        r.cluster_task_manager.mask_stats["masked_placements"]
        for r in survivors)
    masked_ticks = sum(r.cluster_task_manager.mask_stats["masked_ticks"]
                       for r in survivors)
    if masked_placements or not masked_ticks:
        raise AssertionError(f"H1: {masked_placements} placements on "
                             f"masked nodes in {masked_ticks} device "
                             "solves under a mask (none may place there, "
                             "and one must run)")
    out.update(batched_ticks=sum(ticks.values()),
               masked_ticks=masked_ticks,
               masked_placements=masked_placements)
    return out


class _MaskProbe:
    """H1's own burst under the mask.  A thread waits for the GCS to
    publish a node SUSPECT, then checks the survivors' views every 10 ms
    (a SUSPECT reaches them with the next resource broadcast); each
    survivor whose view masks a node gets ``specs`` as one lease batch,
    up to ``H1_PROBE_RAYLETS`` of them, so that its next tick is a
    batched solve under the mask.  Until the SUSPECT the thread only
    waits: polling 56 views a few ms apart before it delayed the GCS's
    heartbeat checks, and with them the deaths.  A granted worker is
    returned at once; spillbacks and backlogs are counted, not
    followed."""

    def __init__(self, gcs, survivors, specs):
        import queue
        import threading

        from ray_tpu_torch.gcs.pubsub import NODE_CHANNEL
        self._survivors = survivors
        self._specs = specs
        self._replies = queue.Queue()
        self._suspect = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="h1-mask-probe")
        self.stats = {"raylets": 0, "leases": 0, "granted": 0,
                      "spilled": 0, "backlog": 0, "other": 0}
        gcs.publisher.subscribe(
            NODE_CHANNEL, None, lambda key, msg: msg["state"] == "SUSPECT"
            and self._suspect.set())

    def start(self):
        self._thread.start()

    def _run(self):
        sent = set()
        deadline = time.monotonic() + 30.0
        while not self._suspect.wait(0.05):
            if self._stop.is_set() or time.monotonic() > deadline:
                return
        while (len(sent) < H1_PROBE_RAYLETS and not self._stop.is_set()
               and time.monotonic() < deadline):
            for r in self._survivors:
                if r.node_id in sent or not r.cluster_view.masked_nodes():
                    continue
                sent.add(r.node_id)
                self.stats["raylets"] += 1
                self.stats["leases"] += len(self._specs)
                r.request_worker_lease_batch(
                    self._specs, lambda rep: self._replies.put(rep))
                if len(sent) == H1_PROBE_RAYLETS:
                    break
            time.sleep(0.01)

    def join(self, timeout):
        """Stop polling, take every reply (returning the granted
        workers) and give the counts; raises if no survivor's view
        masked a victim, or a reply did not come."""
        import queue
        self._stop.set()
        self._thread.join(timeout)
        if not self.stats["raylets"]:
            raise AssertionError("H1: no survivor's view masked a victim "
                                 "before the deaths")
        deadline = time.monotonic() + timeout
        for _ in range(self.stats["raylets"]):
            try:
                rep = self._replies.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"H1: a probe batch was not answered "
                                     f"({self.stats})") from None
            for res in rep["results"]:
                if "worker" in res:
                    self.stats["granted"] += 1
                    res["raylet"].return_worker(res["worker"])
                elif "retry_at" in res:
                    self.stats["spilled"] += 1
                elif res.get("backlog"):
                    self.stats["backlog"] += 1
                else:
                    self.stats["other"] += 1
        return dict(self.stats)


def _node_id(hex_id):
    from ray_tpu_torch._private.ids import NodeID
    return NodeID.from_hex(hex_id)


class _Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def gcs_restart(device="cuda", n_tasks=H2_TASKS, n_actors=H2_ACTORS):
    """H2 (module docstring).  Returns its numbers."""
    from ray_tpu_torch.util import placement_group, placement_group_table
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy
    env = _Runtime(device, file_gcs=True)
    try:
        _r3_cluster(env)
        env.start()
        rt, cluster = env.rt, env.cluster
        pgs = []
        for strategy, n in G1_GROUPS:
            pg = placement_group([{"CPU": 1}] * n, strategy=strategy)
            if not pg.wait(60):
                raise AssertionError(f"H2: a {strategy} group of {n} was "
                                     f"not created")
            cluster.broadcast_now()
            pgs.append(pg)
        before = [placement_group_table(pg)["bundle_nodes"] for pg in pgs]
        where = rt.remote(num_cpus=1)(_where)
        # One task a group before the restart: the function is exported
        # to the KV that the restart reloads.
        first = [where.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=0)).remote(0)
            for pg in pgs]
        rt.get(first, timeout=WALL_S)
        _wait(lambda: all(placement_group_table(pg)["state"] == "CREATED"
                          for pg in pgs), 10, "H2: groups CREATED")
        counter = rt.remote(max_restarts=1)(_Counter)
        handles = [counter.options(name=f"h2-{i}").remote()
                   if i < H2_NAMED else counter.remote()
                   for i in range(n_actors)]
        counts = rt.get([h.incr.remote() for _ in range(3)
                         for h in handles], timeout=WALL_S)
        if counts != [c for c in (1, 2, 3) for _ in handles]:
            raise AssertionError("H2: the actors' counts before the "
                                 "restart are wrong")
        # The last actor's worker dies in the outage, unknown to the GCS.
        lost = cluster.gcs.actor_manager.get_actor(handles[-1]._actor_id)
        lost_worker = lost.worker
        lost_worker._killed.set()
        lost_worker.state = "DEAD"
        leaked = pgs[len(pgs) // 2]
        holders = {_node_id(n) for n in before[len(pgs) // 2].values()}
        journal_bytes = os.path.getsize(cluster._gcs_storage_path)
        cluster.gcs.storage.placement_group_table.delete(leaked.id)
        cluster.restart_gcs()
        restart_ms = dict(cluster.restart_ms)
        mgr = cluster.gcs.actor_manager
        _wait(lambda: mgr.get_actor(handles[-1]._actor_id) is not None and
              mgr.get_actor(handles[-1]._actor_id).state == "ALIVE", 30,
              "H2: the lost actor ALIVE again")
        after = rt.get([h.incr.remote() for h in handles], timeout=WALL_S)
        again = mgr.get_actor(handles[-1]._actor_id)
        if after != [4] * (n_actors - 1) + [1] or \
                again.num_restarts != 1 or again.worker is lost_worker:
            raise AssertionError(
                f"H2: after the restart the actors counted "
                f"{sorted(set(after[:-1]))} and the lost one "
                f"{after[-1]} with {again.num_restarts} restarts")
        for i in range(H2_NAMED):
            if rt.get_actor(f"h2-{i}")._actor_id != handles[i]._actor_id:
                raise AssertionError(f"H2: get_actor('h2-{i}') found "
                                     "another actor")

        kept = [(pg, b) for pg, b in zip(pgs, before) if pg is not leaked]
        for pg, bundle_nodes in kept:
            info = placement_group_table(pg)
            if info["state"] != "CREATED" or \
                    info["bundle_nodes"] != bundle_nodes:
                raise AssertionError(f"H2: after the restart a group is "
                                     f"{info['state']} on "
                                     f"{info['bundle_nodes']}, was on "
                                     f"{bundle_nodes}")

        def released():
            return not any(key[0] == leaked.id
                           for r in cluster.raylets()
                           for key in list(r._committed_bundles) +
                           list(r._prepared_bundles))
        _wait(released, 10, "H2: the leaked group's release")
        ticks0 = sum(_tick_totals(cluster)[0].values())
        refs, expect = [], []
        t0 = time.perf_counter()
        for k in range(n_tasks):
            pg, bundle_nodes = kept[k % len(kept)]
            i = (k // len(kept)) % len(bundle_nodes)
            refs.append(where.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=pg,
                    placement_group_bundle_index=i)).remote(k))
            expect.append((bundle_nodes[i], pg.id.hex()))
        got = rt.get(refs, timeout=WALL_S)
        tasks_s = time.perf_counter() - t0
        wrong = [k for k, (g, e) in enumerate(zip(got, expect))
                 if tuple(g) != e]
        if wrong:
            raise AssertionError(f"H2: {len(wrong)} of {n_tasks} tasks off "
                                 f"their bundles, first {got[wrong[0]]} "
                                 f"for {expect[wrong[0]]}")
        members = _Members(cluster.raylets())
        out = {"raylets": len(cluster.raylets()), "groups": len(pgs),
               "groups_kept": len(kept),
               "leaked_group_nodes": len(holders),
               "restart_ms": restart_ms,
               "restart_total_ms": sum(restart_ms[k] for k in (
                   "shutdown", "reload", "reconcile")),
               "journal_bytes": journal_bytes, "tasks": n_tasks,
               "actors": n_actors, "named": H2_NAMED,
               "reconcile_actors_ms": restart_ms["reconcile_actors"],
               "tasks_per_s": n_tasks / tasks_s}
    finally:
        env.close()
    # Read once the loops stopped (as H1 does).
    ticks, bad = _tick_totals(members)
    _check_clean("H2", bad)
    after_ticks = sum(ticks.values()) - ticks0
    if after_ticks < 1:
        raise AssertionError("H2: no batched tick placed the tasks after "
                             "the restart")
    out.update(batched_ticks_after=after_ticks,
               batched_ticks=sum(ticks.values()))
    return out


def beat_trace(device="cuda", runs=1, hogs=2, n_tasks=1500, n_arrays=16):
    """ROADMAP C.33's diagnostic: H1 (``heartbeat_death``) ``runs`` times
    at a reduced depth beside ``hogs`` spinning processes of its own,
    with every beat, check and kill recorded.  For each victim: the kill,
    the last beat the GCS took from it (when its raylet stamped it and
    when it landed), the checks from that landing to the death, and the
    death, each in ms from the kill.  For the run: the tasks pushed to a
    worker its node's kill stopped (C.36), and the task failures by
    error with the most any one task had.  A run that fails (H1's bound,
    or a task that failed for good) keeps its trace and its error."""
    import collections
    import subprocess
    import sys

    from ray_tpu_torch._private.direct_task_submitter import (
        DirectTaskSubmitter, _worker_dead)
    from ray_tpu_torch._private.raylet import Raylet
    from ray_tpu_torch._private.task_manager import TaskManager
    from ray_tpu_torch.gcs import server

    cls = server.GcsHeartbeatManager
    orig_beat, orig_tick, orig_kill = cls.heartbeat, cls._tick, Raylet.kill
    orig_push, orig_fail = DirectTaskSubmitter._push, \
        TaskManager.fail_or_retry
    beats, ticks, kills, deaths = [], [], {}, {}
    stopped, errors, per_task = [0], collections.Counter(), \
        collections.Counter()

    def beat(self, node_id, sent_at):
        ok = orig_beat(self, node_id, sent_at)
        beats.append((node_id, sent_at, time.monotonic(), ok))
        return ok

    def tick(self):
        t = time.monotonic()
        before = set(self._sent)
        orig_tick(self)
        ticks.append(t)
        for node_id in before - set(self._sent):
            deaths[node_id] = time.monotonic()

    def kill(self):
        kills.setdefault(self.node_id, time.monotonic())
        orig_kill(self)

    def push(self, spec, worker, raylet, key):
        stopped[0] += _worker_dead(worker)
        return orig_push(self, spec, worker, raylet, key)

    def fail(self, spec, error, resubmit):
        errors[type(error).__name__] += 1
        per_task[spec.task_id] += 1
        return orig_fail(self, spec, error, resubmit)

    procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
             for _ in range(hogs)]
    cls.heartbeat, cls._tick, Raylet.kill = beat, tick, kill
    DirectTaskSubmitter._push, TaskManager.fail_or_retry = push, fail
    out = []
    try:
        for _ in range(runs):
            beats.clear()
            ticks.clear()
            kills.clear()
            deaths.clear()
            stopped[0] = 0
            errors.clear()
            per_task.clear()
            try:
                heartbeat_death(device, n_tasks=n_tasks, n_arrays=n_arrays)
                error = None
            except Exception as e:
                error = f"{type(e).__name__}: {e}"[:300]
            victims = []
            for node_id, t_kill in kills.items():
                dead = deaths.get(node_id)
                mine = [b for b in beats if b[0] == node_id and b[3] and
                        (dead is None or b[2] <= dead)]
                last = max(mine, key=lambda b: b[2]) if mine else None
                checks = [t for t in ticks if last and
                          last[2] < t <= (dead or float("inf"))]
                victims.append({
                    "last_sent_ms": last and _ms(last[1] - t_kill),
                    "last_landed_ms": last and _ms(last[2] - t_kill),
                    "checks_after_landing": len(checks),
                    "first_check_ms": checks and _ms(checks[0] - t_kill),
                    "dead_ms": dead and _ms(dead - t_kill)})
            gaps = np.diff(ticks) if len(ticks) > 1 else np.zeros(1)
            out.append({"error": error, "victims": victims,
                        "check_gap_max_ms": _ms(float(gaps.max())),
                        "checks": len(ticks),
                        "stopped_worker_pushes": stopped[0],
                        "task_failures": dict(errors),
                        "most_failures_of_a_task": max(per_task.values(),
                                                       default=0)})
    finally:
        cls.heartbeat, cls._tick, Raylet.kill = orig_beat, orig_tick, \
            orig_kill
        DirectTaskSubmitter._push, TaskManager.fail_or_retry = orig_push, \
            orig_fail
        for p in procs:
            p.kill()
            p.wait()
    return out


PHASES = {"h1": heartbeat_death, "h2": gcs_restart}


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=("h1", "h2", "both", "trace"))
    parser.add_argument("--runs", type=int, default=3,
                        help="--phase trace: H1 runs at full depth")
    parser.add_argument("--hogs", type=int, default=0,
                        help="--phase trace: spinning processes beside it")
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_gcs: needs a CUDA device")
        print(card(), flush=True)
    if args.phase == "trace":
        for run in beat_trace(args.device, runs=args.runs, hogs=args.hogs,
                              n_tasks=H1_TASKS, n_arrays=H1_ARRAYS):
            print(json.dumps({"phase": "H1 trace", **run}), flush=True)
        return 0
    names = ("h1", "h2") if args.phase == "both" else (args.phase,)
    for name in names:
        print(json.dumps({"phase": name.upper(),
                          **PHASES[name](args.device)}, default=str),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
