"""K1 and K2: actors on R3's cluster through ``ray_tpu_torch.init``.

    python -m ray_tpu_torch.tools.profile_actors [--phase k1|k2|both]
        [--device cuda]

Both run on R3's 64 raylets (``profile_gcs._r3_cluster``) under
``init``, at the config's heartbeat (100 ms, SUSPECT at 15 missed beats,
DEAD at 30).  An actor's creation is a lease that the GCS forwards to a
raylet drawn at random, whose batched tick places it on the card's
``class_fill``.  Each phase is a function ``chip_smoke.py`` calls, and
each raises on a wrong value.

* ``actors`` (K1): 1,024 actors created in one burst, in a seeded
  order: 768 default actors (one CPU to be placed, nothing held) and
  256 that hold for life a shape drawn (seed 13) from R3's feasible
  classes (``profile_tasks.feasible_classes``); draws past half of any
  resource's cluster total, or that a first fit of the draws before
  them leaves no node for, are cut and reported (the cut keeps every
  kept shape placeable whatever node the raylets pick).  Of the default
  actors 64 are named (``get_actor`` finds each), 64 have
  ``max_concurrency=4`` (four 0.2 s calls share an instant, as in
  ``test_actor_max_concurrency``) and 64 have ``concurrency_groups={"io":
  1, "compute": 2}`` (a blocked ``io`` call stalls neither ``compute``
  nor the default group).  The driver then makes ``calls`` calls on
  every actor; each returns the actor's running count, which must be
  1..calls in order (a permutation of it on the ``max_concurrency=4``
  actors, whose calls run side by side); then 1,000 tasks each receive
  a handle and call through it.  ``kill`` removes the 256 held actors
  and 64 default ones: ``available_resources()`` is then what it was
  before the burst, and a call to a killed actor raises
  ``ActorDiedError``.  Reported: create-to-ALIVE p50 and p99 and actors
  ALIVE a second; calls a second and the submit-to-sealed p50 and p99;
  the batched ticks; the GCS loop's ``actor.*`` handler counts and its
  lag; the peak of worker threads.
* ``actor_faults`` (K2): 256 actors with ``max_restarts=1,
  max_task_retries=1`` and 256 with ``max_restarts=0``, all SPREAD; 16
  calls each (each sleeps 2 ms and returns its node and the actor's
  count), with 2,000 no-op tasks in R3's classes among them (SPREAD
  creations are placed by the host's policy and never launch the class
  fill; these tasks' leases meet the batched ticks), and, with calls in
  flight (a quarter into them), ``kill_node`` of 8 raylets other than
  the head, from a seeded draw.  Checks: no actor restarts before its
  node is DEAD (SUSPECT restarts nothing);
  each ``max_restarts=1`` actor on a victim is ALIVE again on a live
  node, knows it was reconstructed, and restarted exactly once; each
  ``max_restarts=0`` actor on a victim is DEAD and its calls raise
  ``ActorDiedError``; no actor off the victims restarted, and its counts
  are 1..16 in order; no call was sealed from a victim's thread after
  its ``kill_node`` returned; every task returned its index.  Reported:
  ms from each kill to DEAD, from the last DEAD to the last actor ALIVE
  again, the calls that failed and those retried.

``device="cpu"`` rehearses a phase on the plain class fill; ``--sample``
adds to K1 the commonest frames of the port's busy threads while the
burst is created (a stack sample every 10 ms).
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from ray_tpu_torch.tools.profile_cluster import N_RAYLETS
from ray_tpu_torch.tools.profile_gcs import _ms, _r3_cluster, _wait
from ray_tpu_torch.tools.profile_groups import _Runtime
from ray_tpu_torch.tools.profile_tasks import (_check_clean, _index,
                                              _Members, _options,
                                              _percentiles, _tick_totals,
                                              feasible_classes)

K1_DEFAULT = 768
K1_HELD = 256
K1_NAMED = 64
K1_CONCURRENT = 64
K1_GROUPED = 64
K1_CALLS = 64
K1_TASKS = 1_000
K1_KILLED_DEFAULT = 64
K2_RESTARTABLE = 256
K2_MORTAL = 256
K2_CALLS = 16
K2_VICTIMS = 8
K2_TASKS = 2_000
WALL_S = 600.0
# The GCS draws each creation's raylet from a Random of this seed.
SEEDED = {"actor_scheduling_seed": 13}

# Released by the phase once the compute and default groups answered.
_IO_GATE = threading.Event()


class KActor:
    """The actor of both phases: a count under a lock (a
    ``max_concurrency`` actor runs its calls side by side)."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def incr(self):
        with self._lock:
            self.n += 1
            return self.n

    def incr_slow(self):
        time.sleep(0.002)
        import ray_tpu_torch as rt
        with self._lock:
            self.n += 1
            return rt.get_runtime_context().get_node_id(), self.n

    def span(self):
        start = time.monotonic()
        time.sleep(0.2)
        return start, time.monotonic()

    def blocked_io(self):
        if not _IO_GATE.wait(60):
            raise TimeoutError("the io gate never opened")
        return "io-done"

    def quick(self, x):
        return 2 * x

    def info(self):
        import ray_tpu_torch as rt
        ctx = rt.get_runtime_context()
        return ctx.get_node_id(), ctx.was_current_actor_reconstructed


def call_through(handle):
    """A task that calls an actor through the handle it received."""
    import ray_tpu_torch as rt
    return rt.get(handle.incr.remote())


def _held_shapes(names, total, demand, rng, n):
    """``n`` draws from the feasible classes, and the kept ones: a draw
    is cut when it would take any resource past half of its cluster
    total, or when a first fit of the kept draws before it leaves no
    node for it."""
    fits = feasible_classes(total, demand)
    feasible = [c for c in range(len(fits)) if fits[c]]
    draws = [feasible[int(i)] for i in rng.integers(0, len(feasible), n)]
    left = total.astype(np.float64).copy()
    used = np.zeros(total.shape[1])
    cap = total.sum(axis=0) / 2
    kept = []
    for c in draws:
        row = demand[c]
        if ((used + row) > cap).any():
            continue
        nodes = np.flatnonzero((left >= row).all(axis=1))
        if not len(nodes):
            continue
        left[nodes[0]] -= row
        used += row
        kept.append(c)
    return draws, kept


def _alive_times(gcs):
    """actor id (binary) -> first ALIVE time, from the GCS's actor
    channel, and the list of (actor id, state, time) it saw."""
    first_alive, seen = {}, []

    def on(key, info):
        now = time.monotonic()
        seen.append((key, info["state"], info["num_restarts"], now))
        if info["state"] == "ALIVE":
            first_alive.setdefault(key, now)
    from ray_tpu_torch.gcs.pubsub import ACTOR_CHANNEL
    gcs.publisher.subscribe(ACTOR_CHANNEL, None, on)
    return first_alive, seen


def _loop_stats(gcs):
    return {name: {"count": st["count"], "max_ms": _ms(st["max_s"]),
                   "mean_ms": _ms(st["total_s"] / st["count"])}
            for name, st in list(gcs.loop.handler_stats.items())
            if st["count"] and name.startswith("actor.")}


def _same(a, b):
    keys = set(a) | set(b)
    return all(abs(a.get(k, 0.0) - b.get(k, 0.0)) < 1e-6 for k in keys)


class _StackSampler:
    """Every 10 ms, the innermost frames of each thread of the port, by
    thread kind (the name up to its id): where the burst's wall goes."""

    def __init__(self, depth=3):
        self.depth = depth
        self.counts = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profile_actors::sampler")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _run(self):
        import sys
        import traceback
        while not self._stop.wait(0.01):
            frames = sys._current_frames()
            for t in threading.enumerate():
                if not t.name.startswith("ray_tpu_torch::") or \
                        t.ident not in frames:
                    continue
                kind = t.name.split("::")[1].split("-")[0]
                stack = traceback.extract_stack(frames[t.ident])
                key = (kind, " < ".join(
                    f"{f.name}:{f.lineno}"
                    for f in stack[::-1][:self.depth]))
                self.counts[key] = self.counts.get(key, 0) + 1

    def top(self, n=15):
        """The ``n`` commonest (thread kind, frames) with their share of
        the samples, busy threads only (a thread waiting on its queue or
        lock is dropped)."""
        idle = ("wait:", "get:", "_wait_for_tstate_lock")
        busy = {k: v for k, v in self.counts.items()
                if not k[1].startswith(idle)}
        total = sum(busy.values()) or 1
        return [(kind, frames, v / total) for (kind, frames), v in
                sorted(busy.items(), key=lambda kv: -kv[1])[:n]]


def actors(device="cuda", calls=K1_CALLS, n_tasks=K1_TASKS,
           n_default=K1_DEFAULT, n_held=K1_HELD, sample=False):
    """K1 (module docstring).  Returns its numbers; with ``sample``, also
    the busy threads' commonest frames during the creation burst
    (``creation_stacks``)."""
    import contextlib
    from ray_tpu_torch._private.worker import global_worker
    env = _Runtime(device, system_config=SEEDED)
    try:
        names, total, demand = _r3_cluster(env)
        env.start()
        rt, cluster = env.rt, env.cluster
        gcs = cluster.gcs
        raylets = cluster.raylets()
        core = global_worker().core_worker
        rng = np.random.default_rng(13)
        draws, held = _held_shapes(names, total[:N_RAYLETS],
                                   demand[:64], rng, n_held)
        before = rt.available_resources()
        first_alive, _seen = _alive_times(gcs)
        base = rt.remote(KActor)
        kinds = (["held"] * len(held) + ["named"] * K1_NAMED +
                 ["concurrent"] * K1_CONCURRENT + ["grouped"] * K1_GROUPED +
                 ["default"] * (n_default - K1_NAMED - K1_CONCURRENT -
                                K1_GROUPED))
        order = rng.permutation(len(kinds))
        handles = [None] * len(kinds)
        created = {}
        shapes = iter(held)
        shape_of = {}
        for i in range(len(kinds)):
            if kinds[i] == "held":
                shape_of[i] = next(shapes)
        sampler = _StackSampler() if sample else contextlib.nullcontext()
        sampler.__enter__()
        t0 = time.perf_counter()
        t_first = time.monotonic()
        for i in order.tolist():
            kind = kinds[i]
            if kind == "held":
                cls = base.options(**_options(names, demand[shape_of[i]]))
            elif kind == "named":
                cls = base.options(name=f"k1-{i}")
            elif kind == "concurrent":
                cls = base.options(max_concurrency=4)
            elif kind == "grouped":
                cls = base.options(concurrency_groups={"io": 1,
                                                       "compute": 2})
            else:
                cls = base
            created[i] = time.monotonic()
            handles[i] = cls.remote()
        submit_s = time.perf_counter() - t0
        keys = [h._actor_id.binary() for h in handles]
        _wait(lambda: len(first_alive) >= len(handles) and
              all(k in first_alive for k in keys), WALL_S,
              "K1: every actor ALIVE")
        sampler.__exit__(None, None, None)
        alive_ms = [_ms(first_alive[keys[i]] - created[i])
                    for i in range(len(handles))]
        alive_p50, alive_p99 = _percentiles(alive_ms)
        alive_per_s = len(handles) / (max(first_alive.values()) - t_first)
        threads_alive = threading.active_count()

        # Named actors.
        for i, kind in enumerate(kinds):
            if kind == "named" and \
                    rt.get_actor(f"k1-{i}")._actor_id != handles[i]._actor_id:
                raise AssertionError(f"K1: get_actor('k1-{i}') found "
                                     "another actor")
        # max_concurrency=4: four spans share an instant.
        conc = [i for i, k in enumerate(kinds) if k == "concurrent"]
        spans = rt.get([handles[i].span.remote() for i in conc
                        for _ in range(4)], timeout=WALL_S)
        for j in range(len(conc)):
            four = spans[4 * j:4 * j + 4]
            if not max(s for s, _e in four) < min(e for _s, e in four):
                raise AssertionError(f"K1: an actor with max_concurrency=4 "
                                     f"ran its calls apart: {four}")
        # Concurrency groups: a blocked io call stalls neither group.
        grouped = [i for i, k in enumerate(kinds) if k == "grouped"]
        _IO_GATE.clear()
        blocked = [handles[i].blocked_io.options(
            concurrency_group="io").remote() for i in grouped]
        compute = rt.get([handles[i].quick.options(
            concurrency_group="compute").remote(j)
            for j, i in enumerate(grouped)], timeout=60)
        default = rt.get([handles[i].quick.remote(j)
                          for j, i in enumerate(grouped)], timeout=60)
        ready, _ = rt.wait(blocked, num_returns=len(blocked), timeout=0)
        _IO_GATE.set()
        io = rt.get(blocked, timeout=60)
        expect = [2 * j for j in range(len(grouped))]
        if compute != expect or default != expect or ready or \
                io != ["io-done"] * len(grouped):
            raise AssertionError(f"K1: concurrency groups: compute "
                                 f"{compute[:4]}, default {default[:4]}, "
                                 f"{len(ready)} io calls done while "
                                 "blocked")

        # The calls: each returns the actor's running count.
        submitted = np.zeros((len(handles), calls))
        sealed = np.full((len(handles), calls), np.nan)

        def on_sealed(a, c):
            def cb(_entry):
                sealed[a, c] = time.perf_counter()
            return cb
        refs = []
        t1 = time.perf_counter()
        for c in range(calls):
            for a, h in enumerate(handles):
                submitted[a, c] = time.perf_counter()
                ref = h.incr.remote()
                core.memory_store.get_async(ref.object_id(),
                                            on_sealed(a, c))
                refs.append(ref)
        values = rt.get(refs, timeout=WALL_S)
        calls_s = time.perf_counter() - t1
        got = np.asarray(values).reshape(calls, len(handles)).T
        for a, kind in enumerate(kinds):
            want = list(range(1, calls + 1))
            row = got[a].tolist()
            if (sorted(row) if kind == "concurrent" else row) != want:
                raise AssertionError(f"K1: a {kind} actor's counts are "
                                     f"{row[:8]}...")
        if np.isnan(sealed).any():
            raise AssertionError("K1: a call was read before it was sealed")
        call_p50, call_p99 = _percentiles(
            ((sealed - submitted) * 1e3).ravel())

        # Tasks that call through a handle they received.
        through = rt.remote(num_cpus=0)(call_through)
        targets = [handles[j % len(handles)] for j in range(n_tasks)]
        t2 = time.perf_counter()
        via = rt.get([through.remote(h) for h in targets], timeout=WALL_S)
        tasks_s = time.perf_counter() - t2
        if via != [calls + 1] * n_tasks:
            raise AssertionError(f"K1: calls through a passed handle gave "
                                 f"{sorted(set(via))}")

        # Kill the held actors and 64 default ones.
        victims = [i for i, k in enumerate(kinds) if k == "held"] + \
            [i for i, k in enumerate(kinds) if k == "default"][
                :K1_KILLED_DEFAULT]
        for i in victims:
            rt.kill(handles[i])
        try:
            _wait(lambda: _same(rt.available_resources(), before), 60,
                  "K1: the resources' return")
        except AssertionError:
            raise AssertionError(
                f"K1: after the kills available_resources() is "
                f"{rt.available_resources()}, was {before}") from None
        dead = 0
        for i in victims:
            try:
                rt.get(handles[i].incr.remote(), timeout=60)
            except rt.exceptions.ActorDiedError:
                dead += 1
        if dead != len(victims):
            raise AssertionError(f"K1: {len(victims) - dead} killed actors "
                                 "still answered")
        out = {"raylets": len(raylets), "actors": len(handles),
               "default": n_default, "held": len(held),
               "held_drawn": len(draws), "held_cut": len(draws) - len(held),
               "named": K1_NAMED, "concurrent": K1_CONCURRENT,
               "grouped": K1_GROUPED, "submit_s": submit_s,
               "create_to_alive_p50_ms": alive_p50,
               "create_to_alive_p99_ms": alive_p99,
               "alive_per_s": alive_per_s,
               "calls": int(got.size), "calls_per_s": got.size / calls_s,
               "call_p50_ms": call_p50, "call_p99_ms": call_p99,
               "tasks": n_tasks, "tasks_per_s": n_tasks / tasks_s,
               "killed": len(victims),
               "gcs_actor_handlers": _loop_stats(gcs),
               "gcs_loop_lag_max_ms": _ms(gcs.loop.lag_max_s),
               # Where a creation lease waits: the raylets' loops.
               "raylet_loop_lag_max_ms": _ms(max(r.loop.lag_max_s
                                                 for r in raylets)),
               "actor_manager": dict(gcs.actor_manager.stats),
               "threads_with_actors": threads_alive,
               "peak_workers": sum(r.worker_pool.peak_workers
                                   for r in raylets)}
        if sample:
            out["creation_stacks"] = sampler.top()
    finally:
        _IO_GATE.set()
        env.close()
    # Read once every loop stopped (as H1 does).
    ticks, bad = _tick_totals(_Members(raylets))
    _check_clean("K1", bad)
    out["batched_ticks"] = sum(ticks.values())
    return out


def actor_faults(device="cuda", calls=K2_CALLS, n_restartable=K2_RESTARTABLE,
                 n_mortal=K2_MORTAL, n_victims=K2_VICTIMS,
                 n_tasks=K2_TASKS):
    """K2 (module docstring).  Returns its numbers."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.gcs.pubsub import NODE_CHANNEL
    env = _Runtime(device, system_config=SEEDED)
    try:
        names, total, demand = _r3_cluster(env)
        env.start()
        rt, cluster = env.rt, env.cluster
        gcs = cluster.gcs
        raylets = cluster.raylets()
        head = cluster.head_node
        core = global_worker().core_worker
        node_states = {}
        gcs.publisher.subscribe(
            NODE_CHANNEL, None, lambda key, msg: node_states.setdefault(
                key, []).append((msg["state"], time.monotonic())))
        _first_alive, seen = _alive_times(gcs)
        base = rt.remote(KActor).options(scheduling_strategy="SPREAD")
        restartable = [base.options(max_restarts=1,
                                    max_task_retries=1).remote()
                       for _ in range(n_restartable)]
        mortal = [base.options(max_restarts=0).remote()
                  for _ in range(n_mortal)]
        handles = restartable + mortal
        homes = rt.get([h.info.remote() for h in handles], timeout=WALL_S)
        home = [n for n, _r in homes]
        rng = np.random.default_rng(12)
        per_task = max(1, calls * len(handles) // max(1, n_tasks))
        others = [r for r in raylets if r is not head]
        victims = [others[int(j)]
                   for j in rng.permutation(len(others))[:n_victims]]
        victim_hex = {v.node_id.hex() for v in victims}
        victim_ids = {v.node_id for v in victims}

        sealed = {}

        def on_sealed(key):
            def cb(_entry):
                sealed[key] = time.monotonic()
            return cb
        # Tasks in R3's classes ride along (their leases meet the
        # raylets' batched ticks; the SPREAD creations never do).
        fits = feasible_classes(total[:N_RAYLETS], demand[:64])
        index = rt.remote(_index)
        fns = [index.options(**_options(names, demand[c]))
               for c in range(64) if fits[c]]
        picks = rng.integers(0, len(fns), size=n_tasks)
        task_refs = []
        refs = []
        kill_at = calls * len(handles) // 4
        killed = {}
        for c in range(calls):
            for a, h in enumerate(handles):
                if len(refs) == kill_at:
                    for v in victims:
                        cluster.kill_node(v)
                        # The kill has returned: the node is dead.
                        killed[v.node_id.hex()] = time.monotonic()
                ref = h.incr_slow.remote()
                core.memory_store.get_async(ref.object_id(),
                                            on_sealed((a, c)))
                refs.append(((a, c), ref))
                j = len(task_refs)
                if j < n_tasks and len(refs) % per_task == 0:
                    task_refs.append(fns[int(picks[j])].remote(j))
        task_refs += [fns[int(picks[j])].remote(j)
                      for j in range(len(task_refs), n_tasks)]
        _wait(lambda: victim_ids <= set(gcs.node_manager.dead_nodes), 60,
              "K2: every victim's death")
        dead_at = {}
        for v in victims:
            states = node_states.get(v.node_id.binary(), [])
            if [s for s, _t in states][-2:] != ["SUSPECT", "DEAD"]:
                raise AssertionError(f"K2: {v.node_name} published "
                                     f"{states}, not SUSPECT then DEAD")
            dead_at[v.node_id.hex()] = states[-1][1]
        if rt.get(task_refs, timeout=WALL_S) != list(range(n_tasks)):
            raise AssertionError("K2: a task's result is not its index")
        results, errors = {}, {}
        for key, ref in refs:
            try:
                results[key] = rt.get(ref, timeout=WALL_S)
            except rt.exceptions.RayTpuError as e:
                errors[key] = e
        on_victim = [a for a in range(len(handles)) if home[a] in victim_hex]
        restart_ids = {handles[a]._actor_id.binary() for a in on_victim
                       if a < n_restartable}
        mgr = gcs.actor_manager

        def restarted():
            return all(mgr.get_actor(handles[a]._actor_id).state == "ALIVE"
                       for a in on_victim if a < n_restartable)
        _wait(restarted, 60, "K2: the restartable victims ALIVE again")
        # SUSPECT restarts nothing: an actor restarts at its node's DEAD.
        home_of = {handles[a]._actor_id.binary(): home[a]
                   for a in range(len(handles))}
        early = [key for key, state, _n, t in seen
                 if state == "RESTARTING" and
                 t < dead_at.get(home_of.get(key), float("inf"))]
        if early:
            raise AssertionError(f"K2: {len(early)} actors restarted "
                                 "before their node was DEAD")
        last_alive = max(t for key, state, _n, t in seen
                         if state == "ALIVE" and key in restart_ids) \
            if restart_ids else max(dead_at.values())
        infos = rt.get([handles[a].info.remote() for a in on_victim
                        if a < n_restartable], timeout=WALL_S)
        for (node, again), a in zip(infos, [a for a in on_victim
                                            if a < n_restartable]):
            actor = mgr.get_actor(handles[a]._actor_id)
            if node in victim_hex or not again or actor.num_restarts != 1:
                raise AssertionError(
                    f"K2: a restarted actor is on {node[:8]} "
                    f"(victim {node in victim_hex}), reconstructed "
                    f"{again}, {actor.num_restarts} restarts")
        for a in on_victim:
            if a < n_restartable:
                continue
            actor = mgr.get_actor(handles[a]._actor_id)
            if actor.state != "DEAD":
                raise AssertionError(f"K2: a max_restarts=0 victim is "
                                     f"{actor.state}")
            try:
                rt.get(handles[a].incr_slow.remote(), timeout=60)
                raise AssertionError("K2: a dead actor answered")
            except rt.exceptions.ActorDiedError:
                pass
        wrong_errors = [type(e).__name__ for e in errors.values()
                        if not isinstance(e, rt.exceptions.ActorDiedError)]
        if wrong_errors:
            raise AssertionError(f"K2: calls failed with {wrong_errors[:4]}")
        failed_off = [k for k in errors if k[0] not in on_victim]
        if failed_off:
            raise AssertionError(f"K2: {len(failed_off)} calls to actors "
                                 "off the victims failed")
        for a in range(len(handles)):
            if a in on_victim:
                continue
            if mgr.get_actor(handles[a]._actor_id).num_restarts:
                raise AssertionError("K2: an actor off the victims "
                                     "restarted")
            counts = [results[(a, c)][1] for c in range(calls)]
            if counts != list(range(1, calls + 1)):
                raise AssertionError(f"K2: an actor off the victims "
                                     f"counted {counts}")
        late = [k for k, (node, _n) in results.items()
                if node in victim_hex and sealed.get(k, 0) > killed[node]]
        if late:
            raise AssertionError(f"K2: {len(late)} calls completed from a "
                                 "victim's thread after its kill")
        out = {"raylets": len(raylets), "victims": len(victims),
               "actors": len(handles), "calls": len(refs),
               "actors_on_victims": len(on_victim),
               "restarted": len([a for a in on_victim
                                 if a < n_restartable]),
               "buried": len([a for a in on_victim if a >= n_restartable]),
               "kill_to_dead_ms": sorted(_ms(dead_at[n] - killed[n])
                                         for n in dead_at),
               "dead_to_last_alive_ms": _ms(last_alive -
                                            max(dead_at.values())),
               "calls_failed": len(errors),
               "calls_system_failures":
                   core.actor_submitter.stats["system_failures"],
               "gcs_actor_handlers": _loop_stats(gcs),
               "gcs_loop_lag_max_ms": _ms(gcs.loop.lag_max_s),
               "actor_manager": dict(mgr.stats)}
    finally:
        env.close()
    survivors = [r for r in raylets if r.node_id not in victim_ids]
    _, bad = _tick_totals(_Members(survivors))
    _check_clean("K2", bad)
    ticks, _ = _tick_totals(_Members(raylets))
    out["batched_ticks"] = sum(ticks.values())
    return out


PHASES = {"k1": actors, "k2": actor_faults}


def main(argv=None) -> int:
    import torch

    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=("k1", "k2", "both"))
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain class fill")
    parser.add_argument("--sample", action="store_true",
                        help="K1 also samples its threads' stacks during "
                             "the creation burst")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_actors: needs a CUDA device")
        print(card(), flush=True)
    # The phases of the imported module, not of ``__main__``: its actor
    # class must pickle by reference (by value it would carry the gate).
    from ray_tpu_torch.tools import profile_actors
    names = ("k1", "k2") if args.phase == "both" else (args.phase,)
    for name in names:
        kw = {"sample": True} if args.sample and name == "k1" else {}
        out = profile_actors.PHASES[name](args.device, **kw)
        print(json.dumps({"phase": name.upper(), **out}, default=str),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
