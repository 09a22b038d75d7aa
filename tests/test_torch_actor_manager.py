"""The port's GCS actor manager against the JAX package's, on scripted
parts, on the CPU.

Both packages' ``GcsActorManager`` run on a scripted GCS (its loop
records every post and timer, fired by hand; its publisher records
every message; its table storage is the package's own in-memory one),
scripted raylets (every lease request logged, replied by script) and
scripted workers (every ``assign_actor`` and ``kill_actor`` logged, the
creation answered by script).  The raylet each draws comes from a
``random.Random`` of the same seed: the port's takes it as ``rng``, the
reference's module-level ``random`` is replaced by it.  Fed the same
events, the two must publish the same state sequence, persist the same
records, make the same calls (a lease re-sent after a spillback carries
``grant_or_reject`` in the port only, ROADMAP C.4) and post the same
handlers: a grant, a spillback (``retry_at``), an infeasible or rejected
lease, a creation error, a lease lost up to ``_MAX_CREATION_RETRIES``,
a worker's death with ``max_restarts`` 0, 1 and -1, a node's death,
``destroy_actor`` with and without a worker, named actors, and
``reconcile`` after a restart over the same table.

The divergences (ROADMAP C.13, C.14) are asserted with both outcomes:
a worker's death then its node's spends one restart in the port and two
in the reference; a late death report from a worker the actor no longer
has changes nothing in the port; a restart with no raylet left is DEAD
in the port and RESTARTING for ever in the reference; a creation lost
with its node is retried in the port and DEAD in the reference.
"""

import importlib
import random
import re

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SEED = 13


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Loop:
    """Records posts and timers; ``fire`` runs them in order."""

    def __init__(self):
        self.pending = []
        self.log = []

    def post(self, fn, name="anon"):
        self.pending.append((name, fn))
        self.log.append(("post", name))

    def schedule_after(self, delay, fn, name="timer"):
        self.pending.append((name, fn))
        self.log.append(("after", name, round(delay, 4)))

    def fire(self, limit=100):
        ran = 0
        while self.pending and ran < limit:
            name, fn = self.pending.pop(0)
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the outcome is logged
                self.log.append(("raised", name, type(e).__name__))
            ran += 1


class Publisher:
    def __init__(self, names):
        self.messages = []
        self._names = names

    def publish(self, channel, key, info):
        self.messages.append((channel, info["state"], info["num_restarts"],
                              info["max_restarts"], info["name"],
                              info["namespace"],
                              self._names.get(info["node_id"]),
                              _mask(info["death_cause"])))


class Worker:
    def __init__(self, h, name, node):
        self.h = h
        self.name = name
        self.node = node
        self.node_id = node.node_id
        self.worker_id = h.ids.WorkerID.from_random()
        self.done = None

    def assign_actor(self, spec, on_done):
        self.h.log.append(("assign", self.name))
        self.done = on_done

    def kill_actor(self):
        self.h.log.append(("kill", self.name))


class Pool:
    def __init__(self):
        self.actors = {}

    def worker_for_actor(self, actor_id):
        return self.actors.get(actor_id)


class Raylet:
    def __init__(self, h, name):
        self.h = h
        self.name = name
        self.node_id = h.ids.NodeID.from_random()
        self.worker_pool = Pool()
        self.replies = []
        h.names[self.node_id.hex()] = name

    def request_worker_lease(self, spec, reply, grant_or_reject=False):
        self.h.log.append(("lease", self.name, grant_or_reject))
        self.replies.append(reply)

    def return_worker(self, worker):
        self.h.log.append(("return", worker.name))


class ResourceManager:
    def __init__(self, view):
        self.view = view


class Gcs:
    def __init__(self, h):
        self.loop = Loop()
        self.publisher = Publisher(h.names)
        storage = mod(h.pkg, "gcs.storage")
        self.storage = storage.GcsTableStorage(storage.InMemoryStoreClient())
        self._raylets = {}
        res = mod(h.pkg, "scheduler.resources")
        self.resource_manager = ResourceManager(res.ClusterResourceView())

    def raylets(self):
        return dict(self._raylets)

    def raylet(self, node_id):
        return self._raylets.get(node_id)


class Harness:
    """One package's manager on scripted parts."""

    def __init__(self, pkg, monkeypatch, n_raylets=3, system_config=None):
        self.pkg = pkg
        self.ids = mod(pkg, "_private.ids")
        self.am = mod(pkg, "gcs.actor_manager")
        self.exc = mod(pkg, "exceptions")
        self.spec_mod = mod(pkg, "_private.task_spec")
        cfg = mod(pkg, "_private.config")
        cfg.initialize_config(system_config or {})
        self.log = []
        self.names = {}
        self.gcs = Gcs(self)
        self.raylets = []
        for i in range(n_raylets):
            self.add_raylet(f"r{i}")
        self.workers = 0
        rng = random.Random(SEED)
        if pkg == "ray_tpu":
            monkeypatch.setattr(self.am, "random", rng)
            self.mgr = self.am.GcsActorManager(self.gcs)
        else:
            self.mgr = self.am.GcsActorManager(self.gcs, rng)
        self.actors = {}

    def add_raylet(self, name):
        r = Raylet(self, name)
        self.raylets.append(r)
        self.gcs._raylets[r.node_id] = r
        return r

    def remove_raylet(self, name):
        r = self.raylet(name)
        del self.gcs._raylets[r.node_id]
        return r

    def raylet(self, name):
        return next(r for r in self.raylets if r.name == name)

    def spec(self, actor_id, max_restarts=0, resources=None):
        return self.spec_mod.make_spec(
            job_id=self.ids.JobID.from_int(1),
            owner_id=self.ids.WorkerID.from_random(),
            function_id=self.ids.FunctionID.from_random(),
            function_name="A.__init__", args=[], num_returns=0,
            resources=resources or {"CPU": 1.0},
            task_type=self.spec_mod.TaskType.ACTOR_CREATION_TASK,
            actor_id=actor_id, actor_creation=True,
            max_restarts=max_restarts)

    def create(self, key, max_restarts=0, name="", namespace="ns"):
        actor_id = self.ids.ActorID.from_random()
        actor = self.am.GcsActor(actor_id, self.spec(actor_id, max_restarts),
                                 name=name, namespace=namespace,
                                 max_restarts=max_restarts)
        self.actors[key] = actor
        try:
            self.mgr.register_actor(actor)
        except Exception as e:  # noqa: BLE001 — the outcome is logged
            self.log.append(("register raised", type(e).__name__,
                             _mask(str(e))))
        return actor

    def last_lease(self):
        """The raylet whose reply is the newest still unanswered."""
        for name, _g in reversed([(e[1], e[2]) for e in self.log
                                  if e[0] == "lease"]):
            r = self.raylet(name)
            if r.replies:
                return r
        raise AssertionError("no lease in flight")

    def reply(self, result):
        self.last_lease().replies.pop().__call__(result)

    def grant(self):
        r = self.last_lease()
        self.workers += 1
        w = Worker(self, f"w{self.workers}", r)
        r.replies.pop()({"worker": w, "raylet": r})
        return w

    def spill(self, name):
        self.reply({"retry_at": self.raylet(name).node_id})

    def lost_worker(self, worker):
        worker.done(self.exc.WorkerCrashedError("lease lost"))

    def node_died(self, worker):
        worker.done(self.exc.NodeDiedError(worker.node_id))

    def state(self, key):
        a = self.actors[key]
        return (a.state, a.num_restarts, _mask(a.death_cause),
                self.names.get(a.node_id.hex()) if a.node_id else None)

    def outcome(self):
        records = []
        for _k, rec in self.gcs.storage.actor_table.get_all():
            rec = {k: v for k, v in rec.items() if k != "spec_blob"}
            rec.pop("actor_id")
            rec["node_id"] = self.names.get(rec["node_id"])
            rec["death_cause"] = _mask(rec["death_cause"])
            records.append(tuple(sorted(rec.items())))
        return {"published": self.gcs.publisher.messages,
                "records": sorted(records, key=repr),
                "calls": [e[:2] if e[0] == "lease" else e for e in self.log],
                "loop": self.gcs.loop.log,
                "states": {k: self.state(k) for k in self.actors}}


def _mask(text):
    if not isinstance(text, str):
        return text
    text = text.replace("ray_tpu_torch", "ray_tpu")
    return re.sub(r"[0-9a-f]{12,}", "<id>", text)


def run(monkeypatch, script, **kw):
    out = []
    for pkg in PACKAGES:
        h = Harness(pkg, monkeypatch, **kw)
        try:
            script(h)
        finally:
            mod(pkg, "_private.config").initialize_config()
        out.append((h, h.outcome()))
    return out


def grants_are_resent_with_grant_or_reject(h):
    return [e[2] for e in h.log if e[0] == "lease"]


# -- scripts fed to both managers ----------------------------------------------

def script_grant(h):
    h.create("a")
    w = h.grant()
    w.done(None)


def script_spillback(h):
    h.create("a")
    h.spill("r2")
    h.grant().done(None)


def script_spillback_to_a_gone_raylet(h):
    h.create("a")
    h.remove_raylet("r1")
    h.reply({"retry_at": h.raylet("r1").node_id})
    h.gcs.loop.fire()
    h.grant().done(None)


def script_infeasible_then_granted(h):
    h.create("a")
    h.reply({"rejected": True, "reason": "infeasible"})
    h.gcs.loop.fire()
    h.reply({"rejected": True, "reason": "node dead"})
    h.gcs.loop.fire()
    h.grant().done(None)


def script_creation_error(h):
    h.create("a", name="named")
    h.grant().done(h.exc.RayTpuError("constructor raised"))


def script_lease_lost_until_dead(h):
    am = h.am
    h.create("a")
    for _ in range(am._MAX_CREATION_RETRIES + 1):
        h.lost_worker(h.grant())
        h.gcs.loop.fire()


def script_lease_lost_then_alive(h):
    h.create("a")
    h.lost_worker(h.grant())
    h.gcs.loop.fire()
    h.grant().done(None)


@pytest.mark.parametrize("max_restarts", [0, 1, -1])
def test_worker_death_matches_jax(monkeypatch, max_restarts):
    def script(h):
        a = h.create("a", max_restarts=max_restarts)
        for _ in range(3):
            h.grant().done(None)
            h.mgr.on_actor_worker_died(a.actor_id, "worker exited")
            h.gcs.loop.fire()
            if a.state == "DEAD":
                break
    (_, want), (_, got) = run(monkeypatch, script)
    assert got == want
    expected = {0: ("DEAD", 0), 1: ("DEAD", 1), -1: ("PENDING_CREATION", 3)}
    assert want["states"]["a"][:2] == expected[max_restarts]


def script_node_death(h):
    h.create("a", max_restarts=1)
    h.create("b", max_restarts=0)
    wa = h.grant()
    wa.done(None)
    wb = h.grant()
    wb.done(None)
    h.mgr.on_node_death(wa.node_id)
    if wb.node_id != wa.node_id:
        h.mgr.on_node_death(wb.node_id)
    h.gcs.loop.fire()
    h.grant().done(None)


def script_destroy(h):
    a = h.create("a", max_restarts=2)
    w = h.grant()
    w.done(None)
    h.mgr.destroy_actor(a.actor_id)
    # The killed worker's exit reaches the GCS.
    h.mgr.on_actor_worker_died(a.actor_id, "worker exited")
    b = h.create("b")
    h.mgr.destroy_actor(b.actor_id)       # no worker yet


def script_named(h):
    h.create("a", name="svc", namespace="ns1")
    h.create("b", name="svc", namespace="ns2")
    h.create("c", name="svc", namespace="ns1")    # taken
    h.grant().done(None)
    h.grant().done(None)
    h.log.append(("named", sorted(h.mgr.list_named_actors(
        all_namespaces=True), key=repr),
        h.mgr.list_named_actors(namespace="ns1"),
        h.mgr.get_named_actor("svc", "ns2") is h.actors["b"],
        h.mgr.get_named_actor("svc", "ns3")))


SCRIPTS = [script_grant, script_spillback, script_spillback_to_a_gone_raylet,
           script_infeasible_then_granted, script_creation_error,
           script_lease_lost_until_dead, script_lease_lost_then_alive,
           script_node_death, script_destroy, script_named]


@pytest.mark.parametrize("script", SCRIPTS,
                         ids=lambda s: s.__name__[len("script_"):])
def test_manager_script_matches_jax(monkeypatch, script):
    (hw, want), (hg, got) = run(monkeypatch, script)
    assert got == want
    assert not any(grants_are_resent_with_grant_or_reject(hw))


def test_spillback_resend_is_grant_or_reject_in_the_port(monkeypatch):
    (_, want), (hg, got) = run(monkeypatch, script_spillback)
    assert got == want
    assert grants_are_resent_with_grant_or_reject(hg) == [False, True]


@pytest.mark.parametrize("gcs_mode", [False, True])
def test_both_schedulers_draw_the_same_raylets(monkeypatch, gcs_mode):
    def script(h):
        for i in range(6):
            h.create(f"a{i}")
            h.grant().done(None)
    (_, want), (_, got) = run(
        monkeypatch, script,
        system_config={"gcs_actor_scheduling_enabled": gcs_mode})
    assert got == want
    assert len({s[3] for s in want["states"].values()}) > 1


def test_reconcile_matches_jax(monkeypatch):
    """A restarted manager over the same table: an actor whose worker
    survived is ALIVE again, one whose worker was lost restarts and
    spends a restart, one whose creation was in flight is placed again
    without spending one, a DEAD one stays out."""
    outs = []
    for pkg in PACKAGES:
        h = Harness(pkg, monkeypatch)
        try:
            live = h.create("live", max_restarts=1, name="kept")
            w = h.grant()
            w.done(None)
            lost = h.create("lost", max_restarts=1)
            h.grant().done(None)
            h.create("inflight", max_restarts=1)
            dead = h.create("dead")
            h.grant().done(h.exc.RayTpuError("constructor raised"))
            w.node.worker_pool.actors[live.actor_id] = w
            del lost
            fresh = (h.am.GcsActorManager(h.gcs) if pkg == "ray_tpu" else
                     h.am.GcsActorManager(h.gcs, random.Random(SEED)))
            if pkg == "ray_tpu":
                monkeypatch.setattr(h.am, "random", random.Random(SEED))
            h.mgr = fresh
            h.gcs.loop.log.append(("restart",))
            h.mgr.reconcile(h.raylets)
            h.gcs.loop.fire()
            rebuilt = {k: h.mgr.get_actor(a.actor_id)
                       for k, a in h.actors.items()}
            out = h.outcome()
            out["rebuilt"] = {k: (a.state, a.num_restarts) if a else None
                              for k, a in rebuilt.items()}
            out["named"] = h.mgr.get_named_actor("kept", "ns") is not None
            del out["states"], dead
            outs.append(out)
        finally:
            mod(pkg, "_private.config").initialize_config()
    want, got = outs
    assert got == want
    assert want["rebuilt"] == {"live": ("ALIVE", 0),
                               "lost": ("PENDING_CREATION", 1),
                               "inflight": ("PENDING_CREATION", 0),
                               "dead": None}


# -- divergences (ROADMAP C.13, C.14) ------------------------------------------

def test_worker_then_node_death_spends_one_restart_in_the_port(monkeypatch):
    """The reference's killed raylet reports its actor worker's exit, and
    then the node's death matches the RESTARTING actor by its stale node
    again: a ``max_restarts=1`` actor ends DEAD with its one restart
    spent twice over.  The port's killed raylet reports nothing, and
    even when the worker's report comes first the node's death finds no
    actor whose current worker lived there."""
    def script(h):
        a = h.create("a", max_restarts=1)
        w = h.grant()
        w.done(None)
        h.mgr.on_actor_worker_died(a.actor_id, "worker exited")
        h.mgr.on_node_death(w.node_id)
        h.gcs.loop.fire()
    (_, want), (_, got) = run(monkeypatch, script)
    # The reference buries the actor, then the restart it had already
    # posted places it again: PENDING_CREATION after DEAD.
    assert [m[1:3] for m in want["published"]][-3:] == [
        ("RESTARTING", 1), ("DEAD", 1), ("PENDING_CREATION", 1)]
    assert [m[1:3] for m in got["published"]][-2:] == [
        ("RESTARTING", 1), ("PENDING_CREATION", 1)]


def test_a_stale_workers_late_report_changes_nothing_in_the_port(
        monkeypatch):
    """After a restart, the dead worker's exit is reported late.  The
    reference counts it as a second death; the port's report names the
    worker and is dropped."""
    outs = []
    for pkg in PACKAGES:
        h = Harness(pkg, monkeypatch)
        try:
            a = h.create("a", max_restarts=2)
            old = h.grant()
            old.done(None)
            h.mgr.on_node_death(old.node_id)
            h.gcs.loop.fire()
            h.grant().done(None)
            if pkg == "ray_tpu":
                h.mgr.on_actor_worker_died(a.actor_id, "worker exited")
            else:
                h.mgr.on_actor_worker_died(a.actor_id, "worker exited",
                                           worker_id=old.worker_id)
            outs.append((a.state, a.num_restarts))
        finally:
            mod(pkg, "_private.config").initialize_config()
    assert outs == [("RESTARTING", 2), ("ALIVE", 1)]


def test_a_restart_with_no_raylet_is_dead_in_the_port(monkeypatch):
    """The restart posts the placement to the loop, where it raises with
    no raylet left: the reference's actor stays RESTARTING (its callers
    wait for ever), the port's is DEAD."""
    def script(h):
        a = h.create("a", max_restarts=1)
        h.grant().done(None)
        for r in list(h.raylets):
            h.remove_raylet(r.name)
        h.mgr.on_actor_worker_died(a.actor_id, "worker exited")
        h.gcs.loop.fire()
    (_, want), (_, got) = run(monkeypatch, script)
    assert want["states"]["a"][:2] == ("PENDING_CREATION", 1)
    assert ("raised", "actor.restart", "RayTpuError") in want["loop"]
    assert got["states"]["a"][:3] == (
        "DEAD", 1, "creation failed: No nodes available to create actor")


def test_a_creation_lost_with_its_node_is_retried_in_the_port(monkeypatch):
    def script(h):
        h.create("a")
        h.node_died(h.grant())
        h.gcs.loop.fire()
        h.grant().done(None)
    outs = []
    for pkg in PACKAGES:
        h = Harness(pkg, monkeypatch)
        try:
            try:
                script(h)
            except AssertionError:
                pass      # the reference leases nothing more
            outs.append(h.state("a")[:2])
        finally:
            mod(pkg, "_private.config").initialize_config()
    assert outs == [("DEAD", 0), ("ALIVE", 0)]
