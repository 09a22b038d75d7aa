"""Actors under faults, the port against the JAX package, on the CPU.

* ``tests/test_failure.py``'s two actor cases (a ``max_restarts=1``
  actor restarts on a replacement node; a ``max_restarts=0`` actor is
  DEAD and its calls raise ``ActorError``), each under a graceful
  ``remove_node`` and under a hard ``kill_node`` (the node dies by
  missed heartbeats, at 0.5 s SUSPECT and 2 s DEAD here), on a cluster
  of each package (``torch_cluster_util``).
* ``tests/test_gcs_fault_tolerance.py``'s three actor cases on a
  journaled GCS (``test_torch_gcs_restart``'s ``_Persistent``): a live
  actor is re-attached with its state, a named actor is found after the
  restart, an actor whose worker was lost in the outage is recreated.
* The divergences of ROADMAP C.13, C.15 and C.16 end to end, each with
  the reference's outcome beside the port's: a killed node's actor
  restarts while the node is only SUSPECT in the reference (its raylet
  reports the worker's exit) and only at DEAD in the port; a method
  that a killed node's thread finishes completes from the dead node in
  the reference and is retried on the restarted actor in the port;
  methods queued at a killed actor's worker are never answered in the
  reference and raise ``ActorDiedError`` in the port; a constructor
  that raises leaves its lease and the resources the actor
  would hold taken in the reference, and returns them in the port.

The outcomes are values with node ids read as node names, or the
error's type and message with ids masked.
"""

import importlib
import os
import threading
import time

import pytest

import ray_tpu_torch
from test_torch_gcs_restart import _Persistent
from torch_cluster_util import PORT, both, outcome, wait_until

FAST_BEATS = {"raylet_heartbeat_period_milliseconds": 50,
              "num_heartbeats_suspect": 10,
              "num_heartbeats_timeout": 40}


class Pinger:
    def __init__(self, pkg_name):
        self.pkg = importlib.import_module(pkg_name)

    def ping(self):
        return self.pkg.get_runtime_context().get_node_id()


class Gated:
    """``slow`` blocks until the module's gate opens."""

    def __init__(self, pkg_name):
        self.pkg = importlib.import_module(pkg_name)

    def where(self):
        return self.pkg.get_runtime_context().get_node_id()

    def slow(self):
        assert _GATE.wait(30), "the gate never opened"
        return self.pkg.get_runtime_context().get_node_id()


_GATE = threading.Event()


def _drop(env, node, how):
    if how == "remove":
        env.cluster.remove_node(node)
    else:
        env.cluster.kill_node(node)


def _dead(env, node):
    return node.node_id in env.cluster.gcs.node_manager.dead_nodes


# -- tests/test_failure.py -----------------------------------------------------

def case_restart_on_node_death(env, how):
    victim = env.add_node("victim", 2, {"spot": 1})
    env.broadcast()
    a = env.pkg.remote(resources={"spot": 0.1}, num_cpus=1,
                       max_restarts=1)(Pinger).remote(env.name)
    first = env.node_of(env.pkg.get(a.ping.remote(), timeout=10))
    env.add_node("replacement", 2, {"spot": 1})
    env.broadcast()
    # The states the manager publishes for the actor from the drop on.
    published = []
    channel = importlib.import_module(f"{env.name}.gcs.pubsub").ACTOR_CHANNEL
    env.cluster.gcs.publisher.subscribe(
        channel, a._actor_id.binary(),
        lambda _key, info: published.append(info["state"]))
    _drop(env, victim, how)
    wait_until(lambda: _dead(env, victim), timeout=15, what="the death")
    # The outcome is decided by what the manager publishes after the
    # death: the restart (ALIVE) or a burial (DEAD: the reference's
    # second report of a graceful removal spends the restart again,
    # ROADMAP C.13).  Wait for it: under load either can land after a
    # fixed ping window.  A buried actor stays dead to the driver even
    # if the restart posted first places it again later, so the
    # outcome's state is DEAD once a DEAD was published.
    wait_until(lambda: "ALIVE" in published or "DEAD" in published,
               timeout=30, what="the restart or the burial")
    deadline = time.monotonic() + 15
    node = None
    while time.monotonic() < deadline:
        try:
            node = env.node_of(env.pkg.get(a.ping.remote(), timeout=2))
            if node != "victim":
                break
        except env.pkg.exceptions.RayTpuError:
            time.sleep(0.1)
    actor = env.cluster.gcs.actor_manager.get_actor(a._actor_id)
    state = "DEAD" if "DEAD" in published else actor.state
    return first, node, state, actor.num_restarts


def case_no_restart_becomes_dead(env, how):
    victim = env.add_node("victim", 1, {"spot": 1})
    env.broadcast()
    a = env.pkg.remote(resources={"spot": 0.1}, num_cpus=0,
                       max_restarts=0)(Pinger).remote(env.name)
    first = env.node_of(env.pkg.get(a.ping.remote(), timeout=10))
    _drop(env, victim, how)
    wait_until(lambda: _dead(env, victim), timeout=15, what="the death")
    time.sleep(0.3)
    actor = env.cluster.gcs.actor_manager.get_actor(a._actor_id)
    try:
        env.pkg.get(a.ping.remote(), timeout=5)
        raised = None
    except env.pkg.exceptions.ActorError as e:
        raised = type(e).__name__
    return first, raised, actor.state, actor.num_restarts


@pytest.mark.parametrize("how", ["remove", "kill"])
def test_restart_on_node_death_matches_jax(how):
    want, got = both(lambda env: case_restart_on_node_death(env, how), 1,
                     FAST_BEATS)
    assert got == ("value", ("victim", "replacement", "ALIVE", 1))
    if how == "kill":
        assert want == got
    else:
        # The reference's graceful removal reports the death twice (the
        # node's, then its worker's exit): the second spends the one
        # restart again and buries the actor, which the restart posted
        # first may place again (ROADMAP C.13).
        assert want[1][:2] == ("victim", "replacement") or \
            want[1][2] == "DEAD", want


@pytest.mark.parametrize("how", ["remove", "kill"])
def test_no_restart_becomes_dead_matches_jax(how):
    want, got = both(lambda env: case_no_restart_becomes_dead(env, how), 1,
                     FAST_BEATS)
    assert want == ("value", ("victim", "ActorDiedError", "DEAD", 0))
    assert got == want


# -- tests/test_gcs_fault_tolerance.py, on a journaled GCS ---------------------

class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


class Svc:
    def ping(self):
        return "pong"


class Phoenix:
    def __init__(self):
        self.epoch = time.monotonic()

    def when(self):
        return self.epoch


def case_live_actor_survives_restart(env):
    c = env.pkg.remote(max_restarts=1)(Counter).remote()
    first = env.pkg.get([c.incr.remote() for _ in range(3)], timeout=30)
    env.cluster.restart_gcs()
    after = env.pkg.get(c.incr.remote(), timeout=30)
    actor = env.cluster.gcs.actor_manager.get_actor(c._actor_id)
    return first, after, actor.state, actor.num_restarts


def case_named_actor_lookup_after_restart(env):
    env.pkg.remote(Svc).options(name="svc", namespace="ns").remote()
    env.cluster.restart_gcs()
    handle = env.pkg.get_actor("svc", namespace="ns")
    return env.pkg.get(handle.ping.remote(), timeout=30)


def case_actor_lost_during_outage_is_restarted(env):
    p = env.pkg.remote(max_restarts=2)(Phoenix).remote()
    first = env.pkg.get(p.when.remote(), timeout=30)
    # Kill the dedicated worker without telling the (about to die) GCS.
    actor = env.cluster.gcs.actor_manager.get_actor(p._actor_id)
    actor.worker._killed.set()
    actor.worker.state = "DEAD"
    env.cluster.restart_gcs()
    mgr = env.cluster.gcs.actor_manager
    wait_until(lambda: mgr.get_actor(p._actor_id) is not None and
               mgr.get_actor(p._actor_id).state == "ALIVE", timeout=15)
    second = env.pkg.get(p.when.remote(), timeout=30)
    return second != first, mgr.get_actor(p._actor_id).num_restarts


GCS_CASES = [case_live_actor_survives_restart,
             case_named_actor_lookup_after_restart,
             case_actor_lost_during_outage_is_restarted]


@pytest.mark.parametrize("case", GCS_CASES,
                         ids=lambda c: c.__name__[len("case_"):])
def test_gcs_restart_actor_case_matches_jax(case):
    out = []
    for name in ("ray_tpu", PORT):
        env = _Persistent(name)
        try:
            out.append(outcome(lambda: case(env)))
        finally:
            env.shutdown()
    want, got = out
    assert want[0] == "value", want
    assert got == want


# -- divergences end to end (ROADMAP C.13, C.15) -------------------------------

def case_suspect_restarts_nothing(env):
    """A hard-killed node's actor while the node is SUSPECT, then after
    its DEAD."""
    victim = env.add_node("victim", 2, {"spot": 1})
    env.broadcast()
    a = env.pkg.remote(resources={"spot": 0.1}, num_cpus=1,
                       max_restarts=1)(Pinger).remote(env.name)
    env.pkg.get(a.ping.remote(), timeout=10)
    env.add_node("replacement", 2, {"spot": 1})
    env.broadcast()
    mgr = env.cluster.gcs.actor_manager
    hb = env.cluster.gcs.heartbeat_manager
    env.cluster.kill_node(victim)
    wait_until(lambda: hb.is_suspect(victim.node_id) or _dead(env, victim),
               timeout=15, what="the suspicion")
    actor = mgr.get_actor(a._actor_id)
    at_suspect = (_dead(env, victim), actor.num_restarts)
    wait_until(lambda: _dead(env, victim), timeout=15, what="the death")
    # The death reaches the actors on the GCS loop after the node table:
    # a call made in between can still go to the dead worker.
    wait_until(lambda: mgr.get_actor(a._actor_id).state == "ALIVE" and
               mgr.get_actor(a._actor_id).num_restarts == 1, timeout=15,
               what="the restart")
    node = env.node_of(env.pkg.get(a.ping.remote(), timeout=15))
    actor = mgr.get_actor(a._actor_id)
    return at_suspect, node, actor.num_restarts


def test_a_suspect_nodes_actor_restarts_only_at_dead_in_the_port():
    want, got = both(case_suspect_restarts_nothing, 1, FAST_BEATS)
    # The reference restarts the actor as soon as the killed raylet
    # reports its worker's exit, before the node is even SUSPECT.
    assert want == ("value", ((False, 1), "replacement", 1))
    assert got == ("value", ((False, 0), "replacement", 1))


def case_call_from_a_dead_nodes_thread(env):
    """A method runs on the victim when its node is killed; it returns
    after the kill."""
    _GATE.clear()
    victim = env.add_node("victim", 2, {"spot": 1})
    env.broadcast()
    a = env.pkg.remote(resources={"spot": 0.1}, num_cpus=1, max_restarts=1,
                       max_task_retries=1)(Gated).remote(env.name)
    env.pkg.get(a.where.remote(), timeout=10)
    env.add_node("replacement", 2, {"spot": 1})
    env.broadcast()
    ref = a.slow.remote()
    time.sleep(0.2)
    env.cluster.kill_node(victim)
    _GATE.set()
    try:
        return env.node_of(env.pkg.get(ref, timeout=20))
    finally:
        _GATE.clear()


def test_no_call_completes_from_a_dead_nodes_thread_in_the_port():
    want, got = both(case_call_from_a_dead_nodes_thread, 1, FAST_BEATS)
    assert want == ("value", "victim")
    assert got == ("value", "replacement")


def case_calls_queued_at_a_kill(env):
    """A method runs when its actor is killed, three more wait behind
    it at the worker."""
    _GATE.clear()
    a = env.pkg.remote(Gated).remote(env.name)
    env.pkg.get(a.where.remote(), timeout=10)
    running = a.slow.remote()
    queued = [a.where.remote() for _ in range(3)]
    time.sleep(0.2)
    env.pkg.kill(a)
    _GATE.set()
    try:
        out = [env.node_of(env.pkg.get(running, timeout=10))]
        for ref in queued:
            try:
                env.pkg.get(ref, timeout=3)
                out.append("value")
            except env.pkg.exceptions.RayTpuError as e:
                out.append(type(e).__name__)
        return out
    finally:
        _GATE.clear()


def test_calls_queued_at_a_kill_are_answered_in_the_port():
    """ROADMAP C.15: the reference's killed worker leaves the methods
    queued behind its running one unanswered (a get times out); the
    port answers them ``ActorDiedError``."""
    want, got = both(case_calls_queued_at_a_kill, 2)
    assert want == ("value", ["head"] + ["GetTimeoutError"] * 3)
    assert got == ("value", ["head"] + ["ActorDiedError"] * 3)


class Broken:
    def __init__(self):
        raise ValueError("constructor raised")

    def ping(self):
        return "pong"


def case_failed_constructor(env):
    """An actor that would hold 2 CPUs, whose constructor raises."""
    before = env.available_cpu()
    a = env.pkg.remote(num_cpus=2)(Broken).remote()
    try:
        env.pkg.get(a.ping.remote(), timeout=30)
        raised = None
    except env.pkg.exceptions.ActorError as e:
        raised = (type(e).__name__, "constructor raised" in str(e))
    time.sleep(0.2)
    state = env.cluster.gcs.actor_manager.get_actor(a._actor_id).state
    return raised, state, before, env.available_cpu()


def test_a_failed_constructor_returns_its_lease_in_the_port():
    """ROADMAP C.16: the reference keeps the worker leased, with the 2
    CPUs the actor would have held; the port returns the lease."""
    want, got = both(case_failed_constructor, 4)
    assert want == ("value", (("ActorDiedError", True), "DEAD", 4.0, 2.0))
    assert got == ("value", (("ActorDiedError", True), "DEAD", 4.0, 4.0))


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        h = ray_tpu_torch.remote(Counter).remote()
        ray_tpu_torch.get(h.incr.remote(), timeout=30)
        ray_tpu_torch.kill(h)
    finally:
        ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
