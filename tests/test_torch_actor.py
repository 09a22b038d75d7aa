"""The port's actors (``@ray_tpu_torch.remote`` on a class, handles,
``kill``, ``get_actor``) against the JAX package's, on the CPU.

Each case runs once on the JAX package's cluster under ``ray_tpu.init``
and once on the port's (``device="cpu"``) under ``ray_tpu_torch.init``
(``torch_cluster_util``'s ``both``), and the two outcomes must be equal:
the values, or the error's type and message (ids masked, the package's
name and the anonymous namespace read as one).  The cases are those of
``tests/test_actor.py`` but the two that need process workers or remote
nodes (ROADMAP A.4b.9): creation, ordered calls, constructor arguments,
errors, named actors and namespaces, ``kill``, handles passed into tasks
and actors, ``max_concurrency`` (a span check), actors in actors, held
against default resources (``available_resources()`` before, while
alive and after ``kill``), both actor schedulers
(``gcs_actor_scheduling_enabled``), concurrency groups; with
``tests/test_placement_group.py``'s actor in a placement group and the
runtime context's actor accessors.  The actor classes live at module
level, so that both packages' function export pickles them by
reference; each case decorates them with its package's ``remote``.  A
``gpu`` twin runs the cases on the card's raylets against
``device="cpu"``.  The last test checks that no thread of the port
outlives ``shutdown``.
"""

import importlib
import os
import re
import threading
import time

import pytest
import torch

import ray_tpu_torch
from torch_cluster_util import PORT, both, run_case, wait_until

HEAD_CPUS = 4


class Counter:
    def __init__(self, start=0):
        self.v = start

    def inc(self, by=1):
        self.v += by
        return self.v

    def read(self):
        return self.v


class Faulty:
    def bad(self):
        raise RuntimeError("actor err")

    def ok(self):
        return 1


class Waiter:
    def block(self):
        start = time.monotonic()
        time.sleep(0.3)
        return start, time.monotonic()


class Parent:
    def __init__(self, pkg_name):
        pkg = importlib.import_module(pkg_name)
        self.pkg = pkg
        self.child = pkg.remote(Counter).remote()

    def bump_child(self):
        return self.pkg.get(self.child.inc.remote())


class Grouped:
    def blocked_io(self, gate):
        deadline = time.monotonic() + 30
        while not os.path.exists(gate):
            if time.monotonic() > deadline:
                raise TimeoutError("gate never appeared")
            time.sleep(0.01)
        return "io-done"

    def quick_compute(self, x):
        return x * 2


class Where:
    def __init__(self, pkg_name):
        self.pkg = importlib.import_module(pkg_name)
        ctx = self.pkg.get_runtime_context()
        self.created = ctx.get_assigned_resources()

    def where(self):
        return self.pkg.get_runtime_context().get_node_id()

    def context(self):
        ctx = self.pkg.get_runtime_context()
        return (ctx.get_actor_id(), ctx.current_actor._actor_id.hex(),
                ctx.was_current_actor_reconstructed,
                ctx.get_assigned_resources(), self.created,
                ctx.get_task_id() is not None,
                ctx.namespace.startswith("anon_ns_"))


def bump(pkg_name, handle):
    pkg = importlib.import_module(pkg_name)
    return pkg.get(handle.inc.remote())


def _mask(value):
    """Outcomes compare with the anonymous namespace masked (its job id
    depends on the process's history)."""
    if isinstance(value, str):
        return re.sub(r"anon_ns_[0-9a-f]+", "anon_ns_<job>", value)
    if isinstance(value, (list, tuple)):
        return type(value)(_mask(v) for v in value)
    return value


# -- tests/test_actor.py -------------------------------------------------------

def case_basic(env):
    c = env.pkg.remote(Counter).remote()
    return env.pkg.get(c.inc.remote()), env.pkg.get(c.inc.remote(by=5))


def case_ordering(env):
    c = env.pkg.remote(Counter).remote()
    return env.pkg.get([c.inc.remote() for _ in range(50)], timeout=60)


def case_constructor_args(env):
    c = env.pkg.remote(Counter).remote(start=100)
    return env.pkg.get(c.read.remote())


def case_error(env):
    a = env.pkg.remote(Faulty).remote()
    try:
        env.pkg.get(a.bad.remote(), timeout=30)
        raised = None
    except RuntimeError as e:
        raised = (type(e).__name__, "actor err" in str(e))
    # The actor survives a user exception.
    return raised, env.pkg.get(a.ok.remote(), timeout=30)


def case_named(env):
    a = env.pkg.remote(Counter).options(name="counter1").remote()
    env.pkg.get(a.inc.remote())
    b = env.pkg.get_actor("counter1")
    return env.pkg.get(b.read.remote())


def case_named_duplicate(env):
    cls = env.pkg.remote(Counter)
    cls.options(name="dup").remote()
    time.sleep(0.05)
    cls.options(name="dup").remote()


def case_named_namespaces(env):
    """A name is taken per namespace: the same name in two namespaces
    gives two actors, each found in its own."""
    cls = env.pkg.remote(Counter)
    a = cls.options(name="svc", namespace="ns1").remote(1)
    b = cls.options(name="svc", namespace="ns2").remote(2)
    env.pkg.get([a.read.remote(), b.read.remote()], timeout=30)
    found = [env.pkg.get(env.pkg.get_actor("svc", namespace=ns)
                         .read.remote(), timeout=30)
             for ns in ("ns1", "ns2")]
    mgr = env.cluster.gcs.actor_manager
    return (found, sorted(mgr.list_named_actors(all_namespaces=True),
                          key=lambda d: d["namespace"]),
            mgr.list_named_actors(namespace="ns1"))


def case_get_actor_missing(env):
    env.pkg.get_actor("never-created")


def case_kill(env):
    c = env.pkg.remote(Counter).remote()
    env.pkg.get(c.inc.remote())
    env.pkg.kill(c)
    time.sleep(0.2)
    env.pkg.get(c.inc.remote(), timeout=30)


def case_handle_pass(env):
    c = env.pkg.remote(Counter).remote()
    out = env.pkg.get(env.pkg.remote(bump).remote(env.name, c), timeout=30)
    return out, env.pkg.get(c.read.remote())


def case_max_concurrency(env):
    w = env.pkg.remote(max_concurrency=4)(Waiter).remote()
    spans = env.pkg.get([w.block.remote() for _ in range(4)], timeout=60)
    # True concurrency: an instant inside all four spans.
    return max(s for s, _e in spans) < min(e for _s, e in spans)


def case_actor_in_actor(env):
    p = env.pkg.remote(Parent).remote(env.name)
    return [env.pkg.get(p.bump_child.remote(), timeout=30)
            for _ in range(2)]


def case_holds_resources(env):
    """Held against default resources: ``available_resources()`` before,
    while each is alive, and after each is killed."""
    before = env.available_cpu()
    held = env.pkg.remote(Counter).options(num_cpus=2).remote()
    env.pkg.get(held.read.remote(), timeout=30)
    with_held = env.available_cpu()
    default = env.pkg.remote(Counter).remote()
    env.pkg.get(default.read.remote(), timeout=30)
    with_default = env.available_cpu()
    env.pkg.kill(held)
    wait_until(lambda: env.available_cpu() == before, timeout=10,
               what="the held CPUs' return")
    after_held = env.available_cpu()
    env.pkg.kill(default)
    time.sleep(0.2)
    return before, with_held, with_default, after_held, env.available_cpu()


CASES = [case_basic, case_ordering, case_constructor_args, case_error,
         case_named, case_named_duplicate, case_named_namespaces,
         case_get_actor_missing, case_kill, case_handle_pass,
         case_max_concurrency, case_actor_in_actor, case_holds_resources]


def _name(case):
    return case.__name__[len("case_"):]


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_actor_case_matches_jax(case):
    want, got = both(case, HEAD_CPUS)
    assert _mask(got) == _mask(want)


def test_actor_error_types_are_the_references():
    """The error cases raise what tests/test_actor.py expects."""
    want, got = both(case_kill, HEAD_CPUS)
    assert want[:2] == ("raise", "ActorDiedError")
    assert got == want
    for case in (case_named_duplicate, case_get_actor_missing):
        want, got = both(case, HEAD_CPUS)
        assert want[:2] == got[:2] == ("raise", "ValueError")


# -- TestActorSchedulingModes --------------------------------------------------

class ModeCounter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


def case_lifecycle_under_mode(env):
    cls = env.pkg.remote(max_restarts=1)(ModeCounter)
    c = cls.options(name="mode_counter").remote()
    first = env.pkg.get([c.bump.remote() for _ in range(3)], timeout=30)
    again = env.pkg.get_actor("mode_counter")
    fourth = env.pkg.get(again.bump.remote(), timeout=30)
    env.pkg.kill(c)
    actor = env.cluster.gcs.actor_manager.get_actor(c._actor_id)
    wait_until(lambda: actor.state == "DEAD", timeout=10)
    return first, fourth, actor.state, actor.num_restarts


@pytest.mark.parametrize("gcs_mode", [False, True])
def test_lifecycle_under_both_modes_matches_jax(gcs_mode):
    want, got = both(case_lifecycle_under_mode, HEAD_CPUS,
                     {"gcs_actor_scheduling_enabled": gcs_mode})
    assert want == ("value", ([1, 2, 3], 4, "DEAD", 0))
    assert got == want


# -- TestConcurrencyGroups (thread mode) ---------------------------------------

def case_concurrency_groups(env):
    w = env.pkg.remote(concurrency_groups={"io": 1, "compute": 2})(
        Grouped).remote()
    gate = os.path.join(env.temp_dir, "gate")
    blocked = w.blocked_io.options(concurrency_group="io").remote(gate)
    # While io is blocked, compute-group calls flow, and so does the
    # default group.
    outs = env.pkg.get([w.quick_compute.options(
        concurrency_group="compute").remote(i) for i in range(4)],
        timeout=30)
    default = env.pkg.get(w.quick_compute.remote(5), timeout=30)
    open(gate, "w").close()
    done = env.pkg.get(blocked, timeout=30)
    env.pkg.kill(w)
    return outs, default, done


def test_concurrency_groups_match_jax():
    want, got = both(case_concurrency_groups, HEAD_CPUS)
    assert want == ("value", ([0, 2, 4, 6], 10, "io-done"))
    assert got == want


# -- tests/test_placement_group.py::test_actor_in_placement_group --------------

def case_actor_in_placement_group(env):
    # No broadcast here: a head that knew the node before the commit
    # never sees the bundle's columns in the reference (ROADMAP C.9).
    env.add_node("worker", 4)
    pg = env.util.placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(5)
    strategy = env.strategies.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    a = env.pkg.remote(num_cpus=1)(Where).options(
        scheduling_strategy=strategy).remote(env.name)
    node = env.pkg.get(a.where.remote(), timeout=30)
    bundle = env.util.placement_group_table(pg)["bundle_nodes"][0]
    return env.node_of(node), node == bundle, env.bundle_nodes(pg)


def test_actor_in_placement_group_matches_jax():
    want, got = both(case_actor_in_placement_group, 2)
    assert want[0] == "value" and want[1][1], want
    assert got == want


# -- the runtime context inside an actor ---------------------------------------

def case_runtime_context(env):
    default = env.pkg.remote(Where).remote(env.name)
    held = env.pkg.remote(num_cpus=2)(Where).remote(env.name)
    out = []
    for handle in (default, held):
        ctx = env.pkg.get(handle.context.remote(), timeout=30)
        out.append((ctx[0] == handle._actor_id.hex(),
                    ctx[1] == handle._actor_id.hex()) + ctx[2:])
    ctx = env.pkg.get_runtime_context()
    out.append((ctx.get_actor_id(), ctx.was_current_actor_reconstructed))
    try:
        ctx.current_actor
    except RuntimeError as e:
        out.append(str(e))
    return out


def test_runtime_context_in_actors_matches_jax():
    want, got = both(case_runtime_context, HEAD_CPUS)
    assert want == ("value", [
        (True, True, False, {}, {}, True, True),
        (True, True, False, {}, {"CPU": 2.0}, True, True),
        (None, False), "Not inside an actor method"])
    assert got == want


# -- the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raylets' tick runs its "
                    "kernel only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_name)
def test_actor_case_on_card_matches_cpu(case, cuda_device):
    """The cases with the raylets' tick on the card, against the port
    with ``device="cpu"``."""
    card = run_case(PORT, case, HEAD_CPUS, device=None)
    host = run_case(PORT, case, HEAD_CPUS)
    assert _mask(card) == _mask(host)


def test_no_port_thread_survives_shutdown():
    """Runs last in this file: every actor's threads, worker threads and
    loops of the cases above are gone."""
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        w = ray_tpu_torch.remote(max_concurrency=3,
                                 concurrency_groups={"g": 2})(Waiter)
        handle = w.remote()
        ray_tpu_torch.get(handle.block.remote(), timeout=30)
    finally:
        ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
