"""The port's Workflow (``ray_tpu_torch.workflow``) against the JAX
package's, on the CPU.

Every case of ``tests/test_workflow.py`` runs the same user code once
under each package's ``init`` (the port's with ``device="cpu"``), each
with a fresh workflow store and a fresh directory for the steps' side
effects, and compares:

* the outcome: the values, statuses and step-run counts the case reads,
  or the error's type and message with the package's name read as one;
* the store's on-disk layout: every file's path under the store, and
  the contents of each ``workflow.json`` and ``meta.json``.

The driver killed mid-workflow runs a script of its own package in a
child process (the port's ``init``s the port, on the CPU), kills it with
SIGKILL inside the second step, resumes from the store, and compares
the same.  Every comparison is exact.  The last test checks that no
thread of the port outlives ``shutdown``.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
import ray_tpu_torch.workflow
from torch_cluster_util import PORT, normalize

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.workflow
except ImportError:
    ray_tpu = None

PACKAGES = ("ray_tpu", PORT)


class Pkg:
    def __init__(self, name, store, work):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.workflow = importlib.import_module(f"{name}.workflow")
        self.storage = importlib.import_module(f"{name}.workflow.storage")
        self.store = str(store)
        self.work = work

    def path(self, name):
        return str(self.work / name)


def _touch_count(path):
    """Append one byte; returns the new count (side-effect counter)."""
    with open(path, "ab") as f:
        f.write(b"x")
    return os.path.getsize(path)


def _count(path):
    return os.path.getsize(path) if os.path.exists(path) else 0


def layout(store):
    """Every file under ``store`` (relative path), with the parsed
    contents of the JSON records."""
    out = []
    for root, _dirs, files in os.walk(store):
        for f in files:
            full = os.path.join(root, f)
            rel = os.path.relpath(full, store)
            if f.endswith(".json"):
                with open(full) as fh:
                    out.append((rel, json.load(fh)))
            else:
                out.append((rel, None))
    return sorted(out, key=lambda x: x[0])


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("raise", type(e).__name__, normalize(str(e)).splitlines()[0])


def run(name, case, tmp_path):
    store, work = tmp_path / f"{name}-store", tmp_path / name
    work.mkdir()
    p = Pkg(name, store, work)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=4, **kw)
    p.workflow.init(p.store)
    try:
        return _outcome(lambda: case(p)), layout(store)
    finally:
        p.workflow.init(None)
        p.pkg.shutdown()


def both(case, tmp_path):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, tmp_path) for name in PACKAGES]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return type(e).__name__, normalize(str(e)).splitlines()[0]
    return None


# -- TestBasicWorkflows -------------------------------------------------------

def case_chain_and_fanin(p):
    workflow = p.workflow

    @workflow.step
    def src(x):
        return x

    @workflow.step
    def add(a, b):
        return a + b

    node = add.step(add.step(src.step(1), src.step(2)), src.step(3))
    return (node.run("chain"), workflow.get_status("chain"),
            p.pkg.get(workflow.get_output("chain")))


def case_nested_container_args(p):
    workflow = p.workflow

    @workflow.step
    def two():
        return 2

    @workflow.step
    def total(values, scale=1):
        return sum(values) * scale

    return total.step([two.step(), two.step(), 5],
                      scale=10).run("containers")


def case_continuation(p):
    workflow = p.workflow

    @workflow.step
    def final(x):
        return x * 100

    @workflow.step
    def entry(x):
        return final.step(x + 1)   # step returning a step

    return entry.step(4).run("cont")


def case_list_and_delete(p):
    workflow = p.workflow

    @workflow.step
    def one():
        return 1

    one.step().run("wf-a")
    one.step().run("wf-b")
    before = sorted(workflow.list_all().items())
    workflow.delete("wf-a")
    return before, sorted(workflow.list_all().items())


# -- TestRecovery -------------------------------------------------------------

def case_resume_skips_finished_steps(p):
    workflow = p.workflow
    cnt_a, cnt_b, gate = p.path("a_runs"), p.path("b_runs"), p.path("gate")

    @workflow.step
    def stage_a():
        _touch_count(cnt_a)
        return 10

    @workflow.step
    def stage_b(x):
        _touch_count(cnt_b)
        if not os.path.exists(gate):
            raise RuntimeError("transient crash")
        return x + 5

    node = stage_b.step(stage_a.step())
    crashed = _raises(lambda: node.run("recov"))
    status = workflow.get_status("recov")
    open(gate, "w").close()
    value = p.pkg.get(workflow.resume("recov"), timeout=30)
    return (crashed[0], "transient crash" in crashed[1], status, value,
            workflow.get_status("recov"), _count(cnt_a), _count(cnt_b))


def case_resume_all(p):
    workflow = p.workflow
    gate = p.path("gate2")

    @workflow.step
    def flaky(tag):
        if not os.path.exists(gate):
            raise RuntimeError("down")
        return tag

    crashed = [_raises(lambda: flaky.step(tag).run(tag))[0]
               for tag in ("r1", "r2")]
    open(gate, "w").close()
    results = workflow.resume_all()
    return (crashed, sorted(results),
            [p.pkg.get(results[t], timeout=30) for t in ("r1", "r2")],
            sorted(workflow.list_all().items()))


# -- TestVirtualActor ---------------------------------------------------------

def case_durable_counter_survives_reload(p):
    workflow = p.workflow

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

        @workflow.virtual_actor.readonly
        def peek(self):
            return self.n

    c = Counter.get_or_create("counter-1", 100)
    out = [c.incr.run(), c.incr.run(9)]
    c2 = workflow.get_actor("counter-1")
    out += [c2.peek.run(), c2.incr.run()]
    state, seq = p.storage.WorkflowStorage("counter-1").load_actor_state(
        "counter-1")
    return out, state, seq


def case_run_async(p):
    workflow = p.workflow

    @workflow.virtual_actor
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, v):
            self.total += v
            return self.total

    a = Acc.get_or_create("acc-1")
    refs = [a.add.run_async(1) for _ in range(5)]
    return sorted(p.pkg.get(refs, timeout=30)), a.add.run(0)


# -- TestReviewRegressions ----------------------------------------------------

def case_same_dag_object_runs_twice(p):
    workflow = p.workflow

    @workflow.step
    def one():
        return 1

    dag = one.step()
    return dag.run("reuse-a"), dag.run("reuse-b"), \
        workflow.get_status("reuse-b")


def case_get_output_waits_instead_of_relaunching(p):
    workflow = p.workflow
    marker, release = p.path("exec_marker"), p.path("release")

    @workflow.step
    def slow():
        _touch_count(marker)
        while not os.path.exists(release):
            time.sleep(0.02)
        return "done"

    ref = slow.step().run_async("live-wf")
    time.sleep(0.3)                       # step is mid-flight
    out_ref = workflow.get_output("live-wf")
    open(release, "w").close()
    return (p.pkg.get(ref, timeout=30), p.pkg.get(out_ref, timeout=30),
            _count(marker))


def case_resume_all_skips_virtual_actors(p):
    workflow = p.workflow

    @workflow.virtual_actor
    class A:
        def __init__(self):
            self.x = 0

        def bump(self):
            self.x += 1
            return self.x

    a = A.get_or_create("actor-skip")
    a.bump.run()
    return ("actor-skip" in workflow.resume_all(),
            workflow.get_actor("actor-skip").bump.run())


def case_cancel_blocks_resume(p):
    workflow = p.workflow
    gate = p.path("cancel_gate")

    @workflow.step
    def blocked():
        if not os.path.exists(gate):
            raise RuntimeError("down")
        return 1

    crashed = _raises(lambda: blocked.step().run("cancel-wf"))[0]
    workflow.cancel("cancel-wf")
    status = workflow.get_status("cancel-wf")
    resumed = _raises(lambda: workflow.resume("cancel-wf"))
    return crashed, status, resumed, \
        "cancel-wf" in workflow.resume_all()


# -- TestWorkflowEvents -------------------------------------------------------

def case_timer_event_fires(p):
    workflow = p.workflow

    @workflow.step
    def after(evt):
        return ("done", evt)

    t = time.time() + 0.3
    out = after.step(
        workflow.wait_for_event(workflow.TimerListener, t)).run(
        workflow_id="wf_timer")
    return out[0], out[1] == t, time.time() >= t


def case_custom_listener_commit_and_replay(p):
    workflow = p.workflow
    evt_file, poll_log = p.work / "evt.txt", p.work / "polls.log"
    commit_log = p.work / "commits.log"
    evt_file.write_text("payload-1")

    class FileListener(workflow.EventListener):
        def poll_for_event(self, path):
            with open(poll_log, "a") as f:
                f.write("poll\n")
            return open(path).read()

        def event_checkpointed(self, event):
            with open(commit_log, "a") as f:
                f.write(f"commit:{event}\n")

    @workflow.step
    def crash_or_pass(evt, marker):
        import os
        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("first attempt dies")
        return evt.upper()

    ev = workflow.wait_for_event(FileListener, str(evt_file))
    node = crash_or_pass.step(ev, p.path("marker"))
    crashed = _raises(lambda: node.run(workflow_id="wf_evt"))
    polls, commits = poll_log.read_text(), commit_log.read_text()
    evt_file.write_text("payload-2")
    out = p.pkg.get(workflow.resume("wf_evt"), timeout=60)
    return ("first attempt dies" in crashed[1], polls.count("poll"),
            commits, out, poll_log.read_text().count("poll"))


CASES = [case_chain_and_fanin, case_nested_container_args,
         case_continuation, case_list_and_delete,
         case_resume_skips_finished_steps, case_resume_all,
         case_durable_counter_survives_reload, case_run_async,
         case_same_dag_object_runs_twice,
         case_get_output_waits_instead_of_relaunching,
         case_resume_all_skips_virtual_actors, case_cancel_blocks_resume,
         case_timer_event_fires, case_custom_listener_commit_and_replay]

#: The reference test's own predicates on each outcome.
EXPECTED = {
    "case_chain_and_fanin": (6, "SUCCESSFUL", 6),
    "case_nested_container_args": 90,
    "case_continuation": 500,
    "case_list_and_delete": ([("wf-a", "SUCCESSFUL"),
                              ("wf-b", "SUCCESSFUL")],
                             [("wf-b", "SUCCESSFUL")]),
    "case_resume_skips_finished_steps": ("RuntimeError", True, "RESUMABLE",
                                         15, "SUCCESSFUL", 1, 2),
    "case_resume_all": (["RuntimeError", "RuntimeError"], ["r1", "r2"],
                        ["r1", "r2"], [("r1", "SUCCESSFUL"),
                                       ("r2", "SUCCESSFUL")]),
    "case_durable_counter_survives_reload": ([101, 110, 110, 111],
                                             {"n": 111}, 3),
    "case_run_async": ([1, 2, 3, 4, 5], 5),
    "case_same_dag_object_runs_twice": (1, 1, "SUCCESSFUL"),
    "case_get_output_waits_instead_of_relaunching": ("done", "done", 1),
    "case_resume_all_skips_virtual_actors": (False, 2),
    "case_cancel_blocks_resume": (
        "RuntimeError", "CANCELED",
        ("ValueError", "workflow 'cancel-wf' was canceled"), False),
    "case_timer_event_fires": ("done", True, True),
    "case_custom_listener_commit_and_replay": (
        True, 1, "commit:payload-1\n", "PAYLOAD-1", 1),
}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_workflow_case_matches_jax(case, tmp_path):
    (want, want_layout), (got, got_layout) = both(case, tmp_path)
    assert got == want
    assert got_layout == want_layout
    assert got == ("value", EXPECTED[case.__name__])


# -- the driver killed mid-workflow -------------------------------------------

DRIVER = """
import os, sys, time
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import {pkg}
from {pkg} import workflow
{pkg}.init(num_cpus=2{init_kw})
workflow.init({store!r})

@workflow.step
def first():
    with open({cnt!r}, "ab") as f:
        f.write(b"x")
    return 7

@workflow.step
def second(x):
    while os.path.exists({block!r}):   # the driver is killed in here
        time.sleep(0.05)
    return x * 2

second.step(first.step()).run("killed-wf")
"""


def case_driver_killed(p):
    cnt, block = p.path("first_runs"), p.path("block")
    open(block, "w").close()
    script = p.work / "driver.py"
    script.write_text(DRIVER.format(
        pkg=p.name, store=p.store, cnt=cnt, block=block,
        init_kw=', device="cpu"' if p.name == PORT else ""))
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, str(script)], env=env)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and _count(cnt) != 1:
            if proc.poll() is not None:
                raise AssertionError("driver exited prematurely")
            time.sleep(0.05)
        time.sleep(0.5)    # let it enter the blocked second step
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    status = p.workflow.get_status("killed-wf")
    os.unlink(block)
    value = p.pkg.get(p.workflow.resume("killed-wf"), timeout=60)
    return status, value, p.workflow.get_status("killed-wf"), _count(cnt)


def test_driver_killed_mid_workflow_then_resume_matches_jax(tmp_path):
    (want, want_layout), (got, got_layout) = both(case_driver_killed,
                                                  tmp_path)
    assert got == want
    assert got_layout == want_layout
    assert got == ("value", ("RUNNING", 14, "SUCCESSFUL", 1))


# -- the port's own -----------------------------------------------------------

def test_default_store_is_under_the_ports_temp_dir():
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.workflow import storage
    assert storage.default_base() == os.path.join(get_config().temp_dir,
                                                  "workflows")


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_workflow")
