"""C2's host time by thread, with the GCS's new host work stubbed out in
turn.

    python -m ray_tpu_torch.tools.profile_host [RUN ...] [--tasks 100000]
        [--device cuda]

Each RUN is ``ROOT:MODE`` (default: ``build/parent:all .:all .:noev
.:nohb .:nohb .:noev .:all build/parent:all``): ROOT is the root of a
checkout (this tree's, or a parent's unpacked with ``git archive``) and
MODE is ``all`` (the checkout as it is), ``noev`` (``TaskEventBuffer.emit``
a no-op: no task event is buffered, flushed or ingested) or ``nohb``
(no raylet beats and the GCS checks nothing).  Each run is C2
(``profile_tasks.cluster_tasks`` over 64 raylets, its E1 check left out)
in a process of its own, and prints one JSON line: tasks/s, the wall,
the submit-to-sealed p50, and the CPU seconds of each group of threads
(raylet loops, heartbeats, the GCS loop, workers, the task-event
flusher, the driver), read from ``/proc/self/task`` every 0.25 s.
Runs in turns put every mode under the same state of the card and the
host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_RUNS = ("build/parent:all", ".:all", ".:noev", ".:nohb",
                ".:nohb", ".:noev", ".:all", "build/parent:all")

_CHILD = """
import collections, json, os, re, sys, threading, time
from ray_tpu_torch.tools import profile_tasks as pt
mode = {mode!r}
if hasattr(pt, "task_events"):
    pt.task_events = lambda *a, **k: None
if mode == "noev":
    from ray_tpu_torch.gcs import task_events as te
    te.TaskEventBuffer.emit = lambda self, *a, **k: None
if mode == "nohb":
    from ray_tpu_torch._private import raylet as rl
    from ray_tpu_torch.gcs import server
    rl.Raylet._heartbeat_loop = lambda self, period_s: None
    server.GcsHeartbeatManager._tick = lambda self: None
cpu, names, stop = {{}}, {{}}, threading.Event()
tck = os.sysconf("SC_CLK_TCK")
def sample():
    while not stop.wait(0.25):
        for t in threading.enumerate():
            if t.native_id:
                names[t.native_id] = t.name
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{{tid}}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            cpu[int(tid)] = (int(fields[11]) + int(fields[12])) / tck
threading.Thread(target=sample, daemon=True, name="sampler").start()
out = pt.cluster_tasks({tasks}, pt.C2_RAYLETS, {device!r})
stop.set()
by = collections.Counter()
for tid, s in cpu.items():
    name = re.sub(r"::[0-9a-f]{{6,}}.*$|-[0-9a-f]{{6}}$", "",
                  names.get(tid, "other"))
    by[name] += s
print(json.dumps({{"tasks_per_s": out["tasks_per_s"],
                  "wall_s": out["wall_s"],
                  "p50_ms": out["latency_p50_ms"],
                  "cpu_s": dict(by.most_common())}}))
"""


def run(root: str, mode: str, tasks: int, device: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run(
        [sys.executable, "-c",
         _CHILD.format(mode=mode, tasks=tasks, device=device)],
        cwd=root, env=env, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}:{mode}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("runs", nargs="*", default=list(DEFAULT_RUNS))
    parser.add_argument("--tasks", type=int, default=100_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        from ray_tpu_torch.tools.timing import card
        print(card(), flush=True)
    for spec in args.runs:
        root, mode = spec.rsplit(":", 1)
        if mode not in ("all", "noev", "nohb"):
            parser.error(f"unknown mode {mode!r} in {spec!r}")
        print(json.dumps({"root": root, "mode": mode,
                          **run(root, mode, args.tasks, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
