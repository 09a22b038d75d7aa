"""R3 and C2 of several checkouts of this repository, in turns on one card.

    python -m ray_tpu_torch.tools.compare_runtime ROOT_A ROOT_B
        [--order ABBA] [--leases 20000] [--tasks 100000]

Each ROOT is the root of a checkout (this tree's, or a parent's unpacked
with ``git archive``).  For each letter of ``--order`` the checkout it
names runs, in a process of its own with that root first on the path,
``chip_smoke.py``'s R3 (``profile_cluster.cluster_burst`` at
``--leases``) and then C2 (``profile_tasks.cluster_tasks`` at
``--tasks`` over 64 raylets), both on the card; one JSON line a run gives
the root, R3's leases/s and wall, and C2's tasks/s, wall and p50/p99.
Runs in turns (A B B A) put both checkouts under the same state of the
card and the host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = """
import json, sys, time
from ray_tpu_torch.tools import profile_cluster as pc
from ray_tpu_torch.tools import profile_tasks as pt
r3 = pc.cluster_burst({leases}, "cuda")
c2 = pt.cluster_tasks({tasks}, pt.C2_RAYLETS, "cuda")
print(json.dumps({{"r3_leases_per_s": r3["leases_per_s"],
                  "r3_wall_s": r3["wall_s"],
                  "c2_tasks_per_s": c2["tasks_per_s"],
                  "c2_wall_s": c2["wall_s"],
                  "c2_p50_ms": c2["latency_p50_ms"],
                  "c2_p99_ms": c2["latency_p99_ms"],
                  "c2_events": c2.get("events")}}))
"""


def run(root: str, leases: int, tasks: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(leases=leases, tasks=tasks)],
        cwd=root, env=env, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--order", default="ABBA")
    parser.add_argument("--leases", type=int, default=20_000)
    parser.add_argument("--tasks", type=int, default=100_000)
    args = parser.parse_args(argv)
    print(card(), flush=True)
    for letter in args.order:
        root = args.roots[ord(letter) - ord("A")]
        print(json.dumps({"root": root,
                          **run(root, args.leases, args.tasks)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
