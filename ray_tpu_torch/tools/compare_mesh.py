"""The train step without a mesh, on a mesh of one and on the GPipe
schedule, in turns on the card.

    python -m ray_tpu_torch.tools.compare_mesh [--rounds 2] [--reps 10]

Starts a NCCL world of one (a ``file://`` store in a temporary
directory) and builds three train steps at ``bench_model.py``'s config
and batch (``ray_tpu_torch.models.bench``), each from the same weights:
``chip_smoke.py``'s T2 (no mesh), P2 (the mesh of one) and P3 (the GPipe
schedule of ``parallel.pipeline`` with pp = 1 and ``MICRO``
microbatches).  After one warm-up step each, every round runs them in
turns, T2, P2, P3, P3, P2, T2, ``--reps`` steps a turn, and prints the
host-clock ms per step of each turn; then one profiled step of each: the
device time summed over its operations, the device's idle share against
the median wall, and the operations launched.  A mesh on the card has
one rank (one H100; NCCL puts no two ranks on one device).  Needs a CUDA
device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import datetime
import shutil
import statistics
import tempfile
import time

MICRO = 4


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import bench
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.tools.timing import card, device_profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_mesh: needs a CUDA device")
    print(card(), flush=True)
    store = tempfile.mkdtemp(prefix="compare_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = build_mesh(MeshConfig())
        runs = {
            "T2 (no mesh)": bench.make_train("cuda"),
            "P2 (mesh of one)": bench.make_train("cuda", mesh=mesh),
            f"P3 (GPipe, pp 1, {MICRO} microbatches)":
                bench.make_pp_train(mesh, MICRO, "cuda")[:3],
        }
        for state, step, batch in runs.values():
            step(state, batch)
        walls = {name: [] for name in runs}
        order = list(runs) + list(runs)[::-1]
        for _ in range(args.rounds):
            for name in order:
                state, step, batch = runs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    step(state, batch)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) / args.reps
                                   * 1e3)
        for name, (state, step, batch) in runs.items():
            device_ms, ops = device_profile(lambda: step(state, batch))
            wall = statistics.median(walls[name])
            print(f"{name}: ms per step by turn "
                  f"{[round(w, 3) for w in walls[name]]}, median {wall:.3f}; "
                  f"device {device_ms:.3f} ms, idle share "
                  f"{max(0.0, 1 - device_ms / wall):.3f}, {ops:.0f} device "
                  f"operations a step ({1e3 * wall / ops:.1f} us of wall "
                  f"each)", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
