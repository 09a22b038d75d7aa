"""Multi-rank worlds for the port's mesh tests, run as gloo processes on
the CPU.

    python tests/torch_worlds.py <directory> <rank> <world size>

Each rank joins a gloo world through a ``file://`` store in
``directory`` (a test's ``tmp_path``: no port to collide on under
xdist), with a 60 s timeout on every collective, reads the jobs
(``jobs.json``) and the global arrays (``inputs.npz``) the test wrote,
runs the jobs on its mesh and writes ``out<rank>.npz``.  A child imports
torch, numpy and ``ray_tpu_torch`` only: never JAX or ``ray_tpu`` (a
test module would import both).

``World`` is the parent's side: it writes the inputs and starts the
ranks; ``join`` waits for them within a limit of its own (pytest-timeout
is not installed), kills the world and fails on a timeout or a rank's
error, and returns each rank's outputs.  A test computes its JAX
reference while the world runs.

Arrays travel as flat npz keys, nested dict paths joined by "/".
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List

import numpy as np

WORLD_TIMEOUT_S = 180
REPO = Path(__file__).resolve().parents[1]


# -- the parent's side ------------------------------------------------------

def flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return tree


class World:
    """A gloo world of ``size`` ranks running ``jobs`` on ``inputs``,
    started at once; :meth:`join` waits for it."""

    def __init__(self, directory, size: int, jobs: List[Dict],
                 inputs: Dict, timeout: float = WORLD_TIMEOUT_S):
        self.directory, self.size, self.timeout = Path(directory), size, \
            timeout
        (self.directory / "jobs.json").write_text(json.dumps(jobs))
        np.savez(self.directory / "inputs.npz", **flatten(inputs))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            OMP_NUM_THREADS="1")
        self.logs = [open(self.directory / f"err{r}.txt", "w+")
                     for r in range(size)]
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(self.directory), str(r),
             str(size)], env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT, cwd=REPO) for r in range(size)]

    def join(self) -> List[Dict]:
        """Each rank's outputs as a nested dict.  Raises
        ``AssertionError`` (with the ranks' output) when a rank fails or
        the world outlives its time limit, which it then ends."""
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            alive = [p for p in self.procs if p.poll() is None]
            for p in alive:
                p.kill()
            for p in alive:
                p.wait()
        report = ""
        for r, log in enumerate(self.logs):
            log.seek(0)
            report += f"--- rank {r} (rc {self.procs[r].returncode}) ---\n" \
                + log.read()[-4000:]
            log.close()
        if alive:
            raise AssertionError(f"world of {self.size} outlived "
                                 f"{self.timeout} s:\n{report}")
        if any(p.returncode != 0 for p in self.procs):
            raise AssertionError(f"a rank failed:\n{report}")
        outs = []
        for r in range(self.size):
            with np.load(self.directory / f"out{r}.npz") as f:
                outs.append(unflatten(dict(f)))
        return outs


def run_world(directory, size: int, jobs: List[Dict], inputs: Dict,
              timeout: float = WORLD_TIMEOUT_S) -> List[Dict]:
    """Runs ``jobs`` on a world of ``size`` and returns what
    :meth:`World.join` does."""
    return World(directory, size, jobs, inputs, timeout).join()


# -- the ranks' side ---------------------------------------------------------

def _top2_margin(probs) -> float:
    top = probs.detach().float().topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def _cfg(spec: Dict):
    import torch

    from ray_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(dtype=torch.float32, **spec)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _state(arrays: Dict, cfg, mesh, specs):
    from ray_tpu_torch.models.convert import train_state_from_numpy
    st = arrays["state"]
    adam = types.SimpleNamespace(count=st["count"], mu=st["mu"], nu=st["nu"])
    return train_state_from_numpy(
        {"params": st["params"], "opt": (adam,), "step": st["step"]}, cfg,
        device="cpu", mesh=mesh, specs=specs)


def _job(job: Dict, arrays: Dict, world_mesh, out: Dict) -> None:
    import torch

    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.models.convert import gather_params
    from ray_tpu_torch.models.optim import AdamW
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import shard

    name = job["name"]
    mesh = world_mesh(job["mesh"])
    res = out.setdefault(name, {})
    if job["kind"] == "ring":
        x = {k: shard(torch.from_numpy(arrays[name][k]),
                      (None, "sp", None, None), mesh)
             for k in ("q", "k", "v", "do")}
        q, k, v = (x[n].requires_grad_() for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, causal=job["causal"], mesh=mesh)
        o.backward(x["do"])
        res.update(o=o.detach().numpy(), dq=q.grad.numpy(),
                   dk=k.grad.numpy(), dv=v.grad.numpy())
        return
    if job["kind"] == "pp_refuses":
        refused = []
        for axes in ({"pp": 2, "tp": 2}, {"pp": 2, "ep": 2}):
            try:
                pipeline.make_pp_loss_fn(_cfg(job["cfg"]),
                                         world_mesh(axes), 2)
            except ValueError as e:
                refused.append(str(e))
        try:
            pipeline.make_pp_loss_fn(_cfg(dict(job["cfg"], moe_experts=4)),
                                     mesh, 2)
        except ValueError as e:
            refused.append(str(e))
        res["refused"] = np.array(len(refused))
        return

    cfg = _cfg(job["cfg"])
    batch = {"tokens": torch.from_numpy(arrays["tokens"][job["tokens"]])}
    pp = job["kind"] == "pp"
    specs = pipeline.pp_param_specs(cfg) if pp else tt.param_specs(cfg)
    if job.get("unsharded"):
        mesh = None
    state = _state(arrays[job["state"]], cfg, mesh, specs)
    if pp:
        loss = pipeline.make_pp_loss_fn(cfg, mesh, job["n_micro"])
        step = pipeline.make_pp_train_step(cfg, AdamW(), mesh,
                                           job["n_micro"])
    else:
        def loss(p, b):
            return tt.loss_fn(p, b, cfg, mesh)
        step = tt.make_train_step(cfg, AdamW(), mesh)
    with torch.no_grad():
        res["loss"] = loss(state["params"], batch).numpy()
    if "grads" in job["do"]:
        _, grads = tt.loss_and_grads(state["params"], batch, cfg, mesh)
        res["grads"] = _np(grads if mesh is None else
                           gather_params(grads, mesh, specs))
    if "step" in job["do"]:
        _, metrics = step(state, batch)
        res["step_loss"] = metrics["loss"].numpy()
        res["grad_norm"] = metrics["grad_norm"].numpy()
        for key, tree in (("params", state["params"]),
                          ("mu", state["opt"]["mu"]),
                          ("nu", state["opt"]["nu"])):
            res[key] = _np(tree if mesh is None else
                           gather_params(tree, mesh, specs))


def _rank_main(directory: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    torch.set_num_threads(1)
    directory = Path(directory)
    jobs = json.loads((directory / "jobs.json").read_text())
    with np.load(directory / "inputs.npz") as f:
        arrays = unflatten(dict(f))
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    meshes: Dict = {}

    def world_mesh(axes: Dict):
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = build_mesh(MeshConfig(**axes), device="cpu")
        return meshes[key]

    margins: List[float] = []
    route = moe.route

    def recording_route(*args, **kwargs):
        out = route(*args, **kwargs)
        margins.append(_top2_margin(out[0]))
        return out
    moe.route = recording_route
    out: Dict = {}
    try:
        for job in jobs:
            _job(job, arrays, world_mesh, out)
        out["margin"] = np.array(min(margins) if margins else np.inf)
        np.savez(directory / f"out{rank}.npz", **flatten(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
