"""X1 and X2: tasks, actors, runtime envs and a Train step in worker
processes on the card.

    python -m ray_tpu_torch.tools.profile_process [--phase x1|x2|both]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``process_workers`` (X1): ``init(num_cpus=4, num_gpus=1,
  _system_config={"worker_process_mode": "process", ...})`` on
  ``device``, then

  (a) a burst of ``X1_TASKS`` tasks of one function in two scheduling
      classes (``num_cpus`` 1 and 2, alternating), after a warm-up that
      waits for the prestarted children: every result its index, every
      task run in a process other than the driver's; tasks/s, the
      submit-to-sealed p50 and p99 (a ``get_async`` on the owner's
      memory store), and each child's ms from spawn to registration;
      the raylet's batched ticks and ``class_fill`` launches are counted
      from the warm-up to the ``shutdown`` (so (b) and (c)'s leases
      too);
  (b) an actor of ``num_gpus=0.5`` in a process worker that takes
      ``models/bench.py``'s weights as one object of host forms and
      builds the model on the card, then answers ``X1_FORWARDS``
      forwards at the bench batch (tokens from ``TOKEN_SEED + i``): the
      logits at every ``LOGIT_STRIDE``-th position (all rows, the whole
      vocabulary) come back as a CPU tensor of the model's dtype
      (ROADMAP C.37), each within ``FORWARD_REL_TOL`` relative RMS (M2's
      tolerance) of the driver's own forward on the same weights and
      tokens; ms a call seen by the driver and ms a forward inside the
      child, and the flash launches in the child;
  (c) inside process workers: a nested ``.remote``, ``put``/``get``/
      ``wait``, an actor created from a task, a nested user error that
      reaches the driver as its own type, a ``runtime_env`` env var seen
      in the worker, the children's modules (no JAX, no ``ray_tpu``), a
      child's print on the ``worker_logs`` channel, and a killed
      worker's owned object raising ``OwnerDiedError`` to a borrower;

  after ``shutdown`` no child of the pool is alive and no thread of the
  port is left.  Then the same burst on thread workers, in an ``init``
  of its own, for its tasks/s and latency beside (a)'s.
* ``train_pg`` (X2): ``Trainer(backend="torch", num_workers=2,
  use_gpu=True, resources_per_worker={"GPU": 0.5})`` under a process
  ``init``: ``TorchConfig`` joins the two worker processes by a real
  gloo process group; each runs ``profile_air.dp_train_loop`` on its
  half of T2's batch with ``torch.distributed.all_reduce`` of the
  flattened gradients in place on the card's buffer (gloo copies it
  through the host), 1 warm-up and 4 timed steps.  Held to the whole-batch
  step as L1 is (``profile_air.hold_to_whole_batch``); the step's p50,
  the allreduce's share, tokens/s and the flash launches of each child.

``device="cpu"`` rehearses a phase at a small ``cfg`` and batch (the
kernels' plain versions; no launch is counted on the CPU).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

X1_CPUS = 4
X1_TASKS = 2_000
X1_FORWARDS = 4
#: Every LOGIT_STRIDE-th position's logits come back from a forward.
LOGIT_STRIDE = 64
#: M2's tolerance: relative RMS of the logits against the reference.
FORWARD_REL_TOL = 0.05
X2_STEPS = 5
#: The process phases' pool: at most 4 children starting at once, 8 idle.
PROCESS_CONFIG = {"worker_process_mode": "process",
                  "maximum_startup_concurrency": 4,
                  "num_workers_soft_limit": 8}
_LOG_MARKER = "X1_LOG_LINE_MARKER"


def _where(i):
    return os.getpid(), i


def _double(x):
    return 2 * x


def _nested(x):
    import ray_tpu_torch as rt
    return rt.get(rt.remote(_double).remote(x), timeout=60), os.getpid()


def _api_inside():
    import ray_tpu_torch as rt
    ref = rt.put(np.arange(10))
    ready, rest = rt.wait([ref], num_returns=1, timeout=10)
    return float(rt.get(ref, timeout=60).sum()), len(ready), len(rest)


class Counter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


def _actor_from_task():
    import ray_tpu_torch as rt
    c = rt.remote(Counter).remote()
    return [rt.get(c.bump.remote(), timeout=60) for _ in range(3)]


def _raise_key():
    raise KeyError("x1-inner")


def _nested_error():
    import ray_tpu_torch as rt
    return rt.get(rt.remote(_raise_key).remote(), timeout=60)


def _env_probe():
    return os.environ.get("X1_ENV"), os.getpid()


def _modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "ray_tpu") or m.startswith("jax.")
                  or m.startswith("ray_tpu."))


def _shout(marker):
    print(marker)
    return os.getpid()


def _make_owned():
    import ray_tpu_torch as rt
    return [rt.put(np.ones(500_000, dtype=np.float64))], os.getpid()


class ModelServer:
    """X1(b)'s actor: the model from host-form weights on ``device``."""

    def __init__(self, cfg, weights, device):
        from ray_tpu_torch.models.transformer import Transformer
        self.dev = torch.device(device)
        self.model = Transformer(cfg, params=_tree_to(weights, self.dev),
                                 device=self.dev)

    def forward(self, tokens, stride):
        fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        before = fa.flash_attention.launches
        toks = torch.from_numpy(tokens).to(self.dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self.model(toks)
        _sync(self.dev)
        ms = (time.perf_counter() - t0) * 1e3
        return {"logits": logits[:, ::stride], "ms": ms,
                "device": str(logits.device), "pid": os.getpid(),
                "flash": fa.flash_attention.launches - before}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init(device, system_config=None):
    import ray_tpu_torch as rt
    rt.init(num_cpus=X1_CPUS, num_gpus=1, device=device,
            _system_config=system_config)


def _check_gone(name: str, pids: List[int]):
    """No child of the pool outlived the shutdown (each was reaped)."""
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        alive.append(pid)
    if alive:
        raise AssertionError(f"{name}: worker processes outlived shutdown: "
                             f"{alive}")


def _burst(name: str, n_tasks: int, process: bool) -> Tuple[Dict, tuple]:
    """(a): the burst on the running cluster; its numbers, and the
    counters' values before it for ``_count_ticks``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.tools.profile_tasks import _percentiles
    core = global_worker().core_worker
    fns = [rt.remote(_where).options(num_cpus=1),
           rt.remote(_where).options(num_cpus=2)]
    # Read before any lease: a tick is counted as it starts and its
    # launch after, so a snapshot taken while one runs splits them.  The
    # solver is made at the first batched tick.
    ctm = global_worker().cluster.head_node.cluster_task_manager
    counts = (ctm, _ticks(ctm), cf.class_fill.launches)
    # Warm-up: every prestarted child registered and took a task.
    warm = rt.get([fns[i % 2].remote(i) for i in range(4 * X1_CPUS)],
                  timeout=300)
    if [v[1] for v in warm] != list(range(4 * X1_CPUS)):
        raise AssertionError(f"{name}: a warm-up task returned {warm}")
    submitted = np.zeros(n_tasks)
    ready = np.full(n_tasks, np.nan)

    def on_sealed(j):
        def cb(_entry):
            ready[j] = time.perf_counter()
        return cb
    refs = []
    t0 = time.perf_counter()
    for i in range(n_tasks):
        submitted[i] = time.perf_counter()
        ref = fns[i % 2].remote(i)
        core.memory_store.get_async(ref.object_id(), on_sealed(i))
        refs.append(ref)
    values = rt.get(refs, timeout=600)
    wall = time.perf_counter() - t0
    if [v[1] for v in values] != list(range(n_tasks)):
        raise AssertionError(f"{name}: a result is not its index")
    pids = {v[0] for v in values}
    me = os.getpid()
    if process and me in pids:
        raise AssertionError(f"{name}: a task ran in the driver's process")
    if not process and pids != {me}:
        raise AssertionError(f"{name}: a thread worker's task ran in "
                             f"another process: {pids}")
    if np.isnan(ready).any():
        raise AssertionError(f"{name}: a result was read before it was "
                             "sealed")
    p50, p99 = _percentiles((ready - submitted) * 1e3)
    return {"tasks": n_tasks, "classes": 2, "wall_s": wall,
            "tasks_per_s": n_tasks / wall, "latency_p50_ms": p50,
            "latency_p99_ms": p99, "worker_pids": len(pids)}, counts


def _count_ticks(out: Dict, counts) -> None:
    """The burst's batched ticks and ``class_fill`` launches, read once
    the raylet's loop stopped (a tick in flight at the last result has
    counted its launch and not yet itself)."""
    from ray_tpu_torch.ops import class_fill as cf
    ctm, ticks0, launches0 = counts
    out["batched_ticks"] = _ticks(ctm) - ticks0
    out["launches"] = cf.class_fill.launches - launches0


def _ticks(ctm) -> int:
    """The batched ticks of a raylet's cluster task manager so far."""
    return ctm._solver.stats["ticks"] if ctm._solver is not None else 0


def _model_actor(device, cfg, batch, seq, n_calls) -> Dict:
    """(b) on the running cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.models.transformer import Transformer
    dev = torch.device(device)
    model = Transformer(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(mb.PARAM_SEED))
    weights = rt.put(_tree_to(model.params(), torch.device("cpu")))
    t0 = time.perf_counter()
    server = rt.remote(num_gpus=0.5)(ModelServer).remote(cfg, weights,
                                                          device)
    calls = []
    for i in range(n_calls):
        tokens = np.random.default_rng(mb.TOKEN_SEED + i).integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int64)
        c0 = time.perf_counter()
        out = rt.get(server.forward.remote(tokens, LOGIT_STRIDE),
                     timeout=600)
        call_ms = (time.perf_counter() - c0) * 1e3
        if i == 0:
            start_s = time.perf_counter() - t0
        got = out["logits"]
        if got.device.type != "cpu" or got.dtype != cfg.dtype:
            raise AssertionError(f"X1(b): logits arrived as {got.dtype} on "
                                 f"{got.device}, not the host form")
        if out["device"].split(":")[0] != dev.type or \
                out["pid"] == os.getpid():
            raise AssertionError(f"X1(b): the forward ran on "
                                 f"{out['device']} in pid {out['pid']}")
        d0 = time.perf_counter()
        with torch.no_grad():
            want = model(torch.from_numpy(tokens).to(dev))[:, ::LOGIT_STRIDE]
        _sync(dev)
        driver_ms = (time.perf_counter() - d0) * 1e3
        want = want.float().cpu()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("X1(b): non-finite logits")
        rel = float((got.float() - want).norm() / want.norm())
        if rel > FORWARD_REL_TOL:
            raise AssertionError(f"X1(b): forward {i} is {rel} relative RMS "
                                 f"off the driver's (tolerance "
                                 f"{FORWARD_REL_TOL})")
        calls.append({"call_ms": call_ms, "child_ms": out["ms"],
                      "driver_ms": driver_ms, "rel_rms": rel,
                      "flash": out["flash"]})
    rt.kill(server)
    return {"forwards": n_calls, "batch": batch, "seq": seq,
            "start_s": start_s, "calls": calls,
            "call_ms_p50": float(np.median([c["call_ms"] for c in calls])),
            "child_ms_p50": float(np.median([c["child_ms"] for c in calls])),
            "driver_ms_p50": float(np.median([c["driver_ms"]
                                              for c in calls])),
            "max_rel_rms": max(c["rel_rms"] for c in calls),
            "flash_launches": sum(c["flash"] for c in calls),
            "logit_bytes": int(got.numel() * got.element_size())}


def _api_checks() -> Dict:
    """(c) on the running cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private import log_monitor
    from ray_tpu_torch._private.worker import global_worker
    me = os.getpid()
    out = {}
    doubled, pid = rt.get(rt.remote(_nested).remote(21), timeout=120)
    if doubled != 42 or pid == me:
        raise AssertionError(f"X1(c): nested remote gave {doubled} in {pid}")
    if rt.get(rt.remote(_api_inside).remote(), timeout=120) != (45.0, 1, 0):
        raise AssertionError("X1(c): put/get/wait inside a worker")
    if rt.get(rt.remote(_actor_from_task).remote(), timeout=120) != \
            [1, 2, 3]:
        raise AssertionError("X1(c): an actor created from a task")
    try:
        rt.get(rt.remote(_nested_error).remote(), timeout=120)
        raise AssertionError("X1(c): the nested error did not arrive")
    except KeyError as e:
        out["nested_error"] = type(e).__name__
    env_val, env_pid = rt.get(rt.remote(runtime_env={
        "env_vars": {"X1_ENV": "card"}})(_env_probe).remote(), timeout=300)
    if env_val != "card" or env_pid == me:
        raise AssertionError(f"X1(c): runtime_env gave {env_val!r} in "
                             f"{env_pid}")
    mods = rt.get(rt.remote(_modules).remote(), timeout=120)
    if mods:
        raise AssertionError(f"X1(c): a worker imported {mods}")
    seen = []
    pub = global_worker().cluster.gcs.publisher
    sub = pub.subscribe(log_monitor.LOG_CHANNEL, None,
                        lambda _k, msg: seen.extend(msg["lines"]))
    try:
        marker = f"{_LOG_MARKER}_{me}"
        rt.get(rt.remote(_shout).remote(marker), timeout=120)
        deadline = time.monotonic() + 10
        while not any(marker in ln for ln in seen):
            if time.monotonic() > deadline:
                raise AssertionError("X1(c): a child's print never reached "
                                     "the worker_logs channel")
            time.sleep(0.05)
    finally:
        pub.unsubscribe(log_monitor.LOG_CHANNEL, None, sub)
    [inner], owner = rt.get(rt.remote(_make_owned).remote(), timeout=120)
    if rt.get(inner, timeout=60)[0] != 1.0:
        raise AssertionError("X1(c): the owned object is wrong")
    os.kill(owner, signal.SIGKILL)
    t0 = time.monotonic()
    while True:
        try:
            rt.get(inner, timeout=2.0)
        except exceptions.OwnerDiedError:
            break
        except exceptions.GetTimeoutError:
            pass
        if time.monotonic() - t0 > 30:
            raise AssertionError("X1(c): the borrower never saw "
                                 "OwnerDiedError")
    out.update(owner_died_ms=(time.monotonic() - t0) * 1e3,
               child_modules=mods, runtime_env="card")
    return out


def process_workers(device="cuda", cfg=None, batch=None, seq=None,
                    n_tasks=X1_TASKS, n_calls=X1_FORWARDS) -> Dict:
    """X1 (module docstring).  ``cfg``, ``batch`` and ``seq`` (the bench
    model's by default) shrink (b) for a CPU rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.profile_tasks import (_check_clean, _Members,
                                                   _tick_totals)
    cfg = cfg or mb.CONFIG
    batch = batch or mb.BATCH
    seq = seq or mb.SEQ
    t0 = time.perf_counter()
    _init(device, PROCESS_CONFIG)
    try:
        cluster = global_worker().cluster
        pool = cluster.head_node.worker_pool
        burst, counts = _burst("X1(a)", n_tasks, process=True)
        model = _model_actor(device, cfg, batch, seq, n_calls)
        api = _api_checks()
        pids = list(pool.spawned_pids)
        registered_ms = [s * 1e3 for s in pool.registered_s]
        members = _Members(cluster.raylets())
    finally:
        rt.shutdown()
    _count_ticks(burst, counts)
    _check_clean("X1", _tick_totals(members)[1])
    _check_gone("X1", pids)
    check_no_threads("X1")
    wall = time.perf_counter() - t0
    _init(device)
    try:
        cluster = global_worker().cluster
        threads, counts = _burst("X1(a) threads", n_tasks, process=False)
        members = _Members(cluster.raylets())
    finally:
        rt.shutdown()
    _count_ticks(threads, counts)
    _check_clean("X1 threads", _tick_totals(members)[1])
    check_no_threads("X1 threads")
    if torch.device(device).type == "cuda":
        for label, b in (("process", burst), ("thread", threads)):
            if b["launches"] < 1 or b["launches"] != b["batched_ticks"]:
                raise AssertionError(
                    f"X1(a) {label}: class_fill launched {b['launches']} "
                    f"times for {b['batched_ticks']} batched ticks")
        if model["flash_launches"] != n_calls * cfg.n_layers:
            raise AssertionError(f"X1(b): {model['flash_launches']} flash "
                                 f"launches for {n_calls} forwards")
    return {"process": burst, "threads": threads, "model": model,
            "api": api, "children": len(pids),
            "spawn_to_registered_ms": registered_ms,
            "process_wall_s": wall}


def train_pg(device="cuda", cfg=None, steps=X2_STEPS, tokens=None) -> Dict:
    """X2 (module docstring).  ``cfg`` and ``tokens`` shrink it for a CPU
    rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cfg = cfg or mb.CONFIG
    dev = torch.device(device)
    tokens = (mb.train_tokens("cpu", cfg).numpy() if tokens is None
              else np.asarray(tokens))
    _init(device, PROCESS_CONFIG)
    try:
        pool = global_worker().cluster.head_node.worker_pool
        launches0 = cf.class_fill.launches
        trainer = train.Trainer(backend="torch", num_workers=pair.WORLD,
                                use_gpu=True,
                                resources_per_worker={"GPU": pair.GPU_SHARE})
        t0 = time.perf_counter()
        trainer.start()
        start_s = time.perf_counter() - t0
        executor = trainer._executor
        if not executor._started_config._real_pg:
            raise AssertionError("X2: TorchConfig took the collective route")
        ranks = executor.worker_group.execute(os.getpid)
        if len(set(ranks)) != pair.WORLD or os.getpid() in ranks:
            raise AssertionError(f"X2: the ranks ran in {ranks}")
        config = {"cfg": cfg, "device": device, "seed": mb.PARAM_SEED,
                  "tokens": tokens, "steps": steps, "report_grad": True,
                  "allreduce": "process_group"}
        t0 = time.perf_counter()
        rounds = list(trainer.run_iterator(pair.dp_train_loop, config))
        run_s = time.perf_counter() - t0
        trainer.shutdown()
        launches = cf.class_fill.launches - launches0
        pids = list(pool.spawned_pids)
    finally:
        rt.shutdown()
    _check_gone("X2", pids)
    check_no_threads("X2")
    if len(rounds) != steps:
        raise AssertionError(f"X2: {len(rounds)} report rounds for {steps} "
                             "steps")
    held = pair.hold_to_whole_batch("X2", rounds, tokens, cfg, dev, steps)
    flash = [{"forward": sum(r["flash_forward"] for r in reports),
              "backward": sum(r["flash_backward"] for r in reports)}
             for reports in rounds]
    want_fwd = pair.WORLD * cfg.n_layers * (2 if cfg.remat else 1)
    if dev.type == "cuda" and any(
            f != {"forward": want_fwd,
                  "backward": pair.WORLD * cfg.n_layers} for f in flash):
        raise AssertionError(f"X2: flash launches a step {flash}, expected "
                             f"{want_fwd} forward and "
                             f"{pair.WORLD * cfg.n_layers} backward")
    return {"steps": steps, "world": pair.WORLD,
            "start_s": start_s, "run_s": run_s, "rank_pids": len(set(ranks)),
            **pair.step_times(rounds, tokens.shape[0], tokens.shape[1] - 1),
            **held, "flash_per_step": flash[-1],
            "flash_forward": sum(f["forward"] for f in flash),
            "flash_backward": sum(f["backward"] for f in flash),
            "class_fill": launches}


PHASES = {"x1": process_workers, "x2": train_pg}


def main(argv=None) -> int:
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=sorted(PHASES) + ["both"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses on the plain kernels")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_process: needs a CUDA device")
        print(card(), flush=True)
        # Built once here: the worker processes load the same libraries.
        from ray_tpu_torch.ops import _build
        _build.build("class_fill.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu")
    names = sorted(PHASES) if args.phase == "both" else [args.phase]
    for name in names:
        t0 = time.perf_counter()
        out = PHASES[name](args.device)
        print(json.dumps({"phase": name.upper(),
                          "wall_s": time.perf_counter() - t0, **out},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
