"""S1, S2 and N1: the transformer served by ``ray_tpu_torch.serve`` from
replicas the pack solve places, serve's autoscaler placing through that
solve on R3's cluster, and the model swept by ``ray_tpu_torch.tune``.

    python -m ray_tpu_torch.tools.profile_serve [--phase s1|s2|n1|all]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``serve_model`` (S1): ``init`` on the card (its ``GPU`` counted) with
  ``serve_kernel_placement="force"``, ``serve.start`` with the HTTP proxy
  on loopback, then :class:`ModelServer` (``bench_model.py``'s model,
  weights from ``PARAM_SEED``) as a class deployment of 2 replicas at
  ``{"num_gpus": 0.5}``, placed by the controller's ``_kernel_place``
  (the pack-mode solve on the card).  Its weights are deployed as two
  ``ObjectRef``s of CUDA tensors (the model-dtype leaves and the float32
  norms, each flattened into one tensor): each replica takes the
  node store's device object, with no host copy, and views it as the
  parameter tree.  ``@serve.batch(max_batch_size=8)`` runs concurrent
  requests of 1,024 tokens as one forward of [<= 8, 1024].  8 clients
  send 64 requests, 4 of them through a handle and 4 over HTTP.  Each
  reply is the last position's argmax and its log-probability, with the
  ids of the batch it ran in; each is held to ``forward`` called
  directly on that batch's tokens (``profile_air.PRED_ATOL``, every
  argmax equal).  Reports requests/s, latency p50/p99, the mean batch
  fill, the kernel's placements, and the ``class_fill`` (batched ticks
  plus pack solves) and flash forward launches.
* ``autoscale`` (S2): R3's 64 raylets under ``init`` (``profile_gcs``'s
  cluster), serve's default ``serve_kernel_placement="auto"``, and
  ``tests/test_serve.py``'s soak shape (``:828-887``): a deployment of
  2 to 4 replicas under the queue-depth autoscaler, ``@serve.batch(
  max_batch_size=4, latency_budget_s=0.25)`` around a 50 ms body, 8
  clients of 25 requests each through a handle; its downscale delay is
  the queue-depth step's (``:739-826``), 0.8 s.  Checks: every request
  answered once with its own value, at least one scale-up placed by the
  kernel solve, and a scale-down to 2 once the load is gone.  Reports the
  time from the step (the clients' start) to a new replica's first
  reply, requests/s, and the ``class_fill`` launches.
* ``tune_model`` (N1): ``ml.Tuner`` over L2's ``DataParallelTrainer``
  (``profile_air.dp_train_loop``) with ``param_space={"lr":
  grid_search(N1_LRS)}``: 2 trials at once, each 1 worker of ``{"CPU":
  1, "GPU": 0.5}`` and 2 steps of L2's batch (16 sequences of 1,025
  tokens).  Each trial's loss is held to the same trainer run directly
  with its config (``profile_air.LOSS_ATOL``), and ``best_config`` must
  be that of the lower loss.  Reports each trial's loop wall and the
  sweep's, and the flash forward, backward and ``class_fill`` launches
  of the sweep.

``device="cpu"`` rehearses a phase at a small ``cfg`` (the kernels' plain
versions, no launch counted).
"""

from __future__ import annotations

import argparse
import importlib
import json
import threading
import time
import urllib.request
import uuid
from typing import Dict, List

import numpy as np
import torch

from ray_tpu_torch import serve

#: S1: replicas, each one's share of the card, the batch, the requests,
#: the clients (the first half through a handle, the rest over HTTP),
#: the batch's wait and the tokens' seed.
S1_REPLICAS, S1_GPU_SHARE, S1_BATCH = 2, 0.5, 8
S1_REQUESTS, S1_CLIENTS, S1_WAIT_S, S1_SEED = 64, 8, 0.02, 13
#: S2: the soak's clients and requests a client, its replica bounds and
#: batch, the body's sleep, and the step's downscale delay.
S2_CLIENTS, S2_PER_CLIENT = 8, 25
S2_MIN, S2_MAX, S2_BATCH, S2_BODY_S, S2_DOWNSCALE_S = 2, 4, 4, 0.05, 0.8
#: N1: the learning rates swept, the trials' share of the card, and L2's
#: batch: 2 blocks of 16 sequences (one step a block).
N1_LRS = (3e-4, 3e-3)
N1_GPU_SHARE, N1_SEQS, N1_BLOCKS, N1_SEED = 0.5, 32, 2, 11
WALL_S = 600.0


# -- the weights as device objects -------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _is_norm(path) -> bool:
    return path[-1].startswith("ln")


def pack_weights(params):
    """``params`` as two flat tensors on their device (the model-dtype
    leaves, the float32 norms) and the layout that views them back:
    ``(weights, norms, layout)``."""
    parts = {False: [], True: []}
    layout = []
    offsets = {False: 0, True: 0}
    for path, t in _paths(params):
        norm = _is_norm(path)
        parts[norm].append(t.reshape(-1))
        layout.append((path, norm, offsets[norm], tuple(t.shape)))
        offsets[norm] += t.numel()
    return torch.cat(parts[False]), torch.cat(parts[True]), layout


def unpack_weights(weights, norms, layout) -> Dict:
    """The parameter tree as views of ``weights`` and ``norms``."""
    tree: Dict = {}
    for path, norm, offset, shape in layout:
        flat = norms if norm else weights
        n = int(np.prod(shape)) if shape else 1
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[offset:offset + n].view(shape)
    return tree


# -- S1 ------------------------------------------------------------------------

def _request(r) -> Dict:
    body = getattr(r, "json", None)
    return body() if callable(body) else r


class ModelServer:
    """S1's deployment: the model's forward over a batch of requests
    ``{"id", "tokens"}``, each answered with the last position's argmax
    and log-probability and the ids of its batch."""

    def __init__(self, weights, norms, layout, cfg):
        self.device = weights.device
        self.weights_ptr = weights.data_ptr()
        self.params = unpack_weights(weights, norms, layout)
        self.cfg = cfg

    def weights_info(self):
        import ray_tpu_torch as rt
        return {"device": str(self.device), "data_ptr": self.weights_ptr,
                "node": rt.get_runtime_context().get_node_id()}

    @serve.batch(max_batch_size=S1_BATCH, batch_wait_timeout_s=S1_WAIT_S)
    def __call__(self, requests):
        from ray_tpu_torch.models import transformer as tt
        t0 = time.perf_counter()
        reqs = [_request(r) for r in requests]
        ids = [int(r["id"]) for r in reqs]
        tokens = torch.tensor([r["tokens"] for r in reqs], dtype=torch.int64,
                              device=self.device)
        with torch.no_grad():
            last = tt.forward(self.params, tokens, self.cfg)[:, -1].float()
            logp = torch.log_softmax(last, dim=-1)
            best, arg = logp.max(dim=-1)
        best, arg = best.cpu().tolist(), arg.cpu().tolist()
        ms = (time.perf_counter() - t0) * 1e3
        return [{"id": i, "argmax": int(a), "logprob": float(b),
                 "batch": ids, "batch_ms": ms}
                for i, a, b in zip(ids, arg, best)]


def _counts(raylets):
    """The kernels' launch counts, the pack solves (each launches
    ``class_fill`` on the card) and the raylets' batched ticks (each
    launches it too)."""
    from ray_tpu_torch.autoscaler import resource_demand_scheduler as rds
    from ray_tpu_torch.ops import class_fill as cf
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    solvers = [r.cluster_task_manager._solver for r in raylets]
    return {"class_fill": cf.class_fill.launches,
            "pack_solves": rds.kernel_stats["kernel_solves"],
            "batched_ticks": sum(s.stats["ticks"] for s in solvers if s),
            "flash_forward": fa.flash_attention.launches,
            "flash_backward": fa.flash_attention_backward.launches}


def _since(before: Dict, raylets) -> Dict:
    now = _counts(raylets)
    return {k: now[k] - before[k] for k in before}


def _post(port, path, payload, timeout=120.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _check_raylets(name, raylets):
    from ray_tpu_torch.tools.profile_tasks import (_check_clean, _Members,
                                                  _tick_totals)
    _check_clean(name, _tick_totals(_Members(raylets))[1])


def serve_model(device="cuda", cfg=None, seq=None,
                n_requests=S1_REQUESTS, clients=S1_CLIENTS):
    """S1 (module docstring).  ``cfg`` (``bench.CONFIG`` by default) and
    ``seq`` (its ``SEQ``) shrink it for a CPU rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.tools.profile_air import PRED_ATOL, _init
    cfg = cfg or mb.CONFIG
    seq = seq or mb.SEQ
    dev = torch.device(device)
    tokens = np.random.default_rng(S1_SEED).integers(
        0, cfg.vocab_size, (n_requests, seq)).astype(np.int64)
    params = tt.init_params(
        torch.Generator(device=dev).manual_seed(mb.PARAM_SEED), cfg,
        device=dev)
    weights, norms, layout = pack_weights(params)
    _init(device, serve_kernel_placement="force")
    try:
        cluster = global_worker().cluster
        raylets = cluster.raylets()
        head = cluster.head_node.node_id.hex()
        before = _counts(raylets)
        serve.start(http_options={"host": "127.0.0.1", "port": 0})
        controller = serve.api._get_controller()
        port = rt.get(rt.get_actor("SERVE_PROXY_ACTOR").ready.remote())
        copies0 = dict(serialization.copy_stats)
        t0 = time.perf_counter()
        refs = (rt.put(weights), rt.put(norms))
        model = serve.deployment(
            ModelServer, name="model", num_replicas=S1_REPLICAS,
            max_concurrent_queries=2 * S1_BATCH,
            ray_actor_options={"num_gpus": S1_GPU_SHARE})
        model.deploy(*refs, layout, cfg)
        deploy_s = time.perf_counter() - t0
        host_bytes = (serialization.copy_stats["device_to_host_bytes"] -
                      copies0["device_to_host_bytes"])
        stats = rt.get(controller.get_autoscaler_stats.remote())
        replicas = rt.get(controller.get_replica_handles.remote("model"))
        infos = rt.get([r.handle_request.remote("weights_info", (), {})
                        for r in replicas])
        handle = model.get_handle()

        replies: Dict[int, Dict] = {}
        latency: Dict[int, float] = {}
        errors: List = []
        per_client = n_requests // clients

        def client(c):
            for n in range(per_client):
                i = c * per_client + n
                payload = {"id": i, "tokens": tokens[i].tolist()}
                t = time.perf_counter()
                try:
                    if c < clients // 2:
                        out = rt.get(handle.remote(payload), timeout=WALL_S)
                    else:
                        status, out = _post(port, "/model", payload)
                        if status != 200:
                            raise AssertionError(f"HTTP {status}")
                    latency[i] = time.perf_counter() - t
                    replies[i] = out
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(WALL_S)
        serve_s = time.perf_counter() - t0
        serve.shutdown()
    finally:
        rt.shutdown()
    # Read once every loop stopped, so that no tick is in flight.
    launches = _since(before, raylets)
    _check_raylets("S1", raylets)
    if errors or len(replies) != n_requests:
        raise AssertionError(f"S1: {len(replies)} of {n_requests} replies; "
                             f"errors {errors[:3]}")
    if stats["kernel_placements"] != S1_REPLICAS:
        raise AssertionError(f"S1: the kernel placed "
                             f"{stats['kernel_placements']} replicas: "
                             f"{stats}")
    if host_bytes:
        raise AssertionError(f"S1: deploying the weights copied {host_bytes} "
                             "bytes to the host")
    if {i["data_ptr"] for i in infos} == {weights.data_ptr()}:
        raise AssertionError("S1: a replica reads the caller's tensor, not "
                             "the store's copy")
    batches = {tuple(r["batch"]) for r in replies.values()}
    if sorted(i for b in batches for i in b) != list(range(n_requests)):
        raise AssertionError(f"S1: the batches {sorted(batches)} do not "
                             "cover every request once")
    worst, mismatched = 0.0, 0
    with torch.no_grad():
        for b in sorted(batches):
            toks = torch.from_numpy(tokens[list(b)]).to(dev)
            last = tt.forward(params, toks, cfg)[:, -1].float()
            best, arg = torch.log_softmax(last, dim=-1).max(dim=-1)
            for row, i in enumerate(b):
                got = replies[i]
                if got["id"] != i:
                    raise AssertionError(f"S1: request {i} got {got['id']}'s "
                                         "reply")
                worst = max(worst, abs(got["logprob"] - float(best[row])))
                mismatched += got["argmax"] != int(arg[row])
    if not np.isfinite(worst) or worst > PRED_ATOL or mismatched:
        raise AssertionError(f"S1: replies off the direct forward by {worst} "
                             f"(tolerance {PRED_ATOL}), {mismatched} argmax "
                             "differ")
    lat_ms = np.array([latency[i] for i in range(n_requests)]) * 1e3
    fills = [len(b) / S1_BATCH for b in batches]
    batch_ms = [replies[b[0]]["batch_ms"] for b in batches]
    if dev.type == "cuda":
        want = len(batches) * cfg.n_layers
        if launches["flash_forward"] != want:
            raise AssertionError(f"S1: {launches['flash_forward']} flash "
                                 f"launches for {len(batches)} batches of "
                                 f"{cfg.n_layers} layers")
    return {"requests": n_requests, "clients": clients,
            "replicas": S1_REPLICAS,
            "replicas_on_head": sum(i["node"] == head for i in infos),
            "deploy_s": deploy_s, "serve_s": serve_s,
            "requests_per_s": n_requests / serve_s,
            "latency_p50_ms": float(np.percentile(lat_ms, 50)),
            "latency_p99_ms": float(np.percentile(lat_ms, 99)),
            "batches": len(batches), "mean_batch_fill": float(np.mean(fills)),
            "batch_fn_ms_p50": float(np.percentile(batch_ms, 50)),
            "batch_fn_ms_p99": float(np.percentile(batch_ms, 99)),
            "kernel_placements": stats["kernel_placements"],
            "weights_device": infos[0]["device"],
            "weights_host_bytes": host_bytes,
            "max_abs_err": worst, "argmax_mismatched": mismatched,
            "launches": launches}


# -- S2 ------------------------------------------------------------------------

class Soak:
    """S2's deployment: the soak's batched body, each reply naming its
    replica."""

    def __init__(self):
        self.replica = uuid.uuid4().hex[:12]

    @serve.batch(max_batch_size=S2_BATCH, latency_budget_s=0.25)
    def __call__(self, requests):
        time.sleep(S2_BODY_S)
        return [(r * 3, self.replica) for r in requests]

    def replica_id(self):
        return self.replica


def autoscale(device="cuda", clients=S2_CLIENTS, per_client=S2_PER_CLIENT):
    """S2 (module docstring).  Returns its numbers."""
    from ray_tpu_torch.tools.profile_gcs import _r3_cluster
    from ray_tpu_torch.tools.profile_groups import _Runtime
    env = _Runtime(device)
    try:
        _r3_cluster(env)
        env.start()
        rt, cluster = env.rt, env.cluster
        raylets = cluster.raylets()
        before = _counts(raylets)
        serve.start(http_options={"location": "NoServer"})
        controller = serve.api._get_controller()
        soak = serve.deployment(
            Soak, name="soak", max_concurrent_queries=2,
            autoscaling_config={
                "min_replicas": S2_MIN, "max_replicas": S2_MAX,
                "target_num_ongoing_requests_per_replica": 1,
                "upscale_delay_s": 0.2,
                "downscale_delay_s": S2_DOWNSCALE_S})
        soak.deploy()
        first = rt.get(controller.get_autoscaler_stats.remote())
        initial = {rt.get(r.handle_request.remote("replica_id", (), {}),
                          timeout=60) for r in
                   rt.get(controller.get_replica_handles.remote("soak"))}
        handle = soak.get_handle()
        got, errors, first_reply = {}, [], {}
        peak = {"n": len(initial)}
        n_total = clients * per_client

        def client(c):
            for n in range(per_client):
                i = c * per_client + n
                try:
                    value, replica = rt.get(handle.remote(i), timeout=120)
                    got[i] = value
                    first_reply.setdefault(replica, time.perf_counter())
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append((i, repr(e)))

        def watch():
            while len(got) + len(errors) < n_total:
                info = rt.get(controller.get_deployment_info.remote("soak"))
                peak["n"] = max(peak["n"], info["num_running_replicas"])
                time.sleep(0.1)

        watcher = threading.Thread(target=watch, daemon=True)
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        step = time.perf_counter()
        watcher.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(WALL_S)
        load_s = time.perf_counter() - step
        watcher.join(30)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            info = rt.get(controller.get_deployment_info.remote("soak"))
            if info["num_running_replicas"] == S2_MIN:
                break
            time.sleep(0.2)
        down_s = time.perf_counter() - step - load_s
        stats = rt.get(controller.get_autoscaler_stats.remote())
        serve.shutdown()
    finally:
        env.close()
    launches = _since(before, raylets)
    _check_raylets("S2", raylets)
    if errors or len(got) != n_total:
        raise AssertionError(f"S2: {len(got)} of {n_total} answered; errors "
                             f"{errors[:3]}")
    wrong = [i for i, v in got.items() if v != i * 3]
    if wrong:
        raise AssertionError(f"S2: requests {wrong[:8]} got another's reply")
    if stats["scale_ups"] < 1 or peak["n"] <= S2_MIN or \
            stats["kernel_placements"] <= first["kernel_placements"]:
        raise AssertionError(f"S2: no scale-up placed by the kernel solve: "
                             f"peak {peak['n']} replicas, {stats} (after "
                             f"the deploy {first})")
    if stats["scale_downs"] < 1 or info["num_running_replicas"] != S2_MIN:
        raise AssertionError(f"S2: no scale-down to {S2_MIN} after the load: "
                             f"{info}, {stats}")
    new = [t - step for r, t in first_reply.items() if r not in initial]
    return {"raylets": len(raylets), "requests": n_total,
            "clients": clients, "load_s": load_s,
            "requests_per_s": n_total / load_s,
            "peak_replicas": peak["n"],
            "step_to_new_replica_ms": min(new) * 1e3 if new else None,
            "new_replicas_replying": len(new),
            "load_end_to_scale_down_s": down_s,
            "deploy_kernel_placements": first["kernel_placements"],
            "autoscaler_stats": stats, "launches": launches}


# -- N1 ------------------------------------------------------------------------

def tune_model(device="cuda", cfg=None, seq=None, lrs=N1_LRS):
    """N1 (module docstring).  ``cfg`` (``bench.CONFIG`` by default) and
    ``seq`` (its ``SEQ``) shrink it for a CPU rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, tune
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ml import DataParallelTrainer, Tuner
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.tools.profile_air import (LOSS_ATOL, _init,
                                                 dp_train_loop)
    cfg = cfg or mb.CONFIG
    seq = seq or mb.SEQ
    tokens = np.random.default_rng(N1_SEED).integers(
        0, cfg.vocab_size, (N1_SEQS, seq + 1)).astype(np.int64)
    per_block = N1_SEQS // N1_BLOCKS
    blocks = [tokens[i * per_block:(i + 1) * per_block]
              for i in range(N1_BLOCKS)]

    def trainer(config=None):
        return DataParallelTrainer(
            dp_train_loop,
            train_loop_config={"cfg": cfg, "device": device,
                               "seed": mb.PARAM_SEED, **(config or {})},
            datasets={"train": data.from_numpy(blocks, column="tokens")},
            scaling_config={"num_workers": 1, "use_gpu": True,
                            "resources_per_worker": {
                                "CPU": 1, "GPU": N1_GPU_SHARE}})

    _init(device)
    try:
        cluster = global_worker().cluster
        raylets = cluster.raylets()
        before = _counts(raylets)
        t0 = time.perf_counter()
        analysis = Tuner(trainer(), param_space={
            "lr": tune.grid_search(list(lrs))},
            metric="loss", mode="min").fit()
        sweep_s = time.perf_counter() - t0
        launches = _since(before, raylets)
        direct = {}
        for lr in lrs:
            direct[lr] = trainer({"lr": lr}).fit().metrics_history
    finally:
        rt.shutdown()
    _check_raylets("N1", raylets)
    trials = {t.config["lr"]: t for t in analysis.trials}
    if sorted(trials) != sorted(lrs) or any(
            t.status != "TERMINATED" for t in analysis.trials):
        raise AssertionError(f"N1: trials {analysis.trials}")
    losses = {lr: trials[lr].last_result["loss"] for lr in lrs}
    want = {lr: direct[lr][-1]["loss"] for lr in lrs}
    steps = [len(direct[lr]) for lr in lrs]
    err = max(abs(losses[lr] - want[lr]) for lr in lrs)
    if steps != [N1_BLOCKS] * len(lrs) or not all(
            np.isfinite(list(losses.values()))) or err > LOSS_ATOL:
        raise AssertionError(f"N1: trial losses {losses} against the direct "
                             f"runs' {want} (tolerance {LOSS_ATOL}); steps "
                             f"{steps}")
    best = min(lrs, key=lambda lr: want[lr])
    if analysis.best_config != {"lr": best}:
        raise AssertionError(f"N1: best_config {analysis.best_config}, the "
                             f"lower loss is lr {best}")
    if torch.device(device).type == "cuda":
        n = len(lrs) * N1_BLOCKS * cfg.n_layers
        want_fwd = 2 * n if cfg.remat else n
        if (launches["flash_forward"], launches["flash_backward"]) != \
                (want_fwd, n):
            raise AssertionError(f"N1: flash launches {launches}, expected "
                                 f"{want_fwd} forward and {n} backward")
    return {"trials": len(lrs), "steps": N1_BLOCKS, "sweep_s": sweep_s,
            "trial_loop_s": {str(lr): trials[lr].last_result["loop_s"]
                             for lr in lrs},
            "trial_last_step_ms": {str(lr): trials[lr].last_result["step_ms"]
                                   for lr in lrs},
            "trial_last_allreduce_ms": {
                str(lr): trials[lr].last_result["allreduce_ms"]
                for lr in lrs},
            "losses": {str(lr): losses[lr] for lr in lrs},
            "direct_losses": {str(lr): want[lr] for lr in lrs},
            "loss_err": err, "best_config": analysis.best_config,
            "launches": launches}


PHASES = {"s1": serve_model, "s2": autoscale, "n1": tune_model}


def main(argv=None) -> int:
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="all",
                        choices=sorted(PHASES) + ["all"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses a phase")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_serve: needs a CUDA device")
        print(card(), flush=True)
        from ray_tpu_torch.ops import _build
        sources = ("class_fill.cu", "flash_attention.cu",
                   "flash_attention_bwd.cu")
        _build.build(*sources)
        for source in sources:
            _build.load(source)
    names = sorted(PHASES) if args.phase == "all" else [args.phase]
    for name in names:
        t0 = time.perf_counter()
        out = PHASES[name](args.device)
        check_no_threads(name.upper())
        print(json.dumps({"phase": name.upper(),
                          "wall_s": time.perf_counter() - t0, **out},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
