"""L1 and L2: the transformer trained data-parallel and served in batch
through ``ray_tpu_torch.train``, ``data`` and ``ml`` on the runtime.

    python -m ray_tpu_torch.tools.profile_air [--phase l1|l2|both]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``train_dp`` (L1): ``init`` on the card (its ``GPU`` counted, the
  bundle solve forced onto the card: ``pg_kernel_backend="force"``),
  then ``Trainer(backend="torch", num_workers=2, use_gpu=True,
  resources_per_worker={"GPU": 0.5})``: a PACK group of two
  ``{"CPU": 1, "GPU": 0.5}`` bundles, both on the head, and two actors
  sharing the card in one process.  Each rank runs
  :func:`dp_train_loop`: the train state from ``PARAM_SEED`` on the card,
  its half of ``bench.train_tokens()`` (rows 0-3, then rows 4-7),
  ``loss_and_grads``, one ``util.collective.allreduce`` of the
  gradients flattened into one buffer of the model's dtype, the host
  form it returns moved back to the card (ROADMAP C.20) and divided by
  the world size, ``AdamW.update_``; 1 warm-up and 4 timed steps, each
  ``train.report``ed.  Held against ``make_train_step`` on the whole
  batch from the same seed (T2's function): the averaged gradient of
  the first step (``GRAD_RTOL``), the mean of the ranks' losses at every
  step (``LOSS_ATOL``), the ranks' shards (each its own half, by hash)
  and their parameters (bit-equal, by hash, after every step).  Reports
  the step's wall time (p50 of the timed steps, the slower rank), the
  allreduce's share of it, tokens/s, peak memory, the flash launches a
  step, and the ``class_fill`` launches and device bundle solves of the
  gang's creation.
* ``data_ml`` (L2): ``data.from_numpy`` of 64 token sequences of
  length 1,025 (``CONFIG``'s vocabulary, numpy seed ``L2_SEED``) in 4
  blocks; ``DataParallelTrainer(dp_train_loop, ...).fit()`` on 2 workers
  of half a GPU, each rank taking its shard through
  ``get_dataset_batches`` (2 batches of 16 sequences: 2 steps); the
  result's ``Checkpoint`` holds the parameters as host forms (C.27);
  ``BatchPredictor.from_checkpoint(...).predict(ds, batch_size=8)``
  runs the forward pass in one task a block and returns numpy per batch:
  each position's log-probability of its next token and the argmax
  token.  Held against ``forward`` on the same batches called directly
  (``PRED_ATOL``; argmax equal).  Reports rows/s and the predict wall.

Both count the flash kernels' launches and the raylets' batched ticks
(each launches ``class_fill`` on the card) of their own run, and check
the raylets counted no error.  ``device="cpu"`` rehearses a phase at a
small ``cfg`` (the kernels' plain versions, no launch counted).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

WORLD = 2
GPU_SHARE = 0.5
#: L1's steps: 1 warm-up and 4 timed.
L1_STEPS = 5
#: L2's data: sequences, blocks, the predict batch and the token seed.
L2_SEQS, L2_BLOCKS, L2_BATCH, L2_SEED = 64, 4, 8, 11
#: The averaged gradient of the first step against the whole batch's,
#: leaf by leaf: ||avg - whole|| <= GRAD_RTOL ||whole||.  The ranks'
#: means of 4 rows against the mean of 8, each rounded to bf16, and the
#: sum rounded once more: about 1e-3 of the norm.  A missing 1 /
#: world_size gives 1.0, a shard read twice about the norm of the other
#: half's difference (far above).
GRAD_RTOL = 2e-2
#: The mean of the ranks' losses against the whole batch's loss, every
#: step, absolute (float32 losses near 10.4 from bf16 logits; the updates
#: differ by the gradients' rounding).
LOSS_ATOL = 1e-2
#: L2's predictions against ``forward`` called directly: the
#: log-probabilities within PRED_ATOL and every argmax equal.
PRED_ATOL = 1e-3


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def flat_grads(grads: Dict, dtype) -> torch.Tensor:
    """The gradient tree's leaves (``optim.leaves`` order) in one flat
    buffer of ``dtype``."""
    from ray_tpu_torch.models.optim import leaves
    return torch.cat([g.reshape(-1).to(dtype) for g in leaves(grads)])


def unflat(flat: torch.Tensor, like: Dict) -> Dict:
    """``flat`` split back into ``like``'s leaves, shapes and dtypes."""
    from ray_tpu_torch.models.optim import leaves, tree_like
    ls = leaves(like)
    parts = flat.split([t.numel() for t in ls])
    return tree_like(like, [p.view(t.shape).to(t.dtype)
                            for p, t in zip(parts, ls)])


def fingerprint(tree) -> str:
    """sha256 of the tree's leaves' bytes, in ``optim.leaves`` order."""
    from ray_tpu_torch.models.optim import leaves
    h = hashlib.sha256()
    for t in leaves(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def _tokens_hash(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens, np.int64)
                          .tobytes()).hexdigest()


def dp_train_loop(config: Dict):
    """One rank's data-parallel training (L1, L2 and the port's tests).

    ``config``: ``cfg`` (a ``TransformerConfig``), ``device``, the
    initial weights (``params``, a numpy tree for ``convert.
    params_from_numpy``, else ``make_train_state`` from ``seed`` on the
    device), ``lr``; the data: ``tokens`` (the global batch: each step
    trains on this rank's contiguous share of its rows, ``steps`` times)
    or, without it, this rank's batches of the dataset ``"train"``
    (``ml.trainer.get_dataset_batches``, column ``column``; one step a
    batch).  Each step: ``loss_and_grads`` of the rank's rows, one
    ``allreduce`` of the gradients flattened into one buffer of
    ``cfg.dtype``, its host form moved back to the device and divided by
    the world size, ``AdamW.update_``; then ``train.report`` of the
    loss, the step's and the allreduce's ms, the hashes of the rank's
    rows and of its parameters, the seconds since the loop began, and
    (rank 0, first step, with
    ``report_grad``) the averaged flat gradient's host form.  With
    ``checkpoint``, rank 0 saves the final parameters (host forms) and
    ``cfg``.  ``allreduce``: ``"collective"`` (the default: the
    ``util.collective`` group ``"train"`` of thread workers) or
    ``"process_group"`` (``torch.distributed.all_reduce``, in place on
    the device, on the process group that ``TorchConfig`` set up over
    process workers).  Each report also carries the flash kernels'
    launches of the step in this rank's process (``flash_forward``,
    ``flash_backward``)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.models.optim import AdamW
    from ray_tpu_torch.util.collective import collective
    cfg = config["cfg"]
    dev = torch.device(config["device"])
    rank, world = train.world_rank(), train.world_size()
    lr = config.get("lr", 3e-4)
    if "params" in config:
        from ray_tpu_torch.models.convert import params_from_numpy
        tx = AdamW(lr)
        params = params_from_numpy(config["params"], cfg, device=dev)
        state = tt.train_state(params, tx.init(params))
    else:
        state, tx = tt.make_train_state(
            torch.Generator(device=dev).manual_seed(config["seed"]), cfg,
            learning_rate=lr, device=dev)
    if "tokens" in config:
        tokens = np.asarray(config["tokens"])
        rows = tokens.shape[0] // world
        mine = tokens[rank * rows:(rank + 1) * rows]
        batches = [mine] * config["steps"]
    else:
        from ray_tpu_torch.ml.trainer import get_dataset_batches
        column = config.get("column", "tokens")
        batches = [np.asarray(b[column])
                   for b in get_dataset_batches(config, "train")]
    params = state["params"]
    route = config.get("allreduce", "collective")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    began = time.perf_counter()
    for i, rows_np in enumerate(batches):
        launched = (fa.flash_attention.launches,
                    fa.flash_attention_backward.launches)
        batch = {"tokens": torch.from_numpy(
            np.ascontiguousarray(rows_np, np.int64)).to(dev)}
        t0 = time.perf_counter()
        loss, grads = tt.loss_and_grads(params, batch, cfg)
        flat = flat_grads(grads, cfg.dtype)
        del grads
        _sync(dev)
        t1 = time.perf_counter()
        avg = _allreduce(flat, route, collective).to(dev)
        avg.div_(world)
        _sync(dev)
        t2 = time.perf_counter()
        tx.update_(params, unflat(avg, params), state["opt"])
        state["step"] += 1
        _sync(dev)
        t3 = time.perf_counter()
        report = {"step": i, "loss": float(loss.detach()),
                  "step_ms": (t3 - t0) * 1e3, "allreduce_ms": (t2 - t1) * 1e3,
                  "loop_s": t3 - began,
                  "grad_elements": int(flat.numel()),
                  "shard_sha": _tokens_hash(rows_np),
                  "params_sha": fingerprint(params),
                  "flash_forward": fa.flash_attention.launches -
                  launched[0],
                  "flash_backward": fa.flash_attention_backward.launches -
                  launched[1]}
        if i == 0 and rank == 0 and config.get("report_grad"):
            report["grad"] = avg.cpu()
        del flat, avg
        train.report(**report)
    if config.get("checkpoint") and rank == 0:
        train.save_checkpoint(params=params, cfg=cfg)
    return rank


def _allreduce(flat: torch.Tensor, route: str, collective):
    """The sum of ``flat`` over the ranks by ``route`` (``dp_train_loop``)."""
    if route == "collective":
        return collective.allreduce(flat, group_name="train")
    import torch.distributed as dist
    if route == "process_group":
        dist.all_reduce(flat)
        return flat
    raise ValueError(f"allreduce route {route!r}")


def _check_ranks(name: str, rounds: List[List[Dict]],
                 shards: List[List[str]]):
    """Each rank trained on its own shard, and both ranks' parameters
    were bit-equal after every step."""
    for reports in rounds:
        step = reports[0]["step"]
        got = [r["shard_sha"] for r in reports]
        if shards and got != shards[step]:
            raise AssertionError(f"{name} step {step}: the ranks' rows are "
                                 "not their own shards")
        if len({r["params_sha"] for r in reports}) != 1:
            raise AssertionError(f"{name} step {step}: the ranks' "
                                 "parameters differ")


def _counters(cluster):
    from ray_tpu_torch.ops import class_fill as cf
    from ray_tpu_torch.scheduler import bundle_packing
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    solvers = [r.cluster_task_manager._solver for r in cluster.raylets()]
    return {"class_fill": cf.class_fill.launches,
            "batched_ticks": sum(s.stats["ticks"] for s in solvers if s),
            "flash_forward": fa.flash_attention.launches,
            "flash_backward": fa.flash_attention_backward.launches,
            "bundle_solves_on_device":
                bundle_packing.kernel_stats["kernel_placements"]}


def _delta(cluster, before: Dict) -> Dict:
    now = _counters(cluster)
    return {k: now[k] - before[k] for k in before}


def _init(device, **system_config):
    """``init`` on ``device`` with the bundle solve on it (and
    ``system_config``'s other knobs); on the CPU a GPU is declared, so
    that the half-GPU bundles fit as on the card."""
    import ray_tpu_torch as rt
    on_card = torch.device(device).type == "cuda"
    rt.init(device=device, num_cpus=max(4, os.cpu_count() or 1),
            num_gpus=None if on_card else 1,
            _system_config={"pg_kernel_backend": "force", **system_config})


def _check_raylets(name, cluster):
    from ray_tpu_torch.tools.profile_tasks import _check_clean, _tick_totals
    _check_clean(name, _tick_totals(cluster)[1])


def hold_to_whole_batch(name: str, rounds: List[List[Dict]],
                        tokens: np.ndarray, cfg, dev: torch.device,
                        steps: int) -> Dict:
    """Hold a data-parallel run's report rounds to ``make_train_step`` on
    the whole batch from ``PARAM_SEED`` (T2's function): each rank's rows
    its own shard, the ranks' parameters bit-equal after every step, the
    averaged gradient of step 1 within ``GRAD_RTOL`` of the whole
    batch's and the ranks' mean losses within ``LOSS_ATOL``.  Returns
    the errors and both loss series."""
    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.models.optim import leaves
    world = len(rounds[0])
    rows = tokens.shape[0] // world
    shards = [[_tokens_hash(tokens[r * rows:(r + 1) * rows])
               for r in range(world)]] * steps
    _check_ranks(name, rounds, shards)
    state, tx = tt.make_train_state(
        torch.Generator(device=dev).manual_seed(mb.PARAM_SEED), cfg,
        device=dev)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev)}
    _, whole = tt.loss_and_grads(state["params"], batch, cfg)
    got = rounds[0][0]["grad"].to(dev)
    want = flat_grads(whole, cfg.dtype)
    grad_err = 0.0
    for g, w in zip(got.split([t.numel() for t in leaves(whole)]),
                    want.split([t.numel() for t in leaves(whole)])):
        err = float((g.float() - w.float()).norm() /
                    w.float().norm().clamp_min(1e-30))
        grad_err = max(grad_err, err)
    if grad_err > GRAD_RTOL:
        raise AssertionError(f"{name}: the averaged gradient of step 1 is "
                             f"off the whole batch's by {grad_err} of its "
                             f"norm (tolerance {GRAD_RTOL})")
    del got, want, whole
    step = tt.make_train_step(cfg, tx)
    ref_losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    losses = [float(np.mean([r["loss"] for r in reports]))
              for reports in rounds]
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    if not all(np.isfinite(losses)) or loss_err > LOSS_ATOL:
        raise AssertionError(f"{name}: the ranks' mean losses {losses} "
                             f"against the whole batch's {ref_losses} "
                             f"(tolerance {LOSS_ATOL})")
    return {"grad_rel_err": grad_err, "loss_err": loss_err,
            "losses": losses, "ref_losses": ref_losses}


def step_times(rounds: List[List[Dict]], n_rows: int, seq: int) -> Dict:
    """The timed steps' wall (the slower rank's; the first step is the
    warm-up when there are more), the allreduce's ms and share, p50s and
    tokens/s."""
    timed = rounds[1:] if len(rounds) > 1 else rounds
    step_ms = [max(r["step_ms"] for r in reports) for reports in timed]
    share = [max(r["allreduce_ms"] for r in reports) / max(
        r["step_ms"] for r in reports) for reports in timed]
    p50 = float(np.percentile(step_ms, 50))
    return {"step_ms": step_ms, "step_ms_p50": p50,
            "allreduce_ms_p50": float(np.percentile(
                [max(r["allreduce_ms"] for r in reports)
                 for reports in timed], 50)),
            "allreduce_share_p50": float(np.percentile(share, 50)),
            "tokens_per_s": n_rows * seq / (p50 / 1e3)}


def train_dp(device="cuda", cfg=None, steps=L1_STEPS, tokens=None):
    """L1 (module docstring).  ``cfg`` (``bench.CONFIG`` by default) and
    ``tokens`` (``bench.train_tokens``) shrink it for a CPU rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import bench as mb
    cfg = cfg or mb.CONFIG
    dev = torch.device(device)
    tokens = (mb.train_tokens("cpu", cfg).numpy() if tokens is None
              else np.asarray(tokens))
    _init(device)
    try:
        cluster = global_worker().cluster
        head = cluster.head_node.node_id.hex()
        before = _counters(cluster)
        trainer = train.Trainer(backend="torch", num_workers=WORLD,
                                use_gpu=True,
                                resources_per_worker={"GPU": GPU_SHARE})
        t0 = time.perf_counter()
        trainer.start()
        start_s = time.perf_counter() - t0
        gang = _delta(cluster, before)
        pg = trainer._executor.worker_group._pg
        table = rt.util.placement_group_table(pg)
        if set(table["bundle_nodes"].values()) != {head}:
            raise AssertionError(f"L1: the half-GPU bundles are not both on "
                                 f"the head: {table['bundle_nodes']}")
        gpu_ids = trainer._executor.worker_group.execute(rt.get_gpu_ids)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = _counters(cluster)
        config = {"cfg": cfg, "device": device, "seed": mb.PARAM_SEED,
                  "tokens": tokens, "steps": steps, "report_grad": True}
        t0 = time.perf_counter()
        rounds = list(trainer.run_iterator(dp_train_loop, config))
        run_s = time.perf_counter() - t0
        run = _delta(cluster, before)
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if dev.type == "cuda" else None)
        trainer.shutdown()
        _check_raylets("L1", cluster)
    finally:
        rt.shutdown()
    if len(rounds) != steps:
        raise AssertionError(f"L1: {len(rounds)} report rounds for {steps} "
                             "steps")
    held = hold_to_whole_batch("L1", rounds, tokens, cfg, dev, steps)
    per_step = {k: v / steps for k, v in run.items()}
    want_fwd = WORLD * 2 * cfg.n_layers if cfg.remat else WORLD * cfg.n_layers
    if dev.type == "cuda" and (per_step["flash_forward"] != want_fwd or
                               per_step["flash_backward"] !=
                               WORLD * cfg.n_layers):
        raise AssertionError(f"L1: flash launches a step {per_step}, "
                             f"expected {want_fwd} forward and "
                             f"{WORLD * cfg.n_layers} backward")
    return {"steps": steps, "world": WORLD, "gpu_share": GPU_SHARE,
            "gpu_ids": gpu_ids, "start_s": start_s, "run_s": run_s,
            **step_times(rounds, tokens.shape[0], tokens.shape[1] - 1),
            "grad_elements": rounds[0][0]["grad_elements"],
            "grad_bytes": rounds[0][0]["grad_elements"] *
            torch.empty((), dtype=cfg.dtype).element_size(),
            "peak_gb": peak_gb, **held, "launches": run,
            "launches_per_step": per_step, "gang": gang}


def _predictor_fn(checkpoint, device):
    """``model_from_checkpoint`` of L2's ``BatchPredictor``: the
    checkpoint's parameters on ``device``, and a function from a numpy
    batch ``{"tokens": [b, S + 1]}`` to numpy ``{"logprob": [b, S]``
    (each position's log-probability of its next token), ``"argmax":
    [b, S]}``."""
    cfg = checkpoint["cfg"]
    dev = torch.device(device)
    params = _tree_to(checkpoint["params"], dev)

    def predict(batch):
        return predict_tokens(params, batch["tokens"], cfg, dev)
    return predict


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@torch.no_grad()
def predict_tokens(params, tokens, cfg, dev):
    """``forward`` of ``tokens[:, :-1]``: the log-probability of each next
    token and the argmax, as numpy."""
    from ray_tpu_torch.models import transformer as tt
    toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64)).to(dev)
    logits = tt.forward(params, toks[:, :-1], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = logp.gather(-1, toks[:, 1:, None]).squeeze(-1)
    return {"logprob": gold.cpu().numpy(),
            "argmax": logits.argmax(-1).to(torch.int32).cpu().numpy()}


def data_ml(device="cuda", cfg=None, n_seqs=L2_SEQS, n_blocks=L2_BLOCKS,
            batch_size=L2_BATCH, seq=None):
    """L2 (module docstring).  ``cfg`` (``bench.CONFIG`` by default) and
    ``seq`` (its ``SEQ``) shrink it for a CPU rehearsal."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ml import BatchPredictor, DataParallelTrainer
    from ray_tpu_torch.models import bench as mb
    cfg = cfg or mb.CONFIG
    seq = seq or mb.SEQ
    dev = torch.device(device)
    tokens = np.random.default_rng(L2_SEED).integers(
        0, cfg.vocab_size, (n_seqs, seq + 1)).astype(np.int64)
    per_block = n_seqs // n_blocks
    blocks = [tokens[i * per_block:(i + 1) * per_block]
              for i in range(n_blocks)]
    _init(device)
    try:
        cluster = global_worker().cluster
        before = _counters(cluster)
        ds = data.from_numpy(blocks, column="tokens")
        t0 = time.perf_counter()
        result = DataParallelTrainer(
            dp_train_loop,
            train_loop_config={"cfg": cfg, "device": device,
                               "seed": mb.PARAM_SEED, "checkpoint": True},
            datasets={"train": ds},
            scaling_config={"num_workers": WORLD, "use_gpu": True,
                            "resources_per_worker": {"GPU": GPU_SHARE}}
        ).fit()
        fit_s = time.perf_counter() - t0
        fit = _delta(cluster, before)
        ckpt = result.checkpoint
        before = _counters(cluster)
        t0 = time.perf_counter()
        preds = BatchPredictor.from_checkpoint(
            ckpt, functools.partial(_predictor_fn, device=device)).predict(
                ds, batch_size=batch_size)
        got = preds.to_numpy()
        predict_s = time.perf_counter() - t0
        predict = _delta(cluster, before)
        _check_raylets("L2", cluster)
    finally:
        rt.shutdown()
    history = result.metrics_history
    steps = n_blocks // WORLD
    if len(history) != steps or not all(
            np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"L2: {len(history)} report rounds for {steps} "
                             f"steps: {history}")
    from ray_tpu_torch.models.optim import leaves
    held = leaves(ckpt["params"])
    if not all(t.device.type == "cpu" and not t.requires_grad
               for t in held):
        raise AssertionError("L2: the checkpoint holds a tensor that is not "
                             "a host form")
    params = _tree_to(ckpt["params"], dev)
    want = [predict_tokens(params, tokens[i:i + batch_size], cfg, dev)
            for i in range(0, n_seqs, batch_size)]
    want = {k: np.concatenate([w[k] for w in want]) for k in want[0]}
    if set(got) != {"logprob", "argmax"} or \
            got["logprob"].shape != (n_seqs, seq):
        raise AssertionError(f"L2: predictions {sorted(got)} of shape "
                             f"{got.get('logprob', np.zeros(0)).shape}")
    pred_err = float(np.abs(got["logprob"] - want["logprob"]).max())
    mismatched = int((got["argmax"] != want["argmax"]).sum())
    if not np.isfinite(got["logprob"]).all() or pred_err > PRED_ATOL or \
            mismatched:
        raise AssertionError(f"L2: predictions off the direct forward by "
                             f"{pred_err} (tolerance {PRED_ATOL}), "
                             f"{mismatched} argmax differ")
    if dev.type == "cuda":
        want_fit = (steps * WORLD * 2 * cfg.n_layers,
                    steps * WORLD * cfg.n_layers)
        want_predict = n_seqs // batch_size * cfg.n_layers
        if (fit["flash_forward"], fit["flash_backward"]) != want_fit or \
                predict["flash_forward"] != want_predict:
            raise AssertionError(f"L2: flash launches fit {fit}, predict "
                                 f"{predict}; expected {want_fit} and "
                                 f"{want_predict} forward")
    return {"rows": n_seqs, "blocks": n_blocks, "steps": steps,
            "fit_s": fit_s, "losses": [h["loss"] for h in history],
            "predict_s": predict_s, "rows_per_s": n_seqs / predict_s,
            "pred_max_abs_err": pred_err, "argmax_mismatched": mismatched,
            "launches_fit": fit, "launches_predict": predict}


PHASES = {"l1": train_dp, "l2": data_ml}


def main(argv=None) -> int:
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="both",
                        choices=sorted(PHASES) + ["both"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses a phase")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_air: needs a CUDA device")
        print(card(), flush=True)
        from ray_tpu_torch.ops import _build
        sources = ("class_fill.cu", "flash_attention.cu",
                   "flash_attention_bwd.cu")
        _build.build(*sources)
        for source in sources:
            _build.load(source)
    names = sorted(PHASES) if args.phase == "both" else [args.phase]
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
