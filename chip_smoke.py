#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the package's CUDA kernels from the sources in this checkout (one
nvcc per source, all at once) and holds each against its plain PyTorch
version on the card.  Then it drives the scheduling tick through both
entry points at the bench's full width (1M tasks x 256 classes x 10,000
nodes x 8 resources):

  A. ``BatchSolver.prepare_device`` + ``solve_stream``: 40 closed-loop
     ticks, checked on the host and against a CPU run of the first 3;
  B. ``DeviceRuntimeSolver.solve`` on a 10,000-node view: a burst of
     20,000 specs in 64 classes, every grant committed, a delta tick,
     targets checked against a CPU-device solver on a copy of the view;

the tick's other consumers on the same node shapes: ``solve_bundles``
and ``pack_bundles_kernel`` for a placement group of 256 bundles under
the four strategies (and STRICT_PACK for 8), each assignment validated
and each solve bit-equal to ``device="cpu"``; and one sinkhorn tick
(``mode="sinkhorn"``) of the bench problem, capacity and counts held and
bit-equal to ``device="cpu"``; ms per call of each;

the raylet's scheduling plane around the tick and the autoscaler's pack
mode (``ray_tpu_torch._private``, ``ray_tpu_torch.autoscaler``):

  R1. one ``Raylet`` on the card with Path B's 10,000-node view and a
      burst of 20,000 leases in 64 classes (``request_worker_lease_batch``,
      batches of 100), one ``schedule_and_dispatch`` a round, granted
      workers returned and backlog resubmitted until no round places
      more: every reply equal to a ``Raylet(device="cpu")``'s, one
      ``class_fill`` launch per batched tick, no fallback and no error;
      ms per busy tick, the decisions, the tick and solver counters and
      the rendered ``ray_tpu_scheduler_*`` series;
  R2. ``get_bin_pack_residual`` of the same 20,000 demands on the
      fleet's 10,000 available rows and ``get_nodes_to_launch`` for the
      fleet's three node kinds and an 8-bundle STRICT_SPREAD group:
      outputs equal to ``device="cpu"``'s, ms per call and the device
      time of one more call of each (``torch.profiler``);
  R3. a ``Cluster`` of 64 raylets on the card (the fleet's first 64
      node shapes) and ``R3_LEASES`` leases (10,000 of the configuration's
      100,000, to keep the run's wall) from a lessee with the reference
      submitter's protocol, each spillback re-sent with
      ``grant_or_reject`` (``ray_tpu_torch.tools.profile_cluster``):
      every feasible lease granted exactly once; leases/s, p50/p99 lease
      latency, spillbacks and rejections;

the task API on thread workers through ``ray_tpu_torch.init()`` on the
card (``ray_tpu_torch.tools.profile_tasks``), each raylet's batched
tick running ``class_fill``:

  C1. the JAX package's ``bench_runtime.py`` single-node rows, nothing
      cut: one head raylet with ``os.cpu_count()`` CPUs, 200 warm-up and
      10,000 no-op tasks (tasks/s), the submit-to-running latency p50 and
      p99 of 2,000, one task with 10,000 ``ObjectRef`` arguments from
      ``put``, one with 3,000 returns, one ``get`` of 10,000 refs; every
      value checked, at least one ``class_fill`` launch, no fallback, no
      device error;
  C2. R3's cluster (64 raylets, the fleet's first 64 node shapes) under
      ``init(_cluster=...)`` and ``C2_TASKS`` tasks (25,000 of the
      configuration's 100,000, to keep the run's wall; ``python -m
      ray_tpu_torch.tools.profile_tasks`` runs it whole) of one no-op
      function in
      R3's 64 classes (``.options``), less the classes no node fits (their
      count and share printed as a cut), through the real submitter: every
      task returns its index, read once; tasks/s, the wall, p50/p99 from
      submit to a sealed result, launches and batched ticks a raylet,
      spillbacks and rejections, the peak count of worker threads;
  E1. C2's task events, read from the GCS's ``TaskEventManager``: no
      event dropped at the source, the records tracked plus those evicted
      equal to the tasks submitted, every tracked record FINISHED after
      PENDING_ARGS_AVAIL, SCHEDULED, SUBMITTED_TO_WORKER and RUNNING in
      order with time stamps that never go down; a raylet's SCHEDULED
      for a lease granted after its task ran elsewhere and its record was
      evicted (a late grant, as in the reference) counted apart; the
      stage p50 and p99;

the object plane through ``ray_tpu_torch.init()`` on the card
(``ray_tpu_torch.tools.profile_objects``; the launch count zeroed before
each phase and read after it):

  O1. ``bench_runtime.py``'s ``large_object_roundtrip`` row at 1 GiB:
      cold and warm put ms and the bytes the put copied (none: the
      store keeps views), the get's view ms and its GB/s into a
      pre-faulted buffer, the bytes equal; a task with a 16 MiB literal
      argument (promoted to a node-store object) and a 16 MiB return,
      both values checked;
  O2. ``bench_runtime.py``'s ``broadcast_object`` row: 256 MiB pulled by
      8 raylets at once, relay on, cold and warm: GB/s, bytes served per
      source, relay pulls, cross-node bytes, every replica byte-equal;
  O3. 64 seeded arrays of 32 MiB (2 GiB) through one raylet's 1 GiB
      store, spilled and read back equal: objects, bytes, batches,
      files, create-queue waits, s/GiB each way (spill files in a
      temporary directory the phase removes);
  O4. an 8 MB return recomputed from lineage after its raylet is
      removed (seconds to recover), and the same loss with lineage
      pinning off raising ``ObjectLostError`` with the reference's
      message;
  O5. 2 raylets, a 4.8 MB object on B and 4 consumers of one function:
      all on B within 3 attempts and no cross-node bytes; then the
      object on one raylet of R3's 64 and a burst of consumers as large
      as its CPUs (the share that ran there).  Such one-class bursts are
      leased a task at a time and never reach the batched tick (their
      cost launches are reported, 0); a probe of one class a consumer on
      each cluster reaches it: a cost tick and a ``class_fill`` launch
      with a non-zero locality cost.  No device error;

each O phase also checks its raylets' error counts and that no thread of
the port outlived its shutdown;

placement groups and the autoscaler's loop on the card
(``ray_tpu_torch.tools.profile_groups``; the launch count zeroed before
each phase and read after it):

  G1. ``init(_cluster=...)`` on R3's 64 raylets: four groups of four
      ``{"CPU": 1}`` bundles under each strategy, then a 32-bundle SPREAD
      group, each waited before the next, every solve the device bundle
      solve: every group CREATED with the bundle nodes of a
      ``device="cpu"`` run of the same phase, a task into each bundle on
      its bundle's node seeing its group, the batched tick's
      ``class_fill`` at the R_pad the groups' formatted columns widened
      the views to (above 64), bundle-solve placements and no error, and
      every resource back after the groups are removed: ms from
      ``placement_group()`` to ``wait()`` (p50, p99), ms per bundle
      solve, tasks/s into bundles, R_pad, full uploads, launches and
      (under ``torch.profiler``) the card's idle share; then
      ``class_fill`` on the widest call's inputs that G1 made, and on the
      bench problem widened to that R_pad (past the shared-memory
      budget: the kernel's global route), each bit-equal to and timed
      beside its plain version;
  A1. a ``Monitor`` with ``FakeMultiNodeProvider`` (a 1-CPU head and
      ``tests/test_autoscaler.py``'s worker type, 64 workers at most),
      a burst of 2,048 tasks in 64 shapes that need the worker's
      ``bigmem``, a pending STRICT_SPREAD group and a
      ``request_resources``: each round's launches equal to a
      ``device="cpu"`` autoscaler's on the same load metrics, the
      autoscaler's solves on ``class_fill``, every task done on a
      launched node, then the workers terminated down to
      ``min_workers`` once idle: ms per ``update_all``, launches, nodes
      launched and terminated, seconds from the burst to the last
      result;

node death by missed heartbeats and a GCS restart on R3's 64 raylets
under ``init`` (``ray_tpu_torch.tools.profile_gcs``; the launch count
zeroed before each phase and read after it):

  H1. four STRICT_SPREAD groups of four ``{"CPU": 1}`` bundles, 64 tasks
      returning 8 MiB arrays the driver holds unread, then a burst of
      20,000 no-op tasks in R3's classes and, a quarter into it,
      ``kill_node`` of 8 raylets: each victim SUSPECT then DEAD within
      ``num_heartbeats_timeout`` periods plus two of its kill (ms to each
      printed), no batched tick's device placement on a node masked when
      it started, every result right through retries, every array
      byte-equal (the lost ones recomputed), every group that lost a
      bundle CREATED again on live nodes, no survivor error, and
      ``class_fill`` launches equal to the raylets' batched ticks;
  H2. G1's 17 groups and 64 actors (16 named) on a GCS journaled to a
      file, one group's table row deleted and one actor's worker killed
      unknown to the GCS, ``restart_gcs``: every other group CREATED on
      the same bundle nodes, the deleted group's bundles released, every
      other actor re-attached ALIVE with its count going on, every named
      one found by ``get_actor``, the lost one ALIVE again after one
      restart, 1,000 tasks into bundles right, their leases through the
      batched ticks; the restart's ms (shutdown, reload, reconcile and
      its actor share) and the journal's bytes;

actors on R3's 64 raylets under ``init``
(``ray_tpu_torch.tools.profile_actors``; the launch count zeroed before
each phase and read after it, and equal to the raylets' batched ticks,
at least one):

  K1. 1,024 actors in one burst (768 default, 256 holding a shape drawn
      from R3's feasible classes, those the cluster cannot hold cut and
      counted), 64 named, 64 with ``max_concurrency=4``, 64 with
      concurrency groups: every actor ALIVE, named ones found, four
      calls of a concurrent actor sharing an instant, a blocked ``io``
      call stalling no other group; ``K1_CALLS`` calls (16) on every
      actor returning
      its running count in order, 1,000 tasks calling through a passed
      handle, 320 actors killed: ``available_resources()`` back to its
      value before the burst and their calls ``ActorDiedError``;
      create-to-ALIVE p50/p99, actors ALIVE/s, calls/s, call p50/p99,
      the GCS loop's actor handlers and lag, peak worker threads;
  K2. 512 SPREAD actors (256 ``max_restarts=1, max_task_retries=1``,
      256 ``max_restarts=0``), 16 calls each with 2,000 tasks in R3's
      classes among them, and 8 raylets killed a quarter in: no actor
      restarted while its node was only SUSPECT, each restartable victim
      ALIVE again once, reconstructed, on a live node, each mortal one
      DEAD with ``ActorDiedError``, every other actor's counts exact, no
      call sealed from a killed node's thread; ms from kill to DEAD and
      from the last DEAD to the last actor ALIVE again, calls failed;

the device-object plane and ``ray_tpu_torch.util`` under ``init`` on the
card (``ray_tpu_torch.tools.profile_device``; the launch count zeroed
before each phase and read after it):

  D1. a head and 8 raylets: a 1 GiB float32 CUDA tensor put (ms, one
      1 GiB device copy and no host byte), read on the head as the
      stored CUDA tensor (equal, one object, unchanged by a write into
      the original) and by an actor there with no host copy; a 256 MiB
      CUDA return, a device entry on the head alone and ready for
      ``wait``, pulled by another raylet bit for bit, in float32 and in
      bf16 (the GB/s of the pull's device-to-host copy); a small CUDA
      tensor passed inline arriving as a CPU tensor; spill pressure on a
      store half full of device entries spilling none of them; the GPU
      count and ``get_gpu_ids`` of a ``num_gpus=1`` task;
  U1. 8 actors in a collective group on 16 MiB CUDA tensors: allreduce
      under every ReduceOp with the reduction on the card, then
      reducescatter, broadcast, allgather, send/recv and barrier, each
      held to numpy (ms each); ``ActorPool.map`` of 1,000 calls in order,
      a ``Queue`` of 10,000 items through two producers and one
      consumer, a ``ParallelIterator`` over 8 shards, and ``metrics`` in
      the registry's render;

and the transformer's forward pass (``Transformer``) at the width of
``bench_model.py``'s single-chip model (vocab 32,000, d_model 1024, 16
heads, d_ff 4096; ``ray_tpu_torch.models.bench``):

  M1. 2 layers, float32, batch 2 x 256: the card's logits against a
      ``device="cpu"`` run of the same weights;
  M2. the full 8 layers in bfloat16, batch 8 x 1024: ms per forward,
      tokens/s, finite logits, 8 flash launches per forward, one
      sequence's logits within 5% relative RMS of a float32 CPU forward
      of the same weights, and the evaluation loss on uniform tokens
      within 0.1 of its expected value at this init,
      ln 32,000 + 0.02**2 * 1024 / 2;
  M3. the same model with the switch-MoE FFN (``MOE_CONFIG``: 8 experts,
      capacity 1.25) in bf16 at 8 x 1024: ms per forward, tokens/s,
      finite logits, 8 flash launches per forward, the share of tokens
      dropped at capacity, one sequence's logits within 5% relative RMS
      of a float32 CPU forward of the same weights (with the count of its
      tokens routed to another expert there);

the backward kernel of flash attention against its plain version (f32
and bf16, D 64, 96, 128 and 256, causal and not, L 128 and 1024, a
strided view; each case's route counted: bf16 at D <= 128 on the wgmma
route), then at the model's shape and at D = 128: two calls bit-equal,
each timed beside its bound and SDPA's backward; and the train step
(``make_train_state`` +
``make_train_step``, the port's AdamW, remat):

  T1. 2 layers at full width, float32, batch 2 x 256: 3 steps on the card
      against 3 on ``device="cpu"`` from the same weights: loss,
      grad_norm and every parameter after each step;
  T3-f32. the same at ``MOE_CONFIG``'s width (2 layers, 8 experts);
  T2. ``bench_model.py``'s config and batch (8 layers, bf16, remat,
      tokens [8, 1025] from default_rng(0)), nothing cut: 1 warm-up and
      10 timed steps: ms per step, tokens/s, TFLOP/s by its accounting,
      peak memory, the first loss within 0.1 of the init loss, a lower
      loss after the run, 16 forward and 8 backward flash launches per
      step, a finite grad_norm at every step;
  T3. the same at ``MOE_CONFIG``, nothing cut, TFLOP/s by
      ``moe_train_flops``, the first loss within 0.1 of the init loss
      plus 0.01 times the auxiliary of a forward before the first step;

and the train step on a device mesh (``parallel.mesh.build_mesh`` on a
NCCL world of one, through a ``file://`` store in a temporary
directory; one all-reduce checks NCCL first):

  P1. T1 through ``make_train_state``/``make_train_step`` with the mesh,
      against ``mesh=None`` on ``device="cpu"`` within ``TRAIN_F32_TOL``,
      and ``ring_attention`` over the mesh's one-rank sp group at
      [8, 1024, 16, 64] in float32 and bf16 against ``full_attention``;
  P2. T2's config and batch with the mesh: ms per step, tokens/s and
      device operations a step beside T2's from the same run, the first
      loss within 1e-3 of T2's;
  P3. the GPipe schedule (``parallel.pipeline``) with pp = 1 and 4
      microbatches at the same config and batch: ms per step, the first
      loss within 1e-2 of P2's.

The machine has one card and NCCL puts no two ranks on one device, so
every mesh here has one rank: no multi-rank number exists (the
multi-rank paths are held to JAX by gloo worlds on the CPU,
``tests/test_torch_parallel.py`` and ``tests/test_torch_pipeline.py``).

and the libraries on the runtime, where the model meets it
(``ray_tpu_torch.tools.profile_air``; every count read just before and
just after the path it counts):

  L1. ``init()`` on the card (its GPU counted) and ``train.Trainer(
      backend="torch", num_workers=2, use_gpu=True,
      resources_per_worker={"GPU": 0.5})``: a PACK group of two half-GPU
      bundles, both on the head through the bundle solve on the card, and
      two actors sharing the card; each rank trains T2's model from
      ``PARAM_SEED`` on its half of T2's batch, averaging its gradients
      with one ``util.collective.allreduce`` of one flattened buffer a
      step, 1 warm-up and 4 timed steps, each ``train.report``ed: the
      averaged gradient of step 1 and the 5 losses held to
      ``make_train_step`` on the whole batch, each rank's rows its own
      half, the ranks' parameters bit-equal after every step; the step's
      p50 wall, the allreduce's share, tokens/s, peak memory, the flash
      launches a step (16 forward and 8 backward a rank), the gang's
      ``class_fill`` launches (its creation leases' batched tick) and
      device bundle solves;
  L2. ``data.from_numpy`` of 64 sequences of 1,025 tokens in 4 blocks,
      ``ml.DataParallelTrainer(...).fit()`` on the same gang shape for 2
      steps (each rank's shard through ``get_dataset_batches``), its
      ``Checkpoint`` of host forms, and ``BatchPredictor.from_checkpoint(
      ...).predict(ds, batch_size=8)``, one task a block on the card: the
      predictions (each next token's log-probability and the argmax)
      held to ``forward`` on the same batches; rows/s and the predict
      wall;

and the model served and swept (``ray_tpu_torch.tools.profile_serve``;
every count read just before and just after the path it counts):

  S1. ``serve`` on ``init()`` on the card with
      ``serve_kernel_placement="force"``: T2's model as a class
      deployment of 2 replicas at ``{"num_gpus": 0.5}``, placed by the
      controller's ``_kernel_place`` (the pack-mode solve, ``class_fill``
      on the card), its weights deployed as ``ObjectRef``s of CUDA
      tensors (device objects, no host copy); ``@serve.batch(
      max_batch_size=8)`` runs requests of 1,024 tokens as forwards of
      [<= 8, 1024]; 64 requests from 8 clients, half through a handle,
      half over HTTP on loopback, each reply (the last position's argmax
      and log-probability) held to ``forward`` on its batch's tokens;
      requests/s, latency p50/p99, the mean batch fill;
  S2. R3's 64 raylets under ``init()`` and serve's default
      ``serve_kernel_placement="auto"``: ``tests/test_serve.py``'s soak
      shape (2 to 4 replicas, 8 clients x 25 requests, batch 4) with the
      queue-depth step's downscale delay: no request lost or misrouted,
      at least one scale-up placed by the kernel solve, a scale-down
      after the load; the time from the step to a new replica's first
      reply, requests/s;
  N1. ``ml.Tuner`` over L2's ``DataParallelTrainer`` with
      ``param_space={"lr": tune.grid_search([3e-4, 3e-3])}``: 2 trials at
      once, each 1 worker of ``{"CPU": 1, "GPU": 0.5}`` and 2 steps of
      L2's batch, each trial's loss held to the same trainer run
      directly, ``best_config`` that of the lower loss; the trials'
      walls and the sweep's flash and ``class_fill`` launches;

and the RL trainers, Workflow and the Pool
(``ray_tpu_torch.tools.profile_rllib``; counts read just before and
just after each):

  Q1. ``rllib.PPOTrainer`` at the reference's ``DEFAULT_CONFIG`` (2
      rollout workers of 256 steps, 6 epochs of minibatches of 128,
      hidden (64, 64)) with the learner and the workers' policies on the
      card, 3 ``train()`` iterations, each one's first SGD step held to
      the same step on the CPU (loss within 1e-5 relative, weights within
      1e-4); seconds an iteration and env steps/s without the holds' time,
      ms an SGD step and its
      device operations, the workers' creation's ``class_fill`` launches;
  Q2. ``DQNTrainer`` at its ``DEFAULT_CONFIG`` up to the first
      ``train()`` that learns, its first TD update held to the CPU's, and
      ``IMPALATrainer`` at its own for one ``train()``, its first V-trace
      update held to the CPU's and ``compute_vtrace`` on the card at
      T 128 held to ``tests/test_rllib.py``'s numpy oracle;
  W1. a workflow of 16 steps fanned in and chained, each a task leased
      through the raylets, a virtual actor's durable counter reloaded, a
      resume that skips a finished step, and
      ``util.multiprocessing.Pool(4).map`` over 256 items, every output
      held to the plain Python result;

and the runtime's worker processes (``worker_process_mode="process"``:
children of ``python -m ray_tpu_torch._private.worker_main`` that take
their tasks over the framed RPC; ``ray_tpu_torch.tools.profile_process``;
counts read just before and just after each):

  X1. ``init`` of 4 CPUs and 1 GPU on the card with process workers: a
      burst of 2,000 tasks in two classes (every result its index, run
      outside the driver's process; tasks/s, submit-to-sealed p50/p99,
      ``class_fill`` launches equal to the batched ticks, at least one,
      each child's ms from spawn to registration) beside the same burst
      on thread workers; an actor of ``num_gpus=0.5`` in a worker process
      that builds T2's model on the card from its weights as one object
      of host forms and answers 4 forwards at 8 x 1024, each within M2's
      5% relative RMS of the driver's forward on the same tokens (ms a
      call beside M2's ms a forward, 8 flash launches a forward in the
      child); inside workers a nested ``.remote``, ``put``/``get``/
      ``wait``, an actor from a task, a user error as its own type, a
      ``runtime_env`` env var, no JAX module, a print on the log channel
      and ``OwnerDiedError`` after its owner's process is killed; no
      child or thread alive after ``shutdown``;
  X2. ``train.Trainer(backend="torch")`` over 2 worker processes of
      ``{"GPU": 0.5}`` joined by a real gloo process group: L1's rank
      loop with ``torch.distributed.all_reduce`` on T2's model and batch,
      held to the whole-batch step within L1's tolerances; the step's
      p50 and the allreduce's share beside L1's, 16 forward and 8
      backward flash launches a step in each rank's process.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA, or without the package beside
this file, it exits non-zero at once.  Imports nothing of JAX.
"""

import dataclasses
import importlib
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 rate
# outside the tensor cores (class_fill does no matrix products) and the
# dense bf16 tensor-core rate (flash attention's inputs are bf16).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# P3's microbatches: 4 of 2 sequences each at bench_model.py's batch of 8.
PP_MICRO = 4
# The runtime phases' depth here, cut so that the whole run stays near
# half of its time limit on a card machine whose host runs 3-4x slower
# than usual: R3's leases (10,000 of the configuration's 100,000;
# ``tools.profile_cluster`` runs it whole), C2's tasks (25,000 of
# 100,000; ``tools.profile_tasks``) and K1's calls an actor (16 of 64;
# ``tools.profile_actors``).
R3_LEASES = 10_000
C2_TASKS = 25_000
K1_CALLS = 16


def log(*a):
    print(*a, flush=True)


def arrival_stream(rng, counts, ticks, per_tick=130_000):
    """Tick 0 delivers the whole backlog; later ticks about the
    placement rate, with a rotating per-class mix."""
    C = counts.shape[0]
    stream = np.empty((ticks, C), dtype=np.int64)
    stream[0] = counts
    frac = counts / counts.sum()
    for k in range(1, ticks):
        mix = np.roll(frac, k)
        row = np.floor(mix * per_tick).astype(np.int64)
        row += rng.integers(0, 3, size=C)
        stream[k] = row
    return stream


def fill_bound(x, allocs):
    """Least time for one call on these inputs: bytes read once and
    written once over HBM bandwidth, against the float32 operations
    this data needs, over the float32 rate."""
    r_pad, n_pad = x["av_t"].shape
    c_pad = x["demand"].shape[0]
    read = sum(t.numel() * t.element_size() for t in x.values()) + 8
    written = (r_pad * n_pad + c_pad * n_pad) * 4
    # Per (class, node) and demanded resource: a ratio (div), a min, a
    # utilization (sub, div) and a max; about 20 more per (class, node)
    # for cap, score, bucket, prefix and take; per placed (class, node)
    # and demanded resource the availability update (mul, sub).
    demanded = (x["demand"] > 0).sum(dim=1).double()
    placed = (allocs > 0).sum(dim=1).double()
    ops = float((n_pad * (5 * demanded + 20) + 2 * demanded * placed).sum())
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", read + written)


def edge_problems(torch, sb, dev):
    """The kernel's edge cases, as (name, class_fill inputs): the bench
    shape with 2% of its nodes empty and class 3 demanding nothing
    (count 1,000, so its caps sum to 10.1M, below 2^24), under shifts at
    0, at the block boundaries, at N_pad - 1 and inside blocks; then an
    N_pad of 1,003 (not a multiple of 8).  The bench shape's accelerator
    classes and nodes ride along in every case."""
    rng = np.random.default_rng(sb.SEED + 1)
    avail, total, demand, counts, an, ac = sb.build_problem(rng)
    empty = rng.random(avail.shape[0]) < 0.02
    avail[empty] = 0.0
    total[empty] = 0.0
    demand[3] = 0.0
    counts[3] = 1000
    x = sb.fill_inputs(avail, total, demand, counts, an, ac,
                       np.zeros((demand.shape[0], avail.shape[0])), dev)
    c_pad, n_pad = x["cost"].shape
    c = np.arange(c_pad)
    bounds = np.arange(8) * n_pad // 8
    shifts = {"shift 0": np.zeros(c_pad),
              "block boundaries": bounds[c % 8],
              "N_pad - 1": np.full(c_pad, n_pad - 1),
              "inside blocks": bounds[c % 8] + 1 + (37 * c) % (n_pad // 8 - 1)}
    for name, sh in shifts.items():
        yield name, dict(x, shifts=torch.from_numpy(
            sh.astype(np.int32)).to(dev))
    avail, total, demand, counts, an, ac = sb.build_problem(
        rng, num_tasks=20_000, C=64, N=1003)
    demand[5] = 0.0
    counts[5] = 1000
    small = {
        "av_t": avail.T, "total_t": total.T, "demand": demand,
        "counts": counts.astype(np.float32), "cost": np.where(
            rng.random((64, 1003)) < 0.1,
            rng.uniform(-0.6, 0.4, (64, 1003)), 0.0),
        "shifts": (np.arange(64) * 977) % 1003}
    y = {k: torch.from_numpy(np.ascontiguousarray(
        v, np.int32 if k == "shifts" else np.float32)).to(dev)
        for k, v in small.items()}
    y["accel_class"] = torch.from_numpy(ac).to(dev)
    y["accel_node"] = torch.from_numpy(an).to(dev)
    yield "N_pad 1,003", y


def phase_kernel(torch, cf, sb):
    """The kernel against its plain version on the card."""
    from ray_tpu_torch.tools.timing import events_ms
    dev = torch.device("cuda")
    worst = 0.0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        C, N, R = 40, 300 + 37 * seed, 5 if seed % 2 else 8
        avail = np.floor(rng.uniform(0, 8, (N, R))).astype(np.float32)
        total = avail + np.floor(rng.uniform(0, 4, (N, R))).astype(
            np.float32)
        demand = np.floor(rng.uniform(0, 2.2, (C, R))).astype(np.float32)
        counts = rng.integers(0, 50, C).astype(np.float32)
        an, ac = rng.random(N) < 0.2, rng.random(C) < 0.3
        for with_cost in (False, True):
            cost = (np.where(rng.random((C, N)) < 0.1,
                             rng.uniform(-0.6, 0.4, (C, N)), 0.0)
                    if with_cost else np.zeros((C, N)))
            x = sb.fill_inputs(avail, total, demand, counts, an, ac, cost, dev)
            for invert in (0.0, 1.0):
                thr = 0.3 if seed == 3 else 0.5
                av_k, al_k = sb.fill_call(cf.class_fill, x, thr, invert)
                torch.cuda.synchronize()
                av_r, al_r = sb.fill_call(cf.class_fill_reference, x, thr,
                                       invert)
                if not torch.equal(al_k, al_r):
                    bad = (al_k != al_r).nonzero()[:5].tolist()
                    raise AssertionError(
                        f"allocs differ (seed={seed} cost={with_cost} "
                        f"invert={invert}) at {bad}")
                err = (av_k - av_r).abs().max().item()
                if err > 1e-4:
                    raise AssertionError(f"availability differs by {err}")
                worst = max(worst, err)
    log(f"[kernel] 16 random problems: allocs bit-equal, max |av| diff "
        f"{worst}")
    names = []
    for name, x in edge_problems(torch, sb, dev):
        av_k, al_k = sb.fill_call(cf.class_fill, x, 0.5, 0.0)
        torch.cuda.synchronize()
        av_r, al_r = sb.fill_call(cf.class_fill_reference, x, 0.5, 0.0)
        if not (torch.equal(al_k, al_r) and torch.equal(av_k, av_r)):
            raise AssertionError(
                f"edge case {name}: allocs differ in "
                f"{int((al_k != al_r).sum())} entries, availability in "
                f"{int((av_k != av_r).sum())}")
        if al_k.sum() <= 0:
            raise AssertionError(f"edge case {name} placed nothing")
        names.append(name)
    log(f"[kernel] edge cases bit-equal (allocs and availability): "
        f"{', '.join(names)}")

    rng = np.random.default_rng(sb.SEED)
    avail, total, demand, counts, an, ac = sb.build_problem(rng)
    x = sb.fill_inputs(avail, total, demand, counts, an, ac,
                    np.zeros((demand.shape[0], avail.shape[0])), dev)
    av_k, al_k = sb.fill_call(cf.class_fill, x, 0.5, 0.0)
    torch.cuda.synchronize()
    av_r, al_r = sb.fill_call(cf.class_fill_reference, x, 0.5, 0.0)
    torch.cuda.synchronize()
    if not torch.equal(al_k, al_r):
        raise AssertionError("allocs differ at the bench shape: "
                             f"{int((al_k != al_r).sum())} entries")
    err = (av_k - av_r).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"availability differs by {err} at the bench "
                             "shape")
    worst = max(worst, err)
    placed = int(al_k.sum().item())
    ms = events_ms(lambda: sb.fill_call(cf.class_fill, x, 0.5, 0.0), iters=50)
    plain_ms = events_ms(lambda: sb.fill_call(cf.class_fill_reference, x, 0.5,
                                         0.0), iters=3, warmup=1)
    bound_ms, bound_by, nbytes = fill_bound(x, al_k)
    log(f"[kernel] bench shape C_pad={x['demand'].shape[0]} "
        f"N_pad={x['av_t'].shape[1]} R_pad={x['av_t'].shape[0]}: "
        f"bit-equal, {placed} tasks placed; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB, {bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_stream(torch, cf, tb, sb):
    """Path A: the closed-loop stream at full width."""
    rng = np.random.default_rng(sb.SEED)
    avail, total, demand, counts, an, ac = sb.build_problem(rng)
    stream = arrival_stream(rng, counts, 40, per_tick=130_000)
    ticks = stream.shape[0]
    rho = rng.integers(2, 9, size=demand.shape[0]) / 16.0

    cf.class_fill.launches = 0
    solver = tb.BatchSolver(device="cuda")
    solver.prepare_device(avail, total, demand, accel_node=an,
                          accel_class=ac, spread_threshold=0.5)
    out = solver.solve_stream(stream, rho=rho)
    if not out["ok"].all():
        raise AssertionError(f"on-device validation failed on ticks "
                             f"{np.nonzero(~out['ok'])[0].tolist()}")
    alloc0 = solver.expand_sparse(out["idx"][0], out["vals"][0])
    usage = alloc0.T.astype(np.float64) @ demand.astype(np.float64)
    if not (usage <= avail.astype(np.float64) + 1e-2).all():
        raise AssertionError("capacity violated on tick 0")
    if not (alloc0.sum(axis=1) <= stream[0]).all():
        raise AssertionError("count violated on tick 0")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        again = solver.solve_stream(stream, rho=rho)
    torch.cuda.synchronize()
    ms_tick = (time.perf_counter() - t0) / (reps * ticks) * 1e3
    launches = cf.class_fill.launches
    for key in ("idx", "vals", "placed", "ok", "nnz"):
        if not np.array_equal(out[key], again[key]):
            raise AssertionError(f"stream not deterministic in {key}")
    if launches != (reps + 1) * ticks:
        raise AssertionError(f"class_fill launched {launches} times, "
                             f"expected {(reps + 1) * ticks}")

    cpu = tb.BatchSolver(device="cpu")
    cpu.prepare_device(avail, total, demand, accel_node=an,
                       accel_class=ac, spread_threshold=0.5)
    ref = cpu.solve_stream(stream[:3], rho=rho)
    for key in ("idx", "vals", "placed", "ok", "nnz"):
        if not np.array_equal(out[key][:3], ref[key]):
            raise AssertionError(f"ticks 0-2 differ from the CPU run in "
                                 f"{key}")
    log(f"[path A] solve_stream {ticks} ticks x {reps} reps: "
        f"{ms_tick:.3f} ms/tick; placed tick0={int(out['placed'][0])} "
        f"total={int(out['placed'].sum())}; max nnz="
        f"{int(out['nnz'].max())}; class_fill launches={launches}; "
        f"ticks 0-2 bit-identical to device='cpu'")
    return launches, ms_tick


def _view_from(tres, names, total, avail):
    view = tres.ClusterResourceView()
    for i in range(total.shape[0]):
        nr = tres.NodeResources({names[r]: float(total[i, r])
                                 for r in range(total.shape[1])})
        nr.available = {names[r]: tres._quantize(avail[i, r])
                        for r in range(total.shape[1])
                        if tres._quantize(avail[i, r]) > 0}
        view.add_node(f"node{i:05d}", nr)
    return view


def phase_runtime(torch, cf, tb, tres, tpolicy, sb):
    """Path B: the raylet's per-tick session on a 10,000-node view."""
    rng = np.random.default_rng(7)
    avail, total, demand, _, _, _ = sb.build_problem(rng)
    names = ["CPU", "memory", "TPU", "GPU"] + [
        f"custom_{r}" for r in range(4, total.shape[1])]
    t0 = time.perf_counter()
    views = [_view_from(tres, names, total, avail) for _ in range(2)]
    log(f"[path B] two 10,000-node views built in "
        f"{time.perf_counter() - t0:.1f} s")

    class Spec:
        def __init__(self, cls):
            d = demand[cls]
            self.resources = tres.ResourceRequest(
                {names[r]: float(d[r]) for r in range(len(names))
                 if d[r] > 0})
            self.scheduling_options = tpolicy.SchedulingOptions.hybrid()
            self.scheduling_class = 5000 + cls

    def burst(n):
        cls = rng.integers(0, 64, size=n)
        return [Spec(int(c)) for c in cls]

    cf.class_fill.launches = 0
    gpu = tb.DeviceRuntimeSolver(device="cuda")
    cpu = tb.DeviceRuntimeSolver(device="cpu")
    tick_ms = []
    launches_before_cpu = None
    for n in (20_000, 20_000):
        specs = burst(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.solve(views[0], specs)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        launches_before_cpu = cf.class_fill.launches
        want = cpu.solve(views[1], specs)
        if got is None or want is None:
            raise AssertionError("runtime solver returned None")
        if got != want:
            diff = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"{diff} targets differ from the CPU "
                                 "solver")
        granted = 0
        for view in views:
            for t, s in zip(got, specs):
                if t is not None:
                    if not view.subtract(t, s.resources):
                        raise AssertionError(f"grant on {t} did not commit")
                    granted += 1
        log(f"[path B] tick: {n} specs, {granted // 2} granted and "
            f"committed, {tick_ms[-1]:.1f} ms")
    launches = cf.class_fill.launches
    if launches != launches_before_cpu or launches != 2:
        raise AssertionError(f"class_fill launched {launches} times in "
                             "path B, expected 2")
    st = gpu.stats
    if st["fallbacks"] != 0 or st["full_syncs"] != 1 or \
            st["row_deltas"] <= 0:
        raise AssertionError(f"runtime solver stats {st}")
    log(f"[path B] stats {st}; ms/tick full-sync {tick_ms[0]:.3f}, "
        f"delta {tick_ms[1]:.3f}; class_fill launches={launches}")
    return launches, tick_ms


# -- the tick's other consumers: bundles and sinkhorn ------------------------

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def _timed_calls(fn, reps):
    """Host ms per call of ``fn`` (it returns host arrays, so each call
    ends synchronised) over ``reps`` calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_bundles(tb, tbp, tres, sb):
    """``BatchSolver.solve_bundles`` and ``pack_bundles_kernel`` for a
    placement group of 256 bundles (a 256-worker job, one bundle a
    worker, demands from the seed over the bench's columns) on a
    10,000-node view of the bench's node shapes, under each strategy;
    STRICT_PACK, whose composite of 256 bundles fits no node, also for a
    group of 8.  Each solve bit-equal to ``device="cpu"``, each
    assignment validated on the host."""
    rng = np.random.default_rng(11)
    avail, total, _, _, _, _ = sb.build_problem(rng)
    names = ["CPU", "memory", "TPU", "GPU"] + [
        f"custom_{r}" for r in range(4, total.shape[1])]
    view = _view_from(tres, names, total, avail)

    def group(n):
        cpu = rng.choice([1.0, 2.0, 4.0], n)
        mem = rng.choice([2.0, 4.0, 8.0, 16.0], n)
        tpu = np.where(rng.random(n) < 0.125, 1.0, 0.0)
        return [tres.ResourceRequest(
            {"CPU": c, "memory": m, **({"TPU": t} if t else {})})
            for c, m, t in zip(cpu, mem, tpu)]

    groups = {256: group(256), 8: group(8)}
    node_ids, total_v, avail_v, _ = view.snapshot()
    results = {}
    for strategy in STRATEGIES:
        for n in ((256, 8) if strategy == "STRICT_PACK" else (256,)):
            bundles = groups[n]
            _, reqs = tbp.device_rows(bundles, strategy)
            demand = view.demand_matrix(reqs)
            demand = np.pad(demand, ((0, 0), (0, total_v.shape[1] -
                                              demand.shape[1])))
            card = tb.BatchSolver(device="cuda")
            got = card.solve_bundles(avail_v, total_v, demand, strategy)
            want = tb.BatchSolver(device="cpu").solve_bundles(
                avail_v, total_v, demand, strategy)
            if not (np.array_equal(got[0], want[0]) and
                    np.array_equal(got[1], want[1])):
                raise AssertionError(f"solve_bundles {strategy} x {n} on the "
                                     "card differs from device='cpu'")
            ms = _timed_calls(lambda: card.solve_bundles(
                avail_v, total_v, demand, strategy), 3)
            assignment = tbp.pack_bundles_kernel(view, bundles, strategy,
                                                 device="cuda")
            fits = strategy != "STRICT_PACK" or n == 8
            if fits:
                if assignment is None or not tbp.validate_assignment(
                        view, bundles, assignment, strategy, set()):
                    raise AssertionError(f"{strategy} x {n}: no valid "
                                         f"assignment ({assignment})")
                used = len(set(assignment))
            else:
                if assignment is not None or got[1].any() or \
                        tbp._pack_bundles_greedy(view, bundles,
                                                 strategy) is not None:
                    raise AssertionError(f"{strategy} x {n} should fit "
                                         "no node")
                used = 0
            results[f"{strategy} x {n}"] = ms
            log(f"[bundles] {strategy} x {n} bundles on {len(node_ids)} "
                f"nodes: {ms:.2f} ms per solve_bundles call, node_idx and ok "
                f"bit-equal to device='cpu'; "
                + (f"assignment valid, on {used} distinct nodes" if fits else
                   "infeasible on the card, the CPU and the greedy solve"))
    return results


def phase_sinkhorn(tb, sb):
    """``BatchSolver(mode="sinkhorn").solve_matrices`` on the bench
    problem (256 classes x 10,000 nodes x 8 resources, seed 42), one
    tick: capacity and counts held on the host, bit-equal to
    ``device="cpu"``."""
    avail, total, demand, counts, an, ac = sb.build_problem(
        np.random.default_rng(sb.SEED))
    card = tb.BatchSolver(mode="sinkhorn", device="cuda")
    got = card.solve_matrices(avail, total, demand, counts, an, ac)
    t0 = time.perf_counter()
    want = tb.BatchSolver(mode="sinkhorn", device="cpu").solve_matrices(
        avail, total, demand, counts, an, ac)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, want):
        raise AssertionError(f"sinkhorn allocations differ from "
                             f"device='cpu' in {int((got != want).sum())} "
                             "entries")
    usage = got.T.astype(np.float64) @ demand.astype(np.float64)
    if not (usage <= avail.astype(np.float64) + 1e-3).all():
        raise AssertionError("sinkhorn exceeds a node's availability")
    if not (got.sum(axis=1) <= counts).all() or got.sum() <= 0:
        raise AssertionError("sinkhorn exceeds a class's count or places "
                             "nothing")
    ms = _timed_calls(lambda: card.solve_matrices(
        avail, total, demand, counts, an, ac), 3)
    log(f"[sinkhorn] {demand.shape[0]} classes x {avail.shape[0]} nodes x "
        f"{avail.shape[1]} resources, {card.sinkhorn_iters} iterations: "
        f"{ms:.2f} ms per tick (device='cpu' {cpu_ms:.0f} ms), "
        f"{int(got.sum())} of {int(counts.sum())} tasks placed on "
        f"{int((got.sum(axis=0) > 0).sum())} nodes; usage within "
        f"availability, rows within counts, bit-equal to device='cpu'")
    return ms


# -- the raylet's scheduling plane and the autoscaler -------------------------

def _settle(loop, timeout=600.0):
    """Wait until ``loop`` has run everything posted to it, including
    what its handlers posted on the way."""
    import threading
    for _ in range(10_000):
        done, idle = threading.Event(), []

        def probe():
            idle.append(not loop._queue)
            done.set()
        loop.post(probe, "smoke.settle")
        if not done.wait(timeout):
            raise AssertionError(f"loop {loop.name} did not answer")
        if idle[0]:
            return
    raise AssertionError(f"loop {loop.name} never went idle")


def _reply_kind(res):
    if "worker" in res:
        return "grant"
    if "retry_at" in res:
        return "spill:" + res["retry_at"].hex()
    if res.get("infeasible"):
        return "infeasible"
    if res.get("backlog"):
        return "backlog"
    return "rejected"


def phase_raylet(torch, cf, sb):
    """R1: one ``Raylet`` on the card, its view at Path B's 10,000 nodes
    (its own row is the fleet's first node with neither TPU nor GPU,
    which CPU-only classes do not avoid; the other 9,999 rows arrive in
    one full ``update_resource_usage``), a burst of 20,000 leases in Path
    B's 64 classes through ``request_worker_lease_batch`` (batches of
    100), every reply held to a ``Raylet(device="cpu")`` fed the same
    view and burst.  The tick
    knobs are set out of reach while the burst is queued, then one
    ``schedule_and_dispatch`` is posted to each loop; the granted workers
    go back and the backlog is resubmitted, a round a tick, until no
    backlog is left or a round places nothing."""
    from ray_tpu_torch._private import ids
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.metrics_agent import get_metrics_registry
    from ray_tpu_torch._private.raylet import Raylet
    from ray_tpu_torch.tools.profile_cluster import (bench_names,
                                                     make_specs, row_dict)
    rng = np.random.default_rng(7)
    avail, total, demand, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    cfg = get_config()
    saved = (cfg.event_loop_tick_ms, cfg.scheduler_wakeup_debounce_ms)
    cfg.event_loop_tick_ms, cfg.scheduler_wakeup_debounce_ms = 10 ** 9, 1e9
    raylets = {}
    try:
        local = int(np.flatnonzero((total[:, 2] == 0) &
                                   (total[:, 3] == 0))[0])
        for dev in ("cuda", "cpu"):
            raylets[dev] = Raylet(None, row_dict(names, total[local]),
                                  node_name=f"r1-{dev}", device=dev)
        rows = {ids.NodeID(i.to_bytes(16, "big")): {
            "available": row_dict(names, avail[i]),
            "total": row_dict(names, total[i])}
            for i in range(total.shape[0]) if i != local}
        t0 = time.perf_counter()
        for r in raylets.values():
            r.update_resource_usage({"rows": rows, "full": True})
            _settle(r.loop)
        n_view = raylets["cuda"].cluster_view.num_nodes()
        log(f"[R1] two raylets' views at {n_view} nodes in "
            f"{time.perf_counter() - t0:.1f} s")
        classes = rng.integers(0, 64, size=20_000)
        specs = make_specs(names, demand, classes)
        replies = {dev: {} for dev in raylets}
        workers = {dev: {} for dev in raylets}

        def recorder(dev, keys):
            def reply(rep):
                for key, res in zip(keys, rep["results"]):
                    replies[dev].setdefault(key, []).append(_reply_kind(res))
                    if "worker" in res:
                        workers[dev][key] = res["worker"]
            return reply

        card = raylets["cuda"]
        label = card.cluster_task_manager._node_label
        cf.class_fill.launches = 0
        pending, tick_host_ms, rounds = list(range(len(specs))), [], 0
        while pending:
            for dev, r in raylets.items():
                for i in range(0, len(pending), 100):
                    keys = pending[i:i + 100]
                    r.request_worker_lease_batch([specs[k] for k in keys],
                                                 recorder(dev, keys))
            for dev, r in raylets.items():
                t0 = time.perf_counter()
                r.loop.post(r.cluster_task_manager.schedule_and_dispatch,
                            "cluster.schedule")
                _settle(r.loop)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    tick_host_ms.append((time.perf_counter() - t0) * 1e3)
            if replies["cuda"] != replies["cpu"]:
                diff = [k for k in replies["cpu"]
                        if replies["cuda"].get(k) != replies["cpu"][k]]
                raise AssertionError(
                    f"round {rounds}: {len(diff)} leases got another reply "
                    f"on the card than on the CPU (first {diff[:3]}: "
                    f"{[replies['cuda'].get(k) for k in diff[:3]]} vs "
                    f"{[replies['cpu'][k] for k in diff[:3]]})")
            rounds += 1
            for dev, r in raylets.items():
                for key in sorted(workers[dev]):
                    r.return_worker(workers[dev].pop(key))
                _settle(r.loop)
            backlog = [k for k in pending if replies["cpu"][k][-1] ==
                       "backlog"]
            if len(backlog) == len(pending):
                break
            pending = backlog
        launches = cf.class_fill.launches
        mgr = card.cluster_task_manager
        ts, st = dict(mgr.tick_stats), dict(mgr._solver.stats)
        hist = get_metrics_registry().get_value(
            "ray_tpu.scheduler.tick_latency", (("node", label),))
        handler_errors = sum(h["errors"]
                             for r in raylets.values()
                             for h in r.loop.handler_stats.values())
        if launches != st["ticks"] or launches < 1:
            raise AssertionError(f"class_fill launched {launches} times for "
                                 f"{st['ticks']} batched ticks ({ts})")
        for r in raylets.values():
            t = r.cluster_task_manager.tick_stats
            if t["jnp_fallbacks"] or t["device_errors"] or \
                    t["dispatch_errors"]:
                raise AssertionError(f"tick_stats {t}")
        if handler_errors or st["fallbacks"]:
            raise AssertionError(f"{handler_errors} handler errors, solver "
                                 f"{st}")
        final = [v[-1].split(":")[0] for v in replies["cpu"].values()]
        decisions = {kind: final.count(kind) for kind in
                     ("grant", "spill", "backlog", "infeasible", "rejected")}
        series = [line for line in
                  get_metrics_registry().render_prometheus().splitlines()
                  if line.startswith("ray_tpu_scheduler_") and
                  f'node="{label}"' in line]
        hist_ms = hist.sum / hist.count * 1e3
        log(f"[R1] {len(specs)} leases, {rounds} rounds: replies on the card "
            f"equal the CPU raylet's for every lease; final {decisions}; "
            f"busy ticks {ts['busy_ticks']}, ms per busy tick "
            f"{hist_ms:.3f} (histogram) / host "
            f"{[round(x, 3) for x in tick_host_ms]}; class_fill launches "
            f"{launches}; tick_stats {ts}; solver {st}")
        log(f"[R1] {len(series)} ray_tpu_scheduler_* series for node "
            f"{label}:\n  " + "\n  ".join(series))
        return {"launches": launches, "tick_ms": hist_ms,
                "tick_host_ms": tick_host_ms, "decisions": decisions,
                "rounds": rounds, "tick_stats": ts, "solver": st}
    finally:
        for r in raylets.values():
            r.shutdown()
        cfg.event_loop_tick_ms, cfg.scheduler_wakeup_debounce_ms = saved


def phase_autoscaler(torch, cf, sb):
    """R2: the autoscaler's pack mode at 10,000 nodes: the R1 burst's
    20,000 demands packed onto the bench fleet's available rows
    (``get_bin_pack_residual``), then ``get_nodes_to_launch`` with node
    types for the fleet's three kinds (10,000 each at most) and one
    8-bundle STRICT_SPREAD group; every output equal to
    ``device="cpu"``'s, ms per call after one warm-up over 3 calls."""
    from ray_tpu_torch.autoscaler import resource_demand_scheduler as rds
    from ray_tpu_torch.tools.profile_cluster import bench_names, row_dict
    from ray_tpu_torch.tools.timing import device_profile
    rng = np.random.default_rng(7)
    avail, total, demand, _, _, _ = sb.build_problem(rng)
    names = bench_names(total)
    classes = rng.integers(0, 64, size=20_000)
    nodes = [row_dict(names, avail[i]) for i in range(avail.shape[0])]
    rows = [row_dict(names, demand[c]) for c in range(demand.shape[0])]
    demands = [rows[int(c)] for c in classes]
    types = {"small": {"resources": {"CPU": 4, "memory": 16},
                       "max_workers": 10_000},
             "big": {"resources": {"CPU": 64, "memory": 256},
                     "max_workers": 10_000},
             "accel": {"resources": {"CPU": 8, "memory": 64, "TPU": 4},
                       "max_workers": 10_000}}
    launch_args = dict(
        node_type_counts={}, launching_nodes={},
        resource_demands=demands,
        unused_resources_by_node={f"n{i}": n for i, n in enumerate(nodes)},
        pending_placement_groups=[{"strategy": "STRICT_SPREAD",
                                   "bundles": [{"CPU": 1}] * 8}])
    scheds = {dev: rds.ResourceDemandScheduler(types, max_workers=10_000,
                                               device=dev)
              for dev in ("cuda", "cpu")}
    before = dict(rds.kernel_stats)
    cf.class_fill.launches = 0
    residual = rds.get_bin_pack_residual(nodes, demands, device="cuda")
    launch = scheds["cuda"].get_nodes_to_launch(**launch_args)
    ms_residual = _timed_calls(
        lambda: rds.get_bin_pack_residual(nodes, demands, device="cuda"), 3)
    ms_launch = _timed_calls(
        lambda: scheds["cuda"].get_nodes_to_launch(**launch_args), 3)
    launches = cf.class_fill.launches
    solves = rds.kernel_stats["kernel_solves"] - before["kernel_solves"]
    t0 = time.perf_counter()
    want_residual = rds.get_bin_pack_residual(nodes, demands, device="cpu")
    want_launch = scheds["cpu"].get_nodes_to_launch(**launch_args)
    cpu_s = time.perf_counter() - t0
    if residual[0] != want_residual[0] or residual[1] != want_residual[1]:
        raise AssertionError("get_bin_pack_residual on the card differs "
                             "from device='cpu'")
    if launch != want_launch:
        raise AssertionError(f"get_nodes_to_launch on the card {launch[0]} "
                             f"differs from device='cpu' {want_launch[0]}")
    if solves <= 0 or rds.kernel_stats["kernel_errors"] != \
            before["kernel_errors"] or launches != solves:
        raise AssertionError(f"kernel_stats {rds.kernel_stats} (before "
                             f"{before}), class_fill launches {launches}")
    # The device's share of each call: one more call of each under
    # torch.profiler, after the launches above were read.
    dev_residual, ops_residual = device_profile(
        lambda: rds.get_bin_pack_residual(nodes, demands, device="cuda"))
    dev_launch, ops_launch = device_profile(
        lambda: scheds["cuda"].get_nodes_to_launch(**launch_args))
    log(f"[R2] {len(demands)} demands on {len(nodes)} nodes: residual "
        f"{len(residual[0])} unfulfilled, {ms_residual:.2f} ms per "
        f"get_bin_pack_residual (device {dev_residual:.3f} ms in "
        f"{ops_residual} operations); get_nodes_to_launch {launch[0]} with "
        f"{len(launch[1])} unfulfilled, {ms_launch:.2f} ms per call (device "
        f"{dev_launch:.3f} ms in {ops_launch} operations); outputs equal to "
        f"device='cpu' ({cpu_s:.1f} s there); {solves} kernel solves, "
        f"class_fill launches {launches}")
    return {"launches": launches, "ms_residual": ms_residual,
            "ms_launch": ms_launch, "device_ms_residual": dev_residual,
            "device_ms_launch": dev_launch,
            "unfulfilled": len(residual[0]), "to_launch": launch[0]}


def phase_tasks_single(cf):
    """C1: ``profile_tasks.single_node`` on the card (module docstring);
    every value is checked inside."""
    from ray_tpu_torch.tools import profile_tasks as pt
    cf.class_fill.launches = 0
    out = pt.single_node("cuda")
    out["launches"] = cf.class_fill.launches
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"C1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    log(f"[C1] one raylet, {out['num_cpus']} CPUs: {out['tasks']} no-op "
        f"tasks at {out['tasks_per_s']:.0f} tasks/s; submit to running "
        f"p50 {out['latency_p50_ms']:.3f} ms p99 "
        f"{out['latency_p99_ms']:.3f} ms; {out['args']} args in "
        f"{out['args_s']:.3f} s, {out['returns']} returns in "
        f"{out['returns_s']:.3f} s, a get of {out['get_many']} in "
        f"{out['get_many_s']:.3f} s, all values right; batched ticks "
        f"{out['batched_ticks']} of {out['busy_ticks']} busy, class_fill "
        f"launches {out['launches']}; jnp_fallbacks "
        f"{out['jnp_fallbacks']}, device_errors {out['device_errors']}; "
        f"lease stats {out['lease_stats']}; peak workers "
        f"{out['peak_workers']}")
    return out


def phase_tasks_cluster(cf):
    """C2: ``profile_tasks.cluster_tasks`` on the card: ``C2_TASKS``
    tasks over 64 raylets, every kept one's result its index."""
    from ray_tpu_torch.tools import profile_tasks as pt
    cf.class_fill.launches = 0
    out = pt.cluster_tasks(C2_TASKS, pt.C2_RAYLETS, "cuda")
    out["launches"] = cf.class_fill.launches
    if out["launches"] < 1 or \
            out["launches"] != sum(out["batched_ticks"].values()):
        raise AssertionError(f"C2: class_fill launched {out['launches']} "
                             f"times, batched ticks {out['batched_ticks']}")
    ev = out["events"]
    stages = "; ".join(f"{k} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} "
                       f"ms ({v['count']})" for k, v in ev["stages"].items())
    log(f"[E1] task events of C2: {ev['tracked']} records tracked + "
        f"{ev['evicted']} evicted = {ev['tracked'] + ev['evicted']} tasks, "
        f"{ev['dropped_at_source']} dropped at the source, every tracked "
        f"record FINISHED with its lifecycle in order ({ev['stragglers']} "
        f"with a straggling SCHEDULED after it); {ev['late_grants']} "
        f"records opened by a late lease grant; stages: {stages}")
    log(f"[C2] {out['raylets']} raylets, {out['cpus']:.0f} CPUs: "
        f"{out['submitted']} of {out['tasks']} tasks submitted (cut: "
        f"{out['dropped_infeasible']} tasks, share "
        f"{out['dropped_share']:.4f}, of {out['dropped_classes']} classes "
        f"no node fits), every result its index, read once; "
        f"{out['tasks_per_s']:.0f} tasks/s, wall {out['wall_s']:.1f} s "
        f"(submitting {out['submit_s']:.1f} s); submit to sealed p50 "
        f"{out['latency_p50_ms']:.1f} ms p99 {out['latency_p99_ms']:.1f} "
        f"ms; class_fill launches {out['launches']} (batched ticks by "
        f"raylet {out['batched_ticks']}); spillbacks {out['spillbacks']}, "
        f"rejected at their target {out['spillback_rejections']}, "
        f"submitter {out['submitter']}; peak worker threads "
        f"{out['peak_workers']} (each raylet's peak, summed)")
    return out


def phase_heartbeat(cf):
    """H1: ``profile_gcs.heartbeat_death`` on the card (module docstring);
    its checks run inside, the launches are held to the batched ticks
    here."""
    from ray_tpu_torch.tools import profile_gcs as pgc
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pgc.heartbeat_death("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("H1")
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"H1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    ms = lambda xs: ", ".join(f"{x:.0f}" for x in xs)  # noqa: E731
    log(f"[H1] {out['raylets']} raylets, {out['victims']} killed a quarter "
        f"into {out['tasks']} tasks: kill to SUSPECT "
        f"[{ms(out['kill_to_suspect_ms'])}] ms, kill to DEAD "
        f"[{ms(out['kill_to_dead_ms'])}] ms (bound {out['bound_ms']:.0f}); "
        f"{out['masked_ticks']} device solves under a mask, "
        f"{out['masked_placements']} device placements on a masked node; "
        f"every result right; {out['arrays_lost']} of {out['arrays']} "
        f"arrays lost and recomputed ({out['reconstructions']} "
        f"reconstructions), all byte-equal, dead to last array "
        f"{out['dead_to_arrays_ms']:.0f} ms; {out['groups_moved']} groups "
        f"CREATED again on live nodes, dead to CREATED "
        f"{out['dead_to_created_ms']:.0f} ms; {out['tasks_per_s']:.0f} "
        f"tasks/s; class_fill launches {out['launches']} = batched ticks; "
        f"GCS loop lag max {out['gcs_loop_lag_max_ms']:.1f} ms; submitter "
        f"{out['submitter']}")
    return out


def phase_gcs_restart(cf):
    """H2: ``profile_gcs.gcs_restart`` on the card (module docstring)."""
    from ray_tpu_torch.tools import profile_gcs as pgc
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pgc.gcs_restart("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("H2")
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"H2: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    r = out["restart_ms"]
    log(f"[H2] {out['groups_kept']} of {out['groups']} groups CREATED on "
        f"their bundle nodes after restart_gcs, the deleted group's "
        f"bundles released on its {out['leaked_group_nodes']} node(s); "
        f"{out['actors'] - 1} live actors re-attached ALIVE and counting "
        f"on, {out['named']} named ones found, the one whose worker died "
        f"in the outage ALIVE again after one restart; restart "
        f"{out['restart_total_ms']:.1f} ms (shutdown "
        f"{r['shutdown']:.1f}, reload {r['reload']:.1f}, reconcile "
        f"{r['reconcile']:.1f}, of which actors "
        f"{r['reconcile_actors']:.1f}); journal {out['journal_bytes']} "
        f"bytes; "
        f"{out['tasks']} tasks into bundles right at "
        f"{out['tasks_per_s']:.0f} tasks/s, {out['batched_ticks_after']} "
        f"batched ticks after the restart; class_fill launches "
        f"{out['launches']}")
    return out


def phase_actors(cf):
    """K1: ``profile_actors.actors`` on the card (its module docstring):
    1,024 actors on R3's 64 raylets, their calls, kills and resources;
    its checks run inside, the launches are held to the batched ticks
    here."""
    from ray_tpu_torch.tools import profile_actors as pa
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pa.actors("cuda", calls=K1_CALLS)
    out["launches"] = cf.class_fill.launches
    check_no_threads("K1")
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"K1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    log(f"[K1] {out['actors']} actors on {out['raylets']} raylets "
        f"({out['default']} default, {out['held']} held, "
        f"{out['held_cut']} of {out['held_drawn']} held draws cut): "
        f"create to ALIVE p50 {out['create_to_alive_p50_ms']:.1f} ms p99 "
        f"{out['create_to_alive_p99_ms']:.1f} ms, "
        f"{out['alive_per_s']:.0f} actors ALIVE/s; {out['calls']} calls "
        f"in order at {out['calls_per_s']:.0f} calls/s, submit to sealed "
        f"p50 {out['call_p50_ms']:.2f} ms p99 {out['call_p99_ms']:.2f} ms; "
        f"named, max_concurrency and concurrency groups right; "
        f"{out['tasks']} tasks through passed handles at "
        f"{out['tasks_per_s']:.0f}/s; {out['killed']} killed, resources "
        f"back, their calls ActorDiedError; class_fill launches "
        f"{out['launches']} = batched ticks; GCS actor handlers "
        f"{out['gcs_actor_handlers']}, loop lag max "
        f"{out['gcs_loop_lag_max_ms']:.1f} ms, the raylets' loops' "
        f"{out['raylet_loop_lag_max_ms']:.1f} ms; threads with the actors "
        f"{out['threads_with_actors']}, peak workers "
        f"{out['peak_workers']}")
    return out


def phase_actor_faults(cf):
    """K2: ``profile_actors.actor_faults`` on the card (its module
    docstring): 8 of R3's 64 raylets killed under 512 actors' calls."""
    from ray_tpu_torch.tools import profile_actors as pa
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pa.actor_faults("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("K2")
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"K2: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    ms = ", ".join(f"{x:.0f}" for x in out["kill_to_dead_ms"])
    log(f"[K2] {out['victims']} raylets killed under {out['actors']} "
        f"actors' {out['calls']} calls: {out['actors_on_victims']} actors "
        f"on them, {out['restarted']} ALIVE again once each after their "
        f"node's DEAD (none while SUSPECT), {out['buried']} DEAD with "
        f"ActorDiedError; kill to DEAD [{ms}] ms; last DEAD to last ALIVE "
        f"{out['dead_to_last_alive_ms']:.0f} ms; {out['calls_failed']} "
        f"calls failed, {out['calls_system_failures']} system failures "
        f"answered and retried or failed; no call sealed from a dead "
        f"node's thread; class_fill launches {out['launches']} = batched "
        f"ticks; GCS actor handlers {out['gcs_actor_handlers']}, loop lag "
        f"max {out['gcs_loop_lag_max_ms']:.1f} ms")
    return out


def phase_device_objects(cf):
    """D1: ``profile_device.device_objects`` on the card (its module
    docstring); its checks run inside."""
    from ray_tpu_torch.tools import profile_device as pd
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pd.device_objects("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("D1")
    if out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"D1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    pulls = "; ".join(
        f"{k} {p['bytes'] / 2**20:.0f} MiB: device-to-host "
        f"{p['d2h_gbps']:.2f} GB/s, the read {p['read_ms']:.1f} ms "
        f"({p['read_gbps']:.2f} GB/s)" for k, p in out["pulls"].items())
    sp = out["spill"]
    log(f"[D1] put of {out['gib']:.0f} GiB float32 on the card "
        f"{out['put_ms']:.3f} ms, {out['put_device_bytes']} bytes copied "
        f"on the device, {out['put_host_bytes']} on the host; get gives "
        f"the stored CUDA tensor; an actor read it with "
        f"{out['actor_host_bytes']} host bytes copied; a "
        f"{out['return_mib']} MiB return a device entry on the head alone; "
        f"pulled bit for bit: {pulls}; a small inline tensor arrived on the "
        f"CPU; a {sp['capacity_mib']} MiB store holding {sp['device_mib']} "
        f"MiB of device entries took {sp['numpy_mib']} MiB of numpy "
        f"returns and spilled {sp['spilled_objects']} numpy entries and "
        f"no device entry; GPU {out['gpus']:.0f}, a num_gpus=1 task saw "
        f"[0]; class_fill launches {out['launches']} = batched ticks")
    return out


def phase_util(cf):
    """U1: ``profile_device.util_library`` on the card (its module
    docstring); its checks run inside."""
    from ray_tpu_torch.tools import profile_device as pd
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pd.util_library("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("U1")
    if out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"U1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    ms = ", ".join(f"{k} {v:.1f}" for k, v in out["ms"].items())
    log(f"[U1] {out['ranks']} ranks x {out['elements']} float32 (16 MiB) "
        f"CUDA tensors, {out['reductions']} reductions by device, each "
        f"result held to numpy; ms per collective: {ms}; ActorPool.map "
        f"{out['pool_calls_per_s']:.0f} calls/s in order; Queue "
        f"{out['queue_items_per_s']:.0f} items/s; ParallelIterator "
        f"{out['iter_items_per_s']:.0f} items/s; metrics rendered; "
        f"class_fill launches {out['launches']} = batched ticks")
    return out


def phase_objects(cf):
    """O1-O5: the object plane through ``ray_tpu_torch.init`` on the card
    (``ray_tpu_torch.tools.profile_objects``; module docstring).  Each
    phase checks its values and its raylets' error counts inside, is
    driven with the launch count at 0, read after it (every launch is one
    of a raylet's batched ticks), and leaves no thread of the port behind
    its shutdown.  O5's 2-raylet and 64-raylet bursts run at the source's
    shape, one class, which never reaches the batched tick (their cost
    launches are reported); its probes of one class a consumer launch
    ``class_fill`` with a non-zero cost."""
    from ray_tpu_torch.tools import profile_objects as po
    out = {}
    for key, fn in (("O1", po.large_objects), ("O2", po.broadcast),
                    ("O3", po.spilling), ("O4", po.reconstruction),
                    ("O5", po.locality)):
        cf.class_fill.launches = 0
        t0 = time.perf_counter()
        res = fn("cuda")
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = cf.class_fill.launches
        po.check_no_threads(key)
        out[key] = res
        log(f"[{key}] {json.dumps(res, default=str)}")
    o5 = out["O5"]
    for case in ("two_classes", "r3_classes"):
        if o5[case]["cost_launches"] < 1 or o5[case]["cost_ticks"] < 1:
            raise AssertionError(f"O5 {case}: no class_fill launch with "
                                 f"the locality cost: {o5[case]}")
    for case in ("two", "two_classes"):
        if o5[case]["cross_node_fetch_bytes"] != 0:
            raise AssertionError(f"O5 {case}: cross-node bytes under "
                                 f"locality: {o5[case]}")
    if o5["launches"] < 1:
        raise AssertionError("O5: class_fill never launched")
    o1, o2, o3, o4 = out["O1"], out["O2"], out["O3"], out["O4"]
    log(f"[objects] O1 1 GiB: put {o1['put_ms']:.3f} ms, "
        f"{o1['put_bytes_copied']} bytes copied (cold "
        f"{o1['cold_put_ms']:.3f} ms), get view {o1['get_view_ms']:.3f} ms, "
        f"get {o1['get_gbps']:.2f} GB/s, 16 MiB arg+return task "
        f"{o1['task_s']:.3f} s; O2 256 MiB to 8 raylets: fetch "
        f"{o2['fetch_gbps']:.2f} GB/s (cold {o2['cold_fetch_gbps']:.2f}), "
        f"relay pulls {o2['relay_pulls']}, cross-node bytes "
        f"{o2['cross_node_fetch_bytes']}; O3 2 GiB through 1 GiB: "
        f"{o3['spilled_objects']} objects spilled, "
        f"{o3['restored_objects']} restored, {o3['spill_batches']} "
        f"batches, put {o3['put_s_per_gib']:.2f} s/GiB, get "
        f"{o3['get_s_per_gib']:.2f} s/GiB; O4 recovered in "
        f"{o4['recover_s']:.3f} s, loss raised in {o4['lost_s']:.3f} s; "
        f"O5 share on the holder {o5['two']['share_on_home']} (2 raylets, "
        f"one class), {o5['r3']['share_on_home']} (64), cost launches "
        f"{o5['two']['cost_launches']} + {o5['r3']['cost_launches']}; "
        f"probes of one class a consumer: share "
        f"{o5['two_classes']['share_on_home']} + "
        f"{o5['r3_classes']['share_on_home']}, cost launches "
        f"{o5['two_classes']['cost_launches']} + "
        f"{o5['r3_classes']['cost_launches']}; "
        f"walls {[round(out[k]['wall_s'], 1) for k in sorted(out)]} s")
    return out


def _widest_fill(cf, tb):
    """Wraps ``tb.class_fill`` (the tick's call of the kernel) to keep
    copies of the inputs of its widest call; returns (the record,
    restore).  The wrapped call is the kernel's, counted as before."""
    real = tb.class_fill
    widest = {}

    def keep(av_t, total_t, demand, counts, accel_class, accel_node, thr,
             cost, invert, shifts):
        if av_t.shape[0] > widest.get("r_pad", 0):
            widest.clear()
            widest.update(r_pad=av_t.shape[0], thr=thr, invert=invert, x={
                k: v.clone() for k, v in zip(
                    ("av_t", "total_t", "demand", "counts", "accel_class",
                     "accel_node", "cost", "shifts"),
                    (av_t, total_t, demand, counts, accel_class, accel_node,
                     cost, shifts))})
        return real(av_t, total_t, demand, counts, accel_class, accel_node,
                    thr, cost, invert, shifts)
    tb.class_fill = keep

    def restore():
        tb.class_fill = real
    return widest, restore


def _time_fill(torch, cf, sb, x, thr, invert, label):
    """``class_fill`` on ``x`` against its plain version, in
    ``phase_kernel``'s manner: bit-equal, then both timed."""
    from ray_tpu_torch.tools.timing import events_ms
    r_pad, n_pad = x["av_t"].shape
    av_k, al_k = sb.fill_call(cf.class_fill, x, thr, invert)
    torch.cuda.synchronize()
    av_r, al_r = sb.fill_call(cf.class_fill_reference, x, thr, invert)
    torch.cuda.synchronize()
    if not (torch.equal(al_k, al_r) and torch.equal(av_k, av_r)):
        raise AssertionError(
            f"{label}: allocs differ in {int((al_k != al_r).sum())} "
            f"entries, availability in {int((av_k != av_r).sum())}")
    ms = events_ms(lambda: sb.fill_call(cf.class_fill, x, thr, invert), iters=20)
    plain_ms = events_ms(lambda: sb.fill_call(cf.class_fill_reference, x, thr,
                                         invert), iters=3, warmup=1)
    bound_ms, bound_by, nbytes = fill_bound(x, al_k)
    out = {"c_pad": x["demand"].shape[0], "n_pad": n_pad, "r_pad": r_pad,
           "route": cf.kernel_route(n_pad, r_pad), "max_abs_err": 0.0,
           "placed": int(al_k.sum().item()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    log(f"[{label}] class_fill C_pad={out['c_pad']} N_pad={n_pad} "
        f"R_pad={r_pad} ({out['route']} route): bit-equal, "
        f"{out['placed']} placed; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB, {bound_by})")
    return out


def phase_groups(torch, cf, tb, sb):
    """G1: ``profile_groups.groups`` on the card against a
    ``device="cpu"`` run (module docstring), then ``class_fill`` at G1's
    widest call and at the bench problem widened to its R_pad."""
    from ray_tpu_torch.tools import profile_groups as pgr
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.profile_tasks import _profiled
    cpu = pgr.groups("cpu")
    check_no_threads("G1 (cpu)")
    widest, restore = _widest_fill(cf, tb)
    cf.class_fill.launches = 0
    try:
        out = _profiled(torch, lambda: pgr.groups("cuda"))
    finally:
        restore()
    out["launches"] = cf.class_fill.launches
    check_no_threads("G1")
    if out["placements"] != cpu["placements"]:
        raise AssertionError(f"G1: bundle nodes differ from the CPU run: "
                             f"{out['placements']} vs {cpu['placements']}")
    if out["launches"] < 1 or out["launches"] != out["batched_ticks"]:
        raise AssertionError(f"G1: class_fill launched {out['launches']} "
                             f"times for {out['batched_ticks']} batched "
                             "ticks")
    if out["r_pad"] <= 64 or widest.get("r_pad", 0) != out["r_pad"]:
        raise AssertionError(f"G1: class_fill at R_pad "
                             f"{widest.get('r_pad')}, solvers at "
                             f"{out['r_pad']}: not past 64")
    log(f"[G1] {out['groups']} groups ({out['bundles']} bundles) on "
        f"{pgr.N_RAYLETS} raylets, all CREATED on the CPU run's nodes; "
        f"placement_group() to wait() p50 {out['create_wait_p50_ms']:.2f} "
        f"ms p99 {out['create_wait_p99_ms']:.2f} ms; {out['bundle_solves']} "
        f"bundle solves at {out['bundle_solve_ms']:.2f} ms each "
        f"({out['bundle_stats']}); {out['bundles']} tasks on their "
        f"bundles' nodes at {out['tasks_per_s']:.0f} tasks/s; views of "
        f"{out['view_columns']} columns, R_pad {out['r_pad']}, full uploads "
        f"{out['full_syncs']}; class_fill launches {out['launches']}; "
        f"device {out['device_ms']:.2f} ms of {out['profiled_wall_ms']:.0f} "
        f"ms, idle share {out['idle_share']:.5f}; resources restored")
    out["fill_g1"] = _time_fill(torch, cf, sb, widest["x"], widest["thr"],
                                widest["invert"], "G1 fill")
    # The bench problem (10,000 nodes) widened to G1's R_pad by empty
    # columns, as bundles widen a large cluster's view.
    rng = np.random.default_rng(sb.SEED)
    avail, total, demand, counts, an, ac = sb.build_problem(rng)
    pad = out["r_pad"] - avail.shape[1]
    widen = lambda a: np.pad(a, ((0, 0), (0, pad)))  # noqa: E731
    x = sb.fill_inputs(widen(avail), widen(total), widen(demand), counts,
                       an, ac, np.zeros((demand.shape[0], avail.shape[0])),
                       torch.device("cuda"))
    out["fill_wide"] = _time_fill(torch, cf, sb, x, 0.5, 0.0, "wide fill")
    if out["fill_wide"]["route"] != "global":
        raise AssertionError("the widened bench problem should take the "
                             "kernel's global route")
    return out


def phase_autoscaler_loop(cf):
    """A1: ``profile_groups.autoscaler_loop`` on the card (module
    docstring); its rounds are held to the CPU twin inside."""
    from ray_tpu_torch.tools import profile_groups as pgr
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    out = pgr.autoscaler_loop("cuda")
    out["launches"] = cf.class_fill.launches
    check_no_threads("A1")
    if out["autoscaler_solves"] < 1 or \
            out["launches"] < out["autoscaler_solves"]:
        raise AssertionError(f"A1: {out['autoscaler_solves']} autoscaler "
                             f"solves, class_fill launches "
                             f"{out['launches']}")
    if out["workers_left"] != 0:
        raise AssertionError(f"A1: {out['workers_left']} workers left")
    log(f"[A1] {out['tasks']} tasks done on launched nodes in "
        f"{out['burst_to_last_result_s']:.2f} s (burst to last result); "
        f"{out['rounds']} rounds, each one's launches equal to the CPU "
        f"autoscaler's; update_all mean {out['update_ms_mean']:.1f} ms "
        f"(p50 {out['update_ms_p50']:.1f}, max {out['update_ms_max']:.1f}); "
        f"autoscaler solves on class_fill {out['autoscaler_solves']}, "
        f"class_fill launches {out['launches']} (with the raylets' ticks "
        f"{out['batched_ticks']}); nodes launched {out['nodes_launched']} "
        f"(peak {out['peak_workers']}), terminated "
        f"{out['nodes_terminated']} down to min_workers in "
        f"{out['drain_rounds']} rounds")
    return out


def phase_cluster(torch, cf):
    """R3: ``profile_cluster.cluster_burst`` on the card: a burst of
    ``R3_LEASES`` leases across a ``Cluster`` of 64 raylets from a
    lessee with the reference submitter's protocol, each spillback re-sent
    at once with ``grant_or_reject``.  Every feasible lease granted exactly
    once, no raylet error, no solver fallback, one ``class_fill`` launch
    per batched tick."""
    from ray_tpu_torch.tools import profile_cluster as pc
    cf.class_fill.launches = 0
    out = pc.cluster_burst(R3_LEASES, "cuda")
    launches = out["launches"] = cf.class_fill.launches
    if launches != out["solver"]["ticks"] or launches < 1:
        raise AssertionError(f"R3: class_fill launched {launches} times, "
                             f"solvers {out['solver']}")
    log(f"[R3] {out['leases']} leases over {pc.N_RAYLETS} raylets in "
        f"{out['wall_s']:.1f} s: {out['granted']} granted exactly once, "
        f"{out['infeasible']} infeasible; {out['leases_per_s']:.0f} "
        f"leases/s, latency p50 {out['p50_ms']:.2f} ms p99 "
        f"{out['p99_ms']:.2f} ms; {out['spillbacks']} spillbacks, "
        f"{out['rejections']} rejected at their target, "
        f"{out['backlog_replies']} backlog replies; batched ticks on "
        f"{out['raylets_with_batched_ticks']} raylets, class_fill launches "
        f"{launches}; solvers {out['solver']}")
    return out

# -- the transformer's forward pass ------------------------------------------

# Kernel against plain version.  float32: both sum in float32 in other
# orders (fmaf in the kernel, cuBLAS in the plain version).  bfloat16:
# the same float32 values may round to neighbouring bf16 outputs, one
# bf16 ulp (at most 2**-7 of the value), plus 1e-5 near zero.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}


def flash_excess(got, want):
    """Largest amount by which |got - want| exceeds atol + rtol |want|
    (<= 0 when within tolerance), and the largest |got - want|."""
    atol, rtol = FLASH_TOL[str(want.dtype).split(".")[-1]]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float((diff - atol - rtol * w.abs()).max()), float(diff.max())


def flash_bound(B, L, H, D, esize, causal=True):
    """Least time for one call: q, k, v read once and out written once
    over HBM bandwidth, against the two products over the (query, key)
    pairs the mask keeps, at the bf16 tensor-core rate."""
    nbytes = 4 * B * L * H * D * esize
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    flops = 2 * 2 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_flash(torch, fa, mb):
    """The flash kernel against its plain version on the card, then timed
    at the model's shape beside its bound and one library call."""
    from ray_tpu_torch.tools.timing import events_ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for L, D in ((128, 64), (384, 64), (512, 64), (2048, 64),
                     (256, 128), (1024, 128), (2048, 128), (256, 96),
                     (1024, 96), (256, 256), (1024, 256)):
            qkv = [torch.from_numpy(rng.standard_normal(
                (2, L, 4, D)).astype(np.float32)).to(dev, dtype)
                for _ in range(3)]
            for causal in (True, False):
                before = fa.flash_attention.launches
                got = fa.flash_attention(*qkv, causal=causal)
                torch.cuda.synchronize()
                if fa.flash_attention.launches != before + 1:
                    raise AssertionError(f"D={D}: the kernel did not launch")
                want = fa.flash_attention_reference(*qkv, causal=causal)
                excess, err = flash_excess(got, want)
                if excess > 0:
                    raise AssertionError(
                        f"flash kernel off its plain version by {err} "
                        f"(L={L} D={D} {dtype} causal={causal})")
                worst = max(worst, err)
                cases += 1
    log(f"[flash] {cases} cases (f32 and bf16, L 128-2048, D 64, 96, 128 "
        f"and 256, causal and not): within tolerance, max |diff| {worst}")

    B, L, H, D = mb.BATCH, mb.SEQ, mb.CONFIG.n_heads, mb.CONFIG.head_dim
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = [torch.randn((B, L, H, D), generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3)]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = fa.flash_attention_reference(q, k, v)
    excess, err = flash_excess(got, want)
    if excess > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"flash kernel off its plain version by {err} "
                             f"at the model shape")
    ms = events_ms(lambda: fa.flash_attention(q, k, v), iters=50)
    plain_ms = events_ms(lambda: fa.flash_attention_reference(q, k, v),
                       iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = events_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=50)
    lib_err = float((sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
                     .float() - got.float()).abs().max())
    bound_ms, bound_by, nbytes, flops = flash_bound(B, L, H, D, 2)
    log(f"[flash] model shape [{B}, {L}, {H}, {D}] bf16 causal: max |diff| "
        f"{err}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP, {bound_by}), library (SDPA, timed "
        f"only) {library_ms:.4f} ms, kernel vs SDPA max |diff| {lib_err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_model_f32(torch, tt, fa, mb):
    """M1: full width, 2 layers, float32: card (through the kernel)
    against the CPU (through full_attention) on the same weights."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32")
    cfg = dataclasses.replace(mb.CONFIG, n_layers=2, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int64))
    t0 = time.perf_counter()
    want = tt.forward(params, tokens, cfg)
    cpu_s = time.perf_counter() - t0
    model = tt.Transformer(cfg, params=params, device="cuda")
    before = fa.flash_attention.launches
    with torch.inference_mode():
        got = model(tokens).cpu()
    if fa.flash_attention.launches != before + cfg.n_layers:
        raise AssertionError("the f32 forward did not go through the "
                             "flash kernel once per layer")
    # Both in float32; sums in other orders (cuBLAS and the kernel against
    # the CPU's BLAS and full_attention) over 1024- and 4096-long dots.
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"f32 logits on the card differ from "
                             f"device='cpu' by {err}")
    log(f"[model f32] 2 layers at full width, batch 2 x 256: logits "
        f"{tuple(got.shape)} within atol=rtol=1e-4 of device='cpu' "
        f"(max |diff| {err}; CPU forward {cpu_s:.1f} s)")
    del model
    return err


# M2's bf16 logits against a float32 forward of the same weights: the
# largest relative RMS error allowed.  bf16 rounds every activation (2**-9
# relative) through the 8 layers, which should leave about 1e-2; an
# attention output that is wrong (zero, not causal, or v itself) moves
# the logits by about their own size.
MODEL_BF16_REL_TOL = 0.05


def phase_model_bf16(torch, tt, fa, mb):
    """M2, the main path: the full config in bf16 at batch 8 x 1024, one
    sequence held against a float32 forward on the CPU."""
    cfg = mb.CONFIG
    B, S, L = mb.BATCH, mb.SEQ, cfg.n_layers
    model, tokens = mb.make("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    inputs = tokens[:, :-1]
    warmup, reps = 2, 10
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        for _ in range(warmup):
            logits = model(inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            logits = model(inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        loss = float(model.loss({"tokens": tokens}))
        finite = bool(torch.isfinite(logits).all())
    launches = fa.flash_attention.launches
    forwards = warmup + reps + 1
    if launches != L * forwards:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"in {forwards} forwards, expected {L} per "
                             "forward")
    if not finite or tuple(logits.shape) != (B, S, cfg.vocab_size):
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}, "
                             f"finite={finite}")
    # Sequence 0 through a float32 forward of the same (bf16-valued)
    # weights on the CPU, whose attention is full_attention, not the
    # kernel.
    params32 = _tree_to(model.params(), "cpu", torch.float32)
    t0 = time.perf_counter()
    want = tt.forward(params32, inputs[:1].cpu(),
                      dataclasses.replace(cfg, dtype=torch.float32))
    cpu_s = time.perf_counter() - t0
    got = logits[:1].float().cpu()
    rel = float((got - want).norm() / want.norm())
    max_diff = float((got - want).abs().max())
    del params32
    if not rel <= MODEL_BF16_REL_TOL:
        raise AssertionError(f"bf16 logits of sequence 0 are {rel} (relative "
                             f"RMS) off a float32 forward of the same "
                             f"weights, over {MODEL_BF16_REL_TOL}")
    # The final RMSNorm leaves every token's activations with unit RMS,
    # so against lm_head's normal(0.02) columns each logit is normal with
    # variance s2 = 0.02**2 * d_model, independent of the others: on
    # uniform targets the expected loss is ln V + s2 / 2 (0.205 above
    # ln 32,000 at d_model 1024), not ln V itself.
    s2 = 0.02 ** 2 * cfg.d_model
    expected = math.log(cfg.vocab_size) + s2 / 2
    if abs(loss - expected) > 0.1:
        raise AssertionError(f"evaluation loss {loss} is not within 0.1 of "
                             f"ln {cfg.vocab_size} + {s2 / 2} = {expected}")
    tok_s = B * S / (ms / 1e3)
    log(f"[model bf16] {n_params / 1e6:.1f}M params, {L} layers, "
        f"batch {B} x {S}: {ms:.3f} ms per forward, {tok_s:.0f} tokens/s; "
        f"logits finite; sequence 0 within {MODEL_BF16_REL_TOL} of a "
        f"float32 CPU forward (relative RMS {rel}, max |diff| {max_diff}; "
        f"CPU forward {cpu_s:.1f} s); loss {loss:.4f} (expected "
        f"{expected:.4f} = ln {cfg.vocab_size} + {s2 / 2:.4f}); "
        f"flash_attention launches={launches} in {forwards} forwards")
    return launches, ms, tok_s, rel


class RouteLog:
    """Records the router's decisions of every ``moe_ffn`` call while on:
    ``moe.route`` wrapped, each call's (choice, slot, capacity) kept."""

    def __init__(self, tm):
        self.tm, self.real, self.calls = tm, tm.route, []

    def __enter__(self):
        def route(xt, wr, cap, *mesh_and_rows):
            probs, choice, slot = self.real(xt, wr, cap, *mesh_and_rows)
            self.calls.append((choice.cpu(), slot.cpu(), cap))
            return probs, choice, slot
        self.tm.route = route
        return self

    def __exit__(self, *exc):
        self.tm.route = self.real


def phase_moe_forward(torch, tt, tm, fa, mb):
    """M3: the switch-MoE model (``MOE_CONFIG``: 8 experts at capacity
    1.25) in bf16 at batch 8 x 1024, one sequence held against a float32
    forward on the CPU."""
    cfg = mb.MOE_CONFIG
    B, S, L, E = mb.BATCH, mb.SEQ, cfg.n_layers, cfg.moe_experts
    model, tokens = mb.make("cuda", cfg=cfg)
    n_params = sum(p.numel() for p in model.parameters())
    inputs = tokens[:, :-1]
    warmup, reps = 2, 10
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        for _ in range(warmup):
            logits = model(inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            logits = model(inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        with RouteLog(tm) as card_routes:
            logits = model(inputs)
        finite = bool(torch.isfinite(logits).all())
    launches = fa.flash_attention.launches
    forwards = warmup + reps + 1
    if launches != L * forwards:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"in {forwards} MoE forwards, expected {L} per "
                             "forward")
    if not finite or tuple(logits.shape) != (B, S, cfg.vocab_size):
        raise AssertionError(f"bad MoE logits: shape "
                             f"{tuple(logits.shape)}, finite={finite}")
    if len(card_routes.calls) != L:
        raise AssertionError(f"{len(card_routes.calls)} router calls in one "
                             f"forward, expected {L}")
    dropped = [int((slot == E * cap).sum()) for _, slot, cap
               in card_routes.calls]
    drop_share = sum(dropped) / (L * B * S)
    # Sequence 0 through a float32 forward of the same (bf16-valued)
    # weights on the CPU.  Its tokens come first in the batch's token
    # order, so at the batch's capacity (1,280 slots an expert) none of
    # them is dropped; alone (1,024 tokens) it would get 160 slots an
    # expert.  The CPU run keeps the batch's capacity: the capacity
    # factor times B.
    params32 = _tree_to(model.params(), "cpu", torch.float32)
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32,
        moe_capacity_factor=cfg.moe_capacity_factor * B)
    t0 = time.perf_counter()
    with RouteLog(tm) as cpu_routes, torch.no_grad():
        want = tt.forward(params32, inputs[:1].cpu(), cfg32)
    cpu_s = time.perf_counter() - t0
    del params32
    if any(cap != cpu_routes.calls[0][2] for _, _, cap in card_routes.calls):
        raise AssertionError("the CPU run's capacity differs from the "
                             "card's")
    # Tokens of sequence 0 whose expert differs between the two runs, in
    # any layer: the router's float32 softmax sees bf16 activations on the
    # card and float32 ones here, so near-ties go either way.
    flips = torch.zeros(S, dtype=torch.bool)
    for (c_card, _, _), (c_cpu, _, _) in zip(card_routes.calls,
                                             cpu_routes.calls):
        flips |= c_card[:S] != c_cpu
    flip_pairs = sum(int((c[:S] != w).sum()) for (c, _, _), (w, _, _)
                     in zip(card_routes.calls, cpu_routes.calls))
    got = logits[:1].float().cpu()
    rel = float((got - want).norm() / want.norm())
    max_diff = float((got - want).abs().max())
    if not rel <= MODEL_BF16_REL_TOL:
        raise AssertionError(f"MoE bf16 logits of sequence 0 are {rel} "
                             f"(relative RMS) off a float32 forward of the "
                             f"same weights, over {MODEL_BF16_REL_TOL} "
                             f"({int(flips.sum())} of its {S} tokens routed "
                             f"differently in some layer)")
    tok_s = B * S / (ms / 1e3)
    log(f"[moe forward] {n_params / 1e6:.1f}M params, {L} layers, {E} "
        f"experts at capacity {cfg.moe_capacity_factor} "
        f"({card_routes.calls[0][2]} slots each), batch {B} x {S}: "
        f"{ms:.3f} ms per forward, {tok_s:.0f} tokens/s; logits finite; "
        f"dropped at capacity {drop_share:.4f} of tokens (per layer "
        f"{dropped}); sequence 0 within {MODEL_BF16_REL_TOL} of a float32 "
        f"CPU forward (relative RMS {rel}, max |diff| {max_diff}; "
        f"{int(flips.sum())} of {S} tokens routed to another expert in some "
        f"layer, {flip_pairs} (token, layer) pairs; CPU forward "
        f"{cpu_s:.1f} s); flash_attention launches={launches} in "
        f"{forwards} forwards")
    return {"launches": launches, "ms": ms, "tokens_per_s": tok_s,
            "rel": rel, "drop_share": drop_share,
            "flipped_tokens": int(flips.sum())}


# -- the backward kernel and the train step ----------------------------------

def flash_bwd_bound(B, L, H, D, esize, causal=True):
    """Least time for one backward call: q, k, v, o and dO read once,
    lse (float32) read once, dq, dk and dv written once, over HBM
    bandwidth, against the five products (s, dp, dv, dq, dk) over the
    (query, key) pairs the mask keeps, at the bf16 tensor-core rate."""
    nbytes = 8 * B * L * H * D * esize + B * H * L * 4
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    flops = 5 * 2 * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _bwd_case(torch, fa, q, k, v, do, causal):
    """The backward kernel and its plain version on the same inputs (the
    forward kernel's output and lse); the worst excess over FLASH_TOL,
    the largest |diff| over dq, dk and dv, whether all are finite, the
    inputs, and the route the kernel took (by its per-route count)."""
    o, lse = fa._launch(q, k, v, causal, 128, want_lse=True)
    before = fa.flash_attention_backward.launches
    routes = dict(fa.flash_attention_backward.route_launches)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    if fa.flash_attention_backward.launches != before + 1:
        raise AssertionError("the backward kernel did not launch")
    taken = [r for r, n in fa.flash_attention_backward.route_launches.items()
             if n != routes[r]]
    if len(taken) != 1:
        raise AssertionError(f"backward routes counted: {taken}")
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    excess, err = zip(*(flash_excess(g, w) for g, w in zip(got, want)))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return max(excess), max(err), finite, (q, k, v, o, lse, do), taken[0]


def _bwd_model_shape(torch, fa, mb, D, seed):
    """The backward at the model's batch, length and heads, bf16 causal,
    at head width D: checked against its plain version, then timed
    beside its plain version, SDPA's backward and its bound."""
    from ray_tpu_torch.tools.timing import events_ms
    dev = torch.device("cuda")
    B, L, H = mb.BATCH, mb.SEQ, mb.CONFIG.n_heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = [torch.randn((B, L, H, D), generator=gen, device=dev,
                               dtype=torch.float32).to(torch.bfloat16)
                   for _ in range(4)]
    excess, err, finite, args, route = _bwd_case(torch, fa, q, k, v, do, True)
    if excess > 0 or not finite:
        raise AssertionError(f"flash backward off its plain version by "
                             f"{err} at [{B}, {L}, {H}, {D}]")
    if route != "wgmma":
        raise AssertionError(f"[{B}, {L}, {H}, {D}] bf16 took the {route} "
                             "route")
    # Deterministic: no float atomics, so two calls are bit-equal.
    first = fa.flash_attention_backward(*args, True)
    again = fa.flash_attention_backward(*args, True)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"two backward calls at [{B}, {L}, {H}, {D}] "
                             "differ")
    ms = events_ms(lambda: fa.flash_attention_backward(*args, True),
                   iters=20)
    plain_ms = events_ms(
        lambda: fa.flash_attention_backward_reference(*args, True), iters=3,
        warmup=1)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = events_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound(B, L, H, D, 2)
    # The kernel's own products: s and dp twice (dK/dV and dQ blocks), and
    # dv, dk and dq each twice (bf16 hi and lo), over the kept pairs.
    run_flops = flops * 9 / 5
    log(f"[flash bwd] model shape [{B}, {L}, {H}, {D}] bf16 causal, route "
        f"{route}: max |diff| {err}, two calls bit-equal; kernel {ms:.4f} "
        f"ms ({flops / ms / 1e9:.1f} TFLOP/s on {flops / 1e9:.1f} GFLOP, "
        f"{run_flops / ms / 1e9:.1f} on the {run_flops / 1e9:.1f} GFLOP it "
        f"runs), plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.1f} MB, {bound_by}), library (SDPA's backward, "
        f"timed only) {library_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_flash_bwd(torch, fa, mb):
    """The flash backward kernel against its plain version on the card,
    with the route each case took, then checked for determinism and
    timed at the model's shape (and at D = 128) beside its bound and
    SDPA's backward."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    worst, cases = 0.0, 0

    def randn(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    routes = {}
    for dtype in (torch.float32, torch.bfloat16):
        for L in (128, 1024):
            for D in (64, 96, 128, 256):
                q, k, v, do = (randn((2, L, 4, D), dtype) for _ in range(4))
                for causal in (True, False):
                    excess, err, finite, _, route = _bwd_case(
                        torch, fa, q, k, v, do, causal)
                    if excess > 0 or not finite:
                        raise AssertionError(
                            f"flash backward off its plain version by {err} "
                            f"(L={L} D={D} {dtype} causal={causal})")
                    want = ("wgmma" if dtype == torch.bfloat16 and D <= 128
                            else "cuda_cores")
                    if route != want:
                        raise AssertionError(f"L={L} D={D} {dtype} took the "
                                             f"{route} route, not {want}")
                    key = f"{str(dtype).split('.')[-1]} D={D}"
                    routes[key] = route
                    worst = max(worst, err)
                    cases += 1
        qkv = randn((2, 256, 3, 4, 64), dtype)
        q, k, v = qkv.unbind(2)
        excess, err, finite, _, _ = _bwd_case(
            torch, fa, q, k, v, randn((2, 256, 4, 64), dtype), True)
        if excess > 0 or not finite:
            raise AssertionError(f"flash backward off its plain version by "
                                 f"{err} on strided q, k, v ({dtype})")
        worst = max(worst, err)
        cases += 1
    log(f"[flash bwd] {cases} cases (f32 and bf16, L 128 and 1024, D 64, "
        f"96, 128 and 256, causal and not, strided q/k/v): within "
        f"tolerance, max |diff| {worst}; routes {routes}")

    d64 = _bwd_model_shape(torch, fa, mb, mb.CONFIG.head_dim, 2)
    d128 = _bwd_model_shape(torch, fa, mb, 128, 3)
    d64["max_abs_err"] = max(worst, d64["max_abs_err"], d128["max_abs_err"])
    return d64, d128


def _tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    return tree.detach().to(device=device, dtype=dtype)


# T1's tolerances, card against CPU, both float32 (cuBLAS and the kernels
# against the CPU's BLAS and full_attention, sums in other orders):
#   * loss 1e-4 absolute, grad_norm 1e-4 relative;
#   * the first step's gradients: |diff| <= 1e-5 * (the tensor's largest
#     |gradient|) + 1e-4 |gradient|, the float32 error of sums over 512
#     tokens, in terms of the tensor's scale;
#   * parameters after each step: at most a share of 1e-4 of the
#     elements beyond atol = 1e-5 + rtol = 1e-4, and none beyond 1e-3.
#     Adam's first update g / (|g| + 1e-8) turns a float32 difference of a
#     gradient near 1e-8 into up to lr = 3e-4 of its parameter, so a few
#     elements of some 98M may move that far; a wrong gradient moves whole
#     tensors.
TRAIN_F32_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "grad_atol": 1e-5,
                 "grad_rtol": 1e-4, "atol": 1e-5, "rtol": 1e-4,
                 "share": 1e-4, "max": 1e-3}


def phase_train_f32(torch, tt, fa, mb, base, name="train f32", mesh=None):
    """T1 (``base`` = ``CONFIG``), T3-f32 (``MOE_CONFIG``) and P1 (``CONFIG``
    with ``mesh``, a mesh of one): full width, 2 layers, float32, remat:
    the gradients of the first step, then 3 train steps, on the card
    (through both flash kernels; on ``mesh`` if given) against the CPU
    (through full_attention, no mesh) from the same weights: both
    ``make_train_state`` from one CPU generator."""
    from ray_tpu_torch.models.optim import leaves
    tol = TRAIN_F32_TOL
    cfg = dataclasses.replace(base, n_layers=2, dtype=torch.float32,
                              remat=True)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 257)).astype(np.int64))
    runs = {}
    for role, dev, on in (("card", "cuda", mesh), ("host", "cpu", None)):
        state, tx = tt.make_train_state(torch.Generator().manual_seed(0), cfg,
                                        mesh=on, device=dev)
        runs[role] = (state, tt.make_train_step(cfg, tx, mesh=on), on, dev)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_backward.launches
    grads = {}
    for role, (state, _, on, dev) in runs.items():
        _, g = tt.loss_and_grads(state["params"], {"tokens": tokens.to(dev)},
                                 cfg, on)
        grads[role] = [t.cpu() for t in leaves(g)]
    grad_err = 0.0
    for g, w in zip(grads["card"], grads["host"]):
        diff = (g - w).abs()
        scale = float(w.abs().max())
        if (diff > tol["grad_atol"] * scale + tol["grad_rtol"] * w.abs()).any():
            raise AssertionError(f"first-step gradients differ by "
                                 f"{float(diff.max())} (scale {scale})")
        grad_err = max(grad_err, float(diff.max()) / max(scale, 1e-30))
    worst = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0, "share": 0.0,
             "grad": grad_err}
    cpu_s = 0.0
    for i in range(3):
        metrics = {}
        for role, (state, step, _, dev) in runs.items():
            t0 = time.perf_counter()
            _, m = step(state, {"tokens": tokens.to(dev)})
            metrics[role] = {k: float(v) for k, v in m.items()}
            if role == "host":
                cpu_s += time.perf_counter() - t0
        got, want = metrics["card"], metrics["host"]
        d_loss = abs(got["loss"] - want["loss"])
        d_norm = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        if d_loss > tol["loss"] or d_norm > tol["grad_norm"]:
            raise AssertionError(f"step {i}: loss {got['loss']} vs "
                                 f"{want['loss']}, grad_norm "
                                 f"{got['grad_norm']} vs {want['grad_norm']}")
        off = total = 0
        for g, w in zip(leaves(runs["card"][0]["params"]),
                        leaves(runs["host"][0]["params"])):
            diff = (g.detach().cpu() - w.detach()).abs()
            off += int((diff > tol["atol"] + tol["rtol"] *
                        w.detach().abs()).sum())
            total += diff.numel()
            worst["param"] = max(worst["param"], float(diff.max()))
        share = off / total
        if share > tol["share"] or worst["param"] > tol["max"]:
            raise AssertionError(f"step {i}: {off} of {total} parameters "
                                 f"beyond atol {tol['atol']}, largest "
                                 f"|diff| {worst['param']}")
        worst["loss"] = max(worst["loss"], d_loss)
        worst["grad_norm"] = max(worst["grad_norm"], d_norm)
        worst["share"] = max(worst["share"], share)
    # Four backward passes (the gradients, then 3 steps); remat runs each
    # layer's forward again in each.
    launches = (fa.flash_attention.launches - fwd,
                fa.flash_attention_backward.launches - bwd)
    if launches != (8 * cfg.n_layers, 4 * cfg.n_layers):
        raise AssertionError(f"{name} flash launches {launches}, expected "
                             f"{(8 * cfg.n_layers, 4 * cfg.n_layers)}")
    log(f"[{name}] 2 layers at full width, batch 2 x 256: first-step "
        f"gradients within tolerance (largest |diff| {grad_err} of the "
        f"tensor's scale); 3 steps: loss, grad_norm and parameters within "
        f"{tol} of device='cpu' (max |loss diff| {worst['loss']}, grad_norm "
        f"rel {worst['grad_norm']}, max |param diff| {worst['param']}, share "
        f"beyond atol {worst['share']}); flash launches forward "
        f"{launches[0]}, backward {launches[1]}; CPU steps {cpu_s:.1f} s")
    del runs
    return dict(worst, launches=launches)


def phase_train_bf16(torch, tt, fa, mb, cfg, flops, accounting, name,
                     mesh=None, n_micro=None):
    """T2 (``cfg`` = ``CONFIG``, ``flops(n_params)`` by ``train_flops``)
    and T3 (``MOE_CONFIG``, by ``moe_train_flops``), the training path:
    bench_model.py's batch, remat, 1 warm-up and 10 timed steps; P2
    (``CONFIG`` on ``mesh``) and P3 (the GPipe schedule on ``mesh`` with
    ``n_micro`` microbatches) the same.  The first loss is held to the
    init loss plus, with experts, ``moe_aux_coeff`` times the auxiliary
    of a forward before the first step.  Then one more step under the
    profiler counts the device operations a step launches."""
    from ray_tpu_torch.tools.timing import device_profile
    B, S = mb.BATCH, mb.SEQ
    torch.cuda.reset_peak_memory_stats()
    if n_micro is None:
        state, step, batch = mb.make_train("cuda", cfg=cfg, mesh=mesh)

        def loss_of(params, batch):
            return tt.loss_fn(params, batch, cfg, mesh)
    else:
        state, step, batch, loss_of = mb.make_pp_train(mesh, n_micro, "cuda",
                                                       cfg)
    micro = n_micro or 1
    n_params = mb.n_params(state["params"])
    step_flops = flops(n_params)
    aux0 = 0.0
    if cfg.moe_experts > 0:
        with torch.no_grad():
            aux0 = float(tt.forward_with_aux(
                state["params"], batch["tokens"][:, :-1], cfg)[1])
    reps = mb.TRAIN_REPS
    fa.flash_attention.launches = 0
    fa.flash_attention_backward.launches = 0
    for route in fa.flash_attention_backward.route_launches:
        fa.flash_attention_backward.route_launches[route] = 0
    _, m = step(state, batch)
    history = [m]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, m = step(state, batch)
        history.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    launches = (fa.flash_attention.launches,
                fa.flash_attention_backward.launches)
    routes = dict(fa.flash_attention_backward.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = reps + 1
    per_step = (2 * cfg.n_layers * micro, cfg.n_layers * micro)
    if launches != (per_step[0] * steps, per_step[1] * steps):
        raise AssertionError(f"flash launches {launches} in {steps} steps, "
                             f"expected {per_step[0]} forward and "
                             f"{per_step[1]} backward per step")
    if routes["wgmma"] != launches[1]:
        raise AssertionError(f"backward routes in {name}: {routes}")
    losses = [float(h["loss"]) for h in history]
    norms = [float(h["grad_norm"]) for h in history]
    with torch.no_grad():
        final = float(loss_of(state["params"], batch))
    expected = (math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2 +
                cfg.moe_aux_coeff * aux0)
    if abs(losses[0] - expected) > 0.1:
        raise AssertionError(f"first loss {losses[0]} is not within 0.1 of "
                             f"the init loss {expected}")
    if not all(math.isfinite(x) for x in losses + norms + [final]):
        raise AssertionError(f"non-finite loss or grad_norm: {losses}, "
                             f"{norms}, {final}")
    if not final < losses[0]:
        raise AssertionError(f"loss after {steps} steps {final} is not below "
                             f"the first {losses[0]}")
    tok_s = B * S / step_s
    tflops = step_flops / step_s / 1e12
    log(f"[{name}] {n_params / 1e6:.1f}M params, {cfg.n_layers} layers, "
        f"{cfg.moe_experts} experts, remat, batch {B} x {S}: "
        f"{step_s * 1e3:.3f} ms per step, "
        f"{tok_s:.0f} tokens/s, {tflops:.1f} TFLOP/s "
        f"({step_flops / 1e12:.2f} TFLOP a step by {accounting}); peak "
        f"memory {peak_gb:.2f} GB; loss {losses[0]:.4f} first (init "
        f"{expected:.4f}, aux {aux0:.4f}), {losses[-1]:.4f} at the last "
        f"step, {final:.4f} "
        f"after {steps}; grad_norm {norms[0]:.4f} .. {norms[-1]:.4f}; flash "
        f"launches forward {launches[0]}, backward {launches[1]} in {steps} "
        f"steps (routes {routes})")
    device_ms, ops = device_profile(lambda: step(state, batch))
    log(f"[{name}] {ops:.0f} device operations launched a step, "
        f"{device_ms:.3f} ms of device time (torch.profiler, one step)")
    return {"step_ms": step_s * 1e3, "tokens_per_s": tok_s,
            "tflops": tflops, "peak_gb": peak_gb, "loss_first": losses[0],
            "loss_final": final, "launches": launches,
            "ops_per_step": ops}


def phase_train_dp(cf, fa):
    """L1: ``profile_air.train_dp`` on the card (its module docstring);
    its checks run inside.  The counts are set to 0 before it; its
    launches are those of the gang's creation and of the trainer's run
    (the whole-batch reference it is held to runs after them)."""
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention_backward.launches = 0
    out = pair.train_dp("cuda")
    check_no_threads("L1")
    gang, run = out["gang"], out["launches"]
    for part in (gang, run):
        if part["class_fill"] != part["batched_ticks"]:
            raise AssertionError(f"L1: class_fill launched "
                                 f"{part['class_fill']} times for "
                                 f"{part['batched_ticks']} batched ticks")
    if gang["bundle_solves_on_device"] != 1:
        raise AssertionError(f"L1: {gang['bundle_solves_on_device']} "
                             "bundle solves on the card for one group")
    per = out["launches_per_step"]
    log(f"[L1] Trainer(torch, 2 workers x GPU 0.5) on the card, "
        f"{out['steps']} steps of T2's model and batch (a rank 4 rows): "
        f"step p50 {out['step_ms_p50']:.1f} ms (timed steps "
        f"{', '.join(f'{x:.1f}' for x in out['step_ms'])}), allreduce of "
        f"{out['grad_bytes'] / 1e6:.1f} MB a rank p50 "
        f"{out['allreduce_ms_p50']:.1f} ms, share "
        f"{out['allreduce_share_p50']:.3f}; {out['tokens_per_s']:.0f} "
        f"tokens/s; peak memory {out['peak_gb']:.2f} GB; averaged "
        f"gradient of step 1 within {out['grad_rel_err']:.2e} of the "
        f"whole batch's norm (tolerance {pair.GRAD_RTOL}); losses "
        f"{', '.join(f'{x:.5f}' for x in out['losses'])} against "
        f"{', '.join(f'{x:.5f}' for x in out['ref_losses'])} (max |diff| "
        f"{out['loss_err']:.2e}, tolerance {pair.LOSS_ATOL}); ranks' "
        f"parameters bit-equal after every step; flash launches a step "
        f"forward {per['flash_forward']:.0f}, backward "
        f"{per['flash_backward']:.0f}; the gang's creation: "
        f"{gang['class_fill']} class_fill launches (= batched ticks), "
        f"{gang['bundle_solves_on_device']} bundle solve on the card, "
        f"{out['start_s'] * 1e3:.1f} ms; get_gpu_ids in a worker "
        f"{out['gpu_ids']}")
    return out


def phase_data_ml(cf, fa):
    """L2: ``profile_air.data_ml`` on the card (its module docstring);
    its checks run inside.  The counts are set to 0 before it; its
    launches are those of the fit and of the predict (the direct
    forward it is held to runs after them)."""
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    cf.class_fill.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention_backward.launches = 0
    out = pair.data_ml("cuda")
    check_no_threads("L2")
    fit, pred = out["launches_fit"], out["launches_predict"]
    for part in (fit, pred):
        if part["class_fill"] != part["batched_ticks"]:
            raise AssertionError(f"L2: class_fill launched "
                                 f"{part['class_fill']} times for "
                                 f"{part['batched_ticks']} batched ticks")
    log(f"[L2] {out['rows']} sequences of 1,025 tokens in {out['blocks']} "
        f"blocks: DataParallelTrainer.fit {out['steps']} steps in "
        f"{out['fit_s']:.2f} s (losses "
        f"{', '.join(f'{x:.5f}' for x in out['losses'])}), checkpoint of "
        f"host forms; BatchPredictor.predict(batch_size=8) "
        f"{out['predict_s'] * 1e3:.1f} ms, {out['rows_per_s']:.1f} rows/s; "
        f"log-probabilities within {out['pred_max_abs_err']:.2e} of forward "
        f"called directly (tolerance {pair.PRED_ATOL}), "
        f"{out['argmax_mismatched']} argmax differ; flash launches fit "
        f"{fit['flash_forward']} forward, {fit['flash_backward']} backward, "
        f"predict {pred['flash_forward']} forward; class_fill launches fit "
        f"{fit['class_fill']}, predict {pred['class_fill']} (= batched "
        f"ticks)")
    return out


def _check_solve_launches(name, launches):
    """Every ``class_fill`` launch of the phase is a batched tick's or a
    pack solve's."""
    want = launches["batched_ticks"] + launches["pack_solves"]
    if launches["class_fill"] != want:
        raise AssertionError(f"{name}: class_fill launched "
                             f"{launches['class_fill']} times for "
                             f"{launches['batched_ticks']} batched ticks and "
                             f"{launches['pack_solves']} pack solves")


def _zero(cf, fa):
    cf.class_fill.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention_backward.launches = 0


def phase_serve_model(cf, fa):
    """S1: ``profile_serve.serve_model`` on the card (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it; its launches are the deployment's and the requests' (the direct
    forward it is held to runs after them)."""
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools import profile_serve as pserve
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = pserve.serve_model("cuda")
    check_no_threads("S1")
    n = out["launches"]
    _check_solve_launches("S1", n)
    log(f"[S1] serve: 2 replicas of T2's model at num_gpus 0.5 "
        f"({out['replicas_on_head']} on the head), placed by the pack "
        f"solve on the card ({out['kernel_placements']} kernel "
        f"placements), weights as device objects on "
        f"{out['weights_device']} ({out['weights_host_bytes']} bytes to the "
        f"host), deployed in {out['deploy_s']:.2f} s; {out['requests']} "
        f"requests of 1,024 tokens from {out['clients']} clients (half "
        f"handle, half HTTP): {out['requests_per_s']:.1f} requests/s, "
        f"latency p50 {out['latency_p50_ms']:.1f} ms, p99 "
        f"{out['latency_p99_ms']:.1f} ms; {out['batches']} batches, mean "
        f"fill {out['mean_batch_fill']:.3f}; replies within "
        f"{out['max_abs_err']:.2e} of forward on the same batches "
        f"(tolerance {pair.PRED_ATOL}), {out['argmax_mismatched']} argmax "
        f"differ; launches: class_fill {n['class_fill']} (= "
        f"{n['batched_ticks']} batched ticks + {n['pack_solves']} pack "
        f"solves), flash forward {n['flash_forward']}")
    return out


def phase_autoscale(cf, fa):
    """S2: ``profile_serve.autoscale`` on the card (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it."""
    from ray_tpu_torch.tools import profile_serve as pserve
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = pserve.autoscale("cuda")
    check_no_threads("S2")
    n = out["launches"]
    _check_solve_launches("S2", n)
    st = out["autoscaler_stats"]
    step = out["step_to_new_replica_ms"]
    log(f"[S2] serve on R3's {out['raylets']} raylets (placement auto): "
        f"{out['requests']} requests from {out['clients']} clients in "
        f"{out['load_s']:.2f} s, {out['requests_per_s']:.1f} requests/s, "
        f"none lost or misrouted; peak {out['peak_replicas']} replicas, "
        f"step to a new replica's first reply "
        f"{'none' if step is None else f'{step:.1f} ms'}; "
        f"{st['scale_ups']} scale-ups, {st['scale_downs']} scale-downs (to "
        f"2 in {out['load_end_to_scale_down_s']:.2f} s after the load), "
        f"kernel placements {st['kernel_placements']} "
        f"({out['deploy_kernel_placements']} at the deploy), kernel errors "
        f"{st['kernel_errors']}; launches: class_fill {n['class_fill']} (= "
        f"{n['batched_ticks']} batched ticks + {n['pack_solves']} pack "
        f"solves)")
    return out


def phase_tune_model(cf, fa):
    """N1: ``profile_serve.tune_model`` on the card (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it; its launches are the sweep's (the direct runs it is held to come
    after)."""
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools import profile_serve as pserve
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = pserve.tune_model("cuda")
    check_no_threads("N1")
    n = out["launches"]
    _check_solve_launches("N1", n)
    log(f"[N1] Tuner over DataParallelTrainer, lr grid "
        f"{list(out['losses'])}: {out['trials']} trials of {out['steps']} "
        f"steps at once, sweep {out['sweep_s']:.2f} s, trials' loops "
        f"{', '.join(f'{v:.2f}' for v in out['trial_loop_s'].values())} s; "
        f"losses {out['losses']} against the direct runs' "
        f"{out['direct_losses']} (max |diff| {out['loss_err']:.2e}, "
        f"tolerance {pair.LOSS_ATOL}); best_config {out['best_config']}; "
        f"launches: flash forward {n['flash_forward']}, backward "
        f"{n['flash_backward']}, class_fill {n['class_fill']} (= "
        f"{n['batched_ticks']} batched ticks)")
    return out


def phase_process_workers(cf, fa, m2_ms):
    """X1: ``profile_process.process_workers`` on the card (its module
    docstring); its checks run inside, the launch checks too.  The
    counts are set to 0 before it; its ``class_fill`` launches are the
    two bursts' (the driver's), its flash launches the actor's forwards
    (each counted in the worker process that ran it)."""
    from ray_tpu_torch.tools import profile_process as pproc
    _zero(cf, fa)
    out = pproc.process_workers("cuda")
    p, t, m, a = out["process"], out["threads"], out["model"], out["api"]
    reg = out["spawn_to_registered_ms"]
    log(f"[X1] process workers (4 CPUs, 1 GPU): a burst of {p['tasks']} "
        f"tasks in {p['classes']} classes on {p['worker_pids']} worker "
        f"processes: {p['tasks_per_s']:.0f} tasks/s, submit to sealed p50 "
        f"{p['latency_p50_ms']:.1f} ms, p99 {p['latency_p99_ms']:.1f} ms, "
        f"{p['launches']} class_fill launches (= {p['batched_ticks']} "
        f"batched ticks); the same burst on thread workers "
        f"{t['tasks_per_s']:.0f} tasks/s, p50 {t['latency_p50_ms']:.1f} ms, "
        f"p99 {t['latency_p99_ms']:.1f} ms, {t['launches']} launches; "
        f"{out['children']} children, spawn to registered "
        f"{', '.join(f'{x:.0f}' for x in reg)} ms.  An actor of num_gpus "
        f"0.5 built T2's model from its weights as one object of host "
        f"forms in {m['start_s']:.2f} s to its first reply; "
        f"{m['forwards']} forwards at [{m['batch']}, {m['seq']}]: "
        f"{m['call_ms_p50']:.1f} ms a call (p50; "
        f"{m['logit_bytes'] / 1e6:.1f} MB of logits back each), "
        f"{m['child_ms_p50']:.2f} ms a forward in the child, the driver's "
        f"{m['driver_ms_p50']:.2f} ms, M2's {m2_ms:.2f} ms; within "
        f"{m['max_rel_rms']:.2e} relative RMS of the driver's forward "
        f"(tolerance {pproc.FORWARD_REL_TOL}); {m['flash_launches']} flash "
        f"launches in the child.  In workers: nested remote, put/get/wait, "
        f"an actor from a task, {a['nested_error']} as its own type, "
        f"runtime_env var seen, no JAX module, a print on the log channel, "
        f"OwnerDiedError {a['owner_died_ms']:.0f} ms after the owner's "
        f"kill; no child or thread left")
    return out


def phase_process_train(cf, fa, l1):
    """X2: ``profile_process.train_pg`` on the card (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it; its flash launches are counted in the two rank processes."""
    from ray_tpu_torch.tools import profile_air as pair
    from ray_tpu_torch.tools import profile_process as pproc
    _zero(cf, fa)
    out = pproc.train_pg("cuda")
    log(f"[X2] Trainer(torch) over {out['world']} worker processes of GPU "
        f"0.5 joined by a gloo process group (all_reduce on the card's "
        f"buffers), T2's model and batch: step p50 {out['step_ms_p50']:.1f} ms (timed steps "
        f"{', '.join(f'{x:.1f}' for x in out['step_ms'])}), allreduce p50 "
        f"{out['allreduce_ms_p50']:.1f} ms, share "
        f"{out['allreduce_share_p50']:.3f}; L1 on thread workers: "
        f"{l1['step_ms_p50']:.1f} ms, share "
        f"{l1['allreduce_share_p50']:.3f}; {out['tokens_per_s']:.0f} "
        f"tokens/s; gang start {out['start_s']:.2f} s; averaged gradient "
        f"of step 1 within {out['grad_rel_err']:.2e} of the whole batch's "
        f"(tolerance {pair.GRAD_RTOL}), losses within {out['loss_err']:.2e} "
        f"(tolerance {pair.LOSS_ATOL}); flash launches a step "
        f"{out['flash_per_step']} in the ranks' processes")
    return out


def _check_tick_launches(name, launches):
    """Every ``class_fill`` launch of the phase is a batched tick's."""
    if launches["class_fill"] != launches["batched_ticks"]:
        raise AssertionError(f"{name}: class_fill launched "
                             f"{launches['class_fill']} times for "
                             f"{launches['batched_ticks']} batched ticks")


def phase_ppo(cf, fa):
    """Q1: ``profile_rllib.ppo`` on the card (its module docstring); its
    checks run inside.  The counts are set to 0 before it."""
    from ray_tpu_torch.tools import profile_rllib as prl
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = prl.ppo("cuda")
    check_no_threads("Q1")
    n = out["launches"]
    _check_tick_launches("Q1", n)
    held = out["held"]
    log(f"[Q1] PPO at DEFAULT_CONFIG (2 workers x 256 steps, 6 epochs of "
        f"128, hidden (64, 64)), learner and workers on the card: "
        f"{', '.join(f'{s:.3f}' for s in out['s_per_iter'])} s an "
        f"iteration, {', '.join(f'{v:.0f}' for v in out['env_steps_per_s'])} "
        f"env steps/s (the holds' {out['hold_s']:.3f} s taken out); "
        f"{out['sgd_steps_per_iter']} SGD steps an iteration, "
        f"{out['sgd_step_ms_mean']:.3f} ms each (p50 "
        f"{out['sgd_step_ms_p50']:.3f}), {out['sgd_step_device_ops']:.0f} "
        f"device operations and {out['sgd_step_device_ms']:.4f} device ms a "
        f"step; each iteration's first step against the CPU: loss within "
        f"{max(h['loss_rel_err'] for h in held):.2e} (tolerance "
        f"{prl.LOSS_RTOL}), weights within "
        f"{max(h['weight_err'] for h in held):.2e} (tolerance "
        f"{prl.WEIGHT_ATOL}); mean episode reward "
        f"{[round(r, 2) for r in out['episode_reward_mean']]}; launches: "
        f"class_fill {out['creation_launches']['class_fill']} for the "
        f"workers' creation, {n['class_fill']} in the phase (= "
        f"{n['batched_ticks']} batched ticks)")
    return out


def phase_dqn_impala(cf, fa):
    """Q2: ``profile_rllib.dqn_impala`` on the card (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it."""
    from ray_tpu_torch.tools import profile_rllib as prl
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = prl.dqn_impala("cuda")
    check_no_threads("Q2")
    n = out["launches"]
    _check_tick_launches("Q2", n)
    d, i = out["dqn"], out["impala"]
    log(f"[Q2] DQN at DEFAULT_CONFIG: {d['iterations']} train() to the "
        f"first that learns ({d['timesteps_total']} transitions), "
        f"{', '.join(f'{s:.3f}' for s in d['s_per_iter'])} s each; "
        f"{d['sgd_steps']} TD updates of {d['td_step_ms_mean']:.3f} ms, the "
        f"first within {d['held'][0]['loss_rel_err']:.2e} of the CPU's loss "
        f"and {d['held'][0]['weight_err']:.2e} of its weights.  IMPALA at "
        f"DEFAULT_CONFIG: one train() of {i['updates']} fragments in "
        f"{i['s_per_iter']:.3f} s, {i['env_steps_per_s']:.0f} env steps/s, "
        f"{i['update_ms_mean']:.3f} ms a V-trace update, the first within "
        f"{i['held'][0]['loss_rel_err']:.2e} of the CPU's loss and "
        f"{i['held'][0]['weight_err']:.2e} of its weights; compute_vtrace "
        f"on the card at T {i['vtrace_T']} within {i['vtrace_rel_err']:.2e} "
        f"of the numpy oracle (tolerance 1e-5); launches: class_fill "
        f"{n['class_fill']} (= {n['batched_ticks']} batched ticks)")
    return out


def phase_workflow_pool(cf, fa):
    """W1: ``profile_rllib.workflow_pool`` on the card cluster (its module
    docstring); its checks run inside.  The counts are set to 0 before
    it."""
    from ray_tpu_torch.tools import profile_rllib as prl
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    _zero(cf, fa)
    out = prl.workflow_pool("cuda")
    check_no_threads("W1")
    n = out["launches"]
    _check_tick_launches("W1", n)
    log(f"[W1] workflow: {out['fan_in']} steps fanned in and chained in "
        f"{out['fan_in_s']:.3f} s, a durable counter over "
        f"{out['counter_calls']} calls and a reload in "
        f"{out['counter_s']:.3f} s, a resume past a finished step in "
        f"{out['resume_s']:.3f} s; Pool({out['pool']}).map over "
        f"{out['items']} items in {out['pool_map_s']:.3f} s; every output "
        f"equal to the plain result; launches: class_fill {n['class_fill']} "
        f"(= {n['batched_ticks']} batched ticks)")
    return out


# Ring attention over a one-rank sp group against full_attention on the
# card: float32 within 1e-5; bf16 within 2**-6 (one bf16 ulp at the
# largest outputs, in [2, 4)): the ring rounds its unnormalised
# probabilities to bf16 before the product with v and divides after it,
# full_attention rounds the normalised ones.
RING_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}


def start_world(torch):
    """A NCCL world of one (a ``file://`` store in a temporary directory)
    and the mesh of one on it (``build_mesh`` with no device: the card);
    one all-reduce on the world shows NCCL starts on this machine."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    store = tempfile.mkdtemp(prefix="chip_smoke_world_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    mesh = build_mesh(MeshConfig())
    x = torch.full((8,), 3.0, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    if not bool((x == 3.0).all()):
        raise AssertionError(f"NCCL all-reduce over one rank gave {x}")
    log(f"[mesh] NCCL world of 1 ({dist.get_backend()}), mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{mesh.device_type}; all-reduce checked")
    return mesh, store


def phase_ring(torch, mb, mesh):
    """P1's attention: ``ring_attention`` over the mesh's one-rank sp
    group at the model's shape against ``full_attention``, on the card."""
    from ray_tpu_torch.ops.ring_attention import full_attention, ring_attention
    B, L, H, D = mb.BATCH, mb.SEQ, mb.CONFIG.n_heads, mb.CONFIG.head_dim
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = [torch.randn((B, L, H, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(3)]
        got = ring_attention(q, k, v, axis_name="sp", mesh=mesh)
        want = full_attention(q, k, v)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[-1]
        tol = RING_TOL[key]
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(got).all() or bool(
                (diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"ring attention {key} off full_attention "
                                 f"by {float(diff.max())}")
        errs[key] = float(diff.max())
    log(f"[mesh ring] ring_attention over a one-rank sp group at [{B}, {L}, "
        f"{H}, {D}] against full_attention: max |diff| {errs} (tolerance "
        f"{RING_TOL})")
    return errs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: run from a checkout that holds ray_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.tools.timing import card
    smi = card()
    log(f"[setup] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    from ray_tpu_torch.models import bench as mb
    from ray_tpu_torch.models import moe as tm
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import class_fill as cf
    for name in ("ops.ring_attention", "parallel.collectives",
                 "parallel.mesh", "parallel.pipeline", "_private.cluster",
                 "_private.convert", "_private.raylet",
                 "_private.core_worker", "_private.worker",
                 "remote_function", "tools.profile_tasks",
                 "tools.profile_objects", "_private.object_manager",
                 "_private.local_object_manager",
                 "autoscaler.resource_demand_scheduler",
                 "gcs.placement_group_manager", "util.placement_group",
                 "autoscaler.load_metrics", "autoscaler.node_provider",
                 "autoscaler.autoscaler", "autoscaler.monitor",
                 "autoscaler.sdk", "tools.profile_groups", "gcs.server",
                 "gcs.task_events", "gcs.job_graph", "tools.profile_gcs",
                 "actor", "gcs.actor_manager",
                 "_private.direct_actor_submitter",
                 "tools.profile_actors", "util.collective",
                 "util.collective.collective", "util.actor_pool",
                 "util.queue", "util.iter", "util.metrics",
                 "util.check_serialize", "util.rpdb",
                 "tools.profile_device", "train", "train.backend",
                 "train.session", "train.worker_group", "train.checkpoint",
                 "train.callbacks", "train.trainer", "data", "data.block",
                 "data.dataset", "data.read_api", "data.dataset_pipeline",
                 "data.impl.compute", "data.impl.push_shuffle", "ml",
                 "ml.checkpoint", "ml.preprocessor", "ml.predictor",
                 "ml.trainer", "ml.tuner", "tools.profile_air", "serve",
                 "serve.api", "serve.batching", "serve.controller",
                 "serve.handle", "serve.http_proxy", "serve.pipeline",
                 "serve.replica", "serve.router", "tune", "tune.analysis",
                 "tune.sample", "tune.schedulers", "tune.suggest",
                 "tune.trainable", "tune.trial", "tune.trial_runner",
                 "tune.tune", "tools.profile_serve", "rllib", "rllib.env",
                 "rllib.policy", "rllib.replay_buffer",
                 "rllib.rollout_worker", "rllib.ppo", "rllib.dqn",
                 "rllib.impala", "workflow", "workflow.storage",
                 "workflow.execution", "workflow.event_listener",
                 "util.multiprocessing", "tools.profile_rllib", "rpc",
                 "rpc.wire", "rpc.verbs", "rpc.client", "rpc.server",
                 "rpc.chunked", "_private.worker_pool",
                 "_private.worker_main", "_private.client_runtime",
                 "_private.client_service", "_private.runtime_env",
                 "_private.log_monitor", "tools.profile_process"):
        importlib.import_module(f"ray_tpu_torch.{name}")
    from ray_tpu_torch.scheduler import policy as tpolicy
    from ray_tpu_torch.scheduler import bench as sb
    from ray_tpu_torch.scheduler import bundle_packing as tbp
    from ray_tpu_torch.scheduler import resources as tres
    from ray_tpu_torch.scheduler import torch_backend as tb
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "ray_tpu" \
                or mod.startswith("ray_tpu."):
            raise AssertionError(f"{mod} imported")

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    sources = ("class_fill.cu", "flash_attention.cu", "flash_attention_bwd.cu")
    _build.build(*sources)
    for source in sources:
        _build.load(source)
    log(f"[setup] {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    k = phase_kernel(torch, cf, sb)
    launches_a, ms_a = phase_stream(torch, cf, tb, sb)
    launches_b, ms_b = phase_runtime(torch, cf, tb, tres, tpolicy, sb)
    f = phase_flash(torch, fa, mb)
    err_f32 = phase_model_f32(torch, tt, fa, mb)
    launches_m, ms_fwd, tok_s, rel_bf16 = phase_model_bf16(torch, tt, fa, mb)
    m3 = phase_moe_forward(torch, tt, tm, fa, mb)
    bundle_ms = phase_bundles(tb, tbp, tres, sb)
    sinkhorn_ms = phase_sinkhorn(tb, sb)
    r1 = phase_raylet(torch, cf, sb)
    r2 = phase_autoscaler(torch, cf, sb)
    r3 = phase_cluster(torch, cf)
    c1 = phase_tasks_single(cf)
    c2 = phase_tasks_cluster(cf)
    objects = phase_objects(cf)
    g1 = phase_groups(torch, cf, tb, sb)
    a1 = phase_autoscaler_loop(cf)
    h1 = phase_heartbeat(cf)
    h2 = phase_gcs_restart(cf)
    k1 = phase_actors(cf)
    k2 = phase_actor_faults(cf)
    d1 = phase_device_objects(cf)
    u1 = phase_util(cf)
    fb, fb128 = phase_flash_bwd(torch, fa, mb)
    t1 = phase_train_f32(torch, tt, fa, mb, mb.CONFIG, "train f32")
    t3f = phase_train_f32(torch, tt, fa, mb, mb.MOE_CONFIG, "moe train f32")
    t2 = phase_train_bf16(torch, tt, fa, mb, mb.CONFIG, mb.train_flops,
                          "train_flops", "train bf16")
    t3 = phase_train_bf16(torch, tt, fa, mb, mb.MOE_CONFIG,
                          lambda _: mb.moe_train_flops(), "moe_train_flops",
                          "moe train bf16")
    l1 = phase_train_dp(cf, fa)
    l2 = phase_data_ml(cf, fa)
    air_class_fill = (l1["gang"]["class_fill"] + l1["launches"]["class_fill"]
                      + l2["launches_fit"]["class_fill"] +
                      l2["launches_predict"]["class_fill"])
    air_fwd = (l1["launches"]["flash_forward"] +
               l2["launches_fit"]["flash_forward"] +
               l2["launches_predict"]["flash_forward"])
    air_bwd = (l1["launches"]["flash_backward"] +
               l2["launches_fit"]["flash_backward"])
    if min(air_class_fill, air_fwd, air_bwd) < 1:
        raise AssertionError(f"L1 and L2 launched class_fill "
                             f"{air_class_fill}, the flash forward {air_fwd} "
                             f"and its backward {air_bwd} times")
    s1 = phase_serve_model(cf, fa)
    s2 = phase_autoscale(cf, fa)
    n1 = phase_tune_model(cf, fa)
    served = [s1["launches"], s2["launches"], n1["launches"]]
    serve_class_fill = sum(x["class_fill"] for x in served)
    serve_fwd = sum(x["flash_forward"] for x in served)
    serve_bwd = sum(x["flash_backward"] for x in served)
    if min(serve_class_fill, serve_fwd, serve_bwd) < 1:
        raise AssertionError(f"S1, S2 and N1 launched class_fill "
                             f"{serve_class_fill}, the flash forward "
                             f"{serve_fwd} and its backward {serve_bwd} "
                             "times")
    q1 = phase_ppo(cf, fa)
    q2 = phase_dqn_impala(cf, fa)
    w1 = phase_workflow_pool(cf, fa)
    library_class_fill = (q1["launches"]["class_fill"] +
                          q2["launches"]["class_fill"] +
                          w1["launches"]["class_fill"])
    if library_class_fill < 1:
        raise AssertionError("Q1, Q2 and W1 launched class_fill "
                             f"{library_class_fill} times")
    x1 = phase_process_workers(cf, fa, ms_fwd)
    x2 = phase_process_train(cf, fa, l1)
    process_class_fill = (x1["process"]["launches"] +
                          x1["threads"]["launches"] + x2["class_fill"])
    process_fwd = x1["model"]["flash_launches"] + x2["flash_forward"]
    process_bwd = x2["flash_backward"]
    if min(x1["process"]["launches"], process_fwd, process_bwd) < 1:
        raise AssertionError(f"X1 and X2 launched class_fill "
                             f"{x1['process']['launches']} times in the "
                             f"process burst, the flash forward "
                             f"{process_fwd} and its backward {process_bwd} "
                             "times")
    # P1-P3: the same model on a mesh of one (the machine has one card, and
    # NCCL puts no two ranks on one device: no multi-rank number exists).
    import shutil

    import torch.distributed as dist
    the_mesh, store = start_world(torch)
    try:
        p1 = phase_train_f32(torch, tt, fa, mb, mb.CONFIG, "mesh train f32",
                             mesh=the_mesh)
        ring_err = phase_ring(torch, mb, the_mesh)
        p2 = phase_train_bf16(torch, tt, fa, mb, mb.CONFIG, mb.train_flops,
                              "train_flops", "mesh train bf16",
                              mesh=the_mesh)
        p3 = phase_train_bf16(torch, tt, fa, mb, mb.CONFIG, mb.train_flops,
                              "train_flops", "pp train bf16", mesh=the_mesh,
                              n_micro=PP_MICRO)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if abs(p2["loss_first"] - t2["loss_first"]) > 1e-3:
        raise AssertionError(f"P2's first loss {p2['loss_first']} is not "
                             f"within 1e-3 of T2's {t2['loss_first']}")
    if abs(p3["loss_first"] - p2["loss_first"]) > 1e-2:
        raise AssertionError(f"P3's first loss {p3['loss_first']} is not "
                             f"within 1e-2 of P2's {p2['loss_first']}")
    log(f"[mesh] per step, batch {mb.BATCH} x {mb.SEQ}: T2 (no mesh) "
        f"{t2['step_ms']:.3f} ms, {t2['tokens_per_s']:.0f} tokens/s, "
        f"{t2['ops_per_step']:.0f} device operations; P2 (mesh of one) "
        f"{p2['step_ms']:.3f} ms, {p2['tokens_per_s']:.0f} tokens/s, "
        f"{p2['ops_per_step']:.0f} operations "
        f"({p2['ops_per_step'] - t2['ops_per_step']:+.0f}); P3 (GPipe, pp 1, "
        f"{PP_MICRO} microbatches) {p3['step_ms']:.3f} ms, "
        f"{p3['tokens_per_s']:.0f} tokens/s, {p3['ops_per_step']:.0f} "
        f"operations; first losses T2 {t2['loss_first']:.6f}, P2 "
        f"{p2['loss_first']:.6f}, P3 {p3['loss_first']:.6f}")

    kernels = [{
        "name": "class_fill",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/class_fill.cu",
        "replaces": "ray_tpu/scheduler/jax_backend.py:374",
        "launches": (launches_a + launches_b + r1["launches"] +
                     r2["launches"] + r3["launches"] + c1["launches"] +
                     c2["launches"] +
                     sum(o["launches"] for o in objects.values()) +
                     g1["launches"] + a1["launches"] + h1["launches"] +
                     h2["launches"] + k1["launches"] + k2["launches"] +
                     d1["launches"] + u1["launches"] + air_class_fill +
                     serve_class_fill + library_class_fill +
                     process_class_fill),
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_us": k["bound_ms"] * 1e3,
        "bound_by": k["bound_by"],
        "library_ms": None,
        "g1_widest": g1["fill_g1"],
        "wide_global_route": g1["fill_wide"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:79",
        "launches": (launches_m + t2["launches"][0] + m3["launches"] +
                     t3["launches"][0] + p1["launches"][0] +
                     p2["launches"][0] + p3["launches"][0] + air_fwd +
                     serve_fwd + process_fwd),
        "max_abs_err": f["max_abs_err"],
        "ms": f["ms"],
        "plain_ms": f["plain_ms"],
        "bound_ms": f["bound_ms"],
        "bound_us": f["bound_ms"] * 1e3,
        "bound_by": f["bound_by"],
        "library_ms": f["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none: JAX differentiates full_attention "
                    "(ray_tpu/ops/flash_attention.py:101-103)",
        "design": "wgmma+tma, one launch for dK/dV and dQ after delta's",
        "launches": (t2["launches"][1] + t3["launches"][1] +
                     p1["launches"][1] + p2["launches"][1] +
                     p3["launches"][1] + air_bwd + serve_bwd +
                     process_bwd),
        "max_abs_err": fb["max_abs_err"],
        "ms": fb["ms"],
        "plain_ms": fb["plain_ms"],
        "bound_ms": fb["bound_ms"],
        "bound_us": fb["bound_ms"] * 1e3,
        "bound_by": fb["bound_by"],
        "library_ms": fb["library_ms"],
        "d128": {key: fb128[key] for key in
                 ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }]
    log(json.dumps({"path_a_ms_per_tick": ms_a,
                    "path_b_ms_per_tick": ms_b,
                    "forward_ms": ms_fwd,
                    "forward_tokens_per_s": tok_s,
                    "forward_f32_max_abs_err": err_f32,
                    "forward_bf16_rel_err": rel_bf16,
                    "train_step_ms": t2["step_ms"],
                    "train_tokens_per_s": t2["tokens_per_s"],
                    "train_tflops": t2["tflops"],
                    "train_peak_gb": t2["peak_gb"],
                    "train_loss_first": t2["loss_first"],
                    "train_loss_final": t2["loss_final"],
                    "train_f32_max_param_diff": t1["param"],
                    "moe_forward_ms": m3["ms"],
                    "moe_forward_tokens_per_s": m3["tokens_per_s"],
                    "moe_forward_bf16_rel_err": m3["rel"],
                    "moe_forward_drop_share": m3["drop_share"],
                    "moe_forward_flipped_tokens": m3["flipped_tokens"],
                    "moe_train_step_ms": t3["step_ms"],
                    "moe_train_tokens_per_s": t3["tokens_per_s"],
                    "moe_train_tflops": t3["tflops"],
                    "moe_train_peak_gb": t3["peak_gb"],
                    "moe_train_loss_first": t3["loss_first"],
                    "moe_train_loss_final": t3["loss_final"],
                    "moe_train_f32_max_param_diff": t3f["param"],
                    "mesh_train_f32_max_param_diff": p1["param"],
                    "mesh_ring_max_abs_err": ring_err,
                    "mesh_train_step_ms": p2["step_ms"],
                    "mesh_train_tokens_per_s": p2["tokens_per_s"],
                    "mesh_train_loss_first": p2["loss_first"],
                    "mesh_train_loss_final": p2["loss_final"],
                    "pp_train_step_ms": p3["step_ms"],
                    "pp_train_tokens_per_s": p3["tokens_per_s"],
                    "pp_train_loss_first": p3["loss_first"],
                    "pp_train_loss_final": p3["loss_final"],
                    "device_ops_per_step": {
                        "train": t2["ops_per_step"],
                        "moe_train": t3["ops_per_step"],
                        "mesh_train": p2["ops_per_step"],
                        "pp_train": p3["ops_per_step"]},
                    "bundles_ms_per_call": bundle_ms,
                    "sinkhorn_ms_per_tick": sinkhorn_ms,
                    "runtime_tick_ms": r1["tick_ms"],
                    "runtime_tick_host_ms": r1["tick_host_ms"],
                    "runtime_rounds": r1["rounds"],
                    "runtime_decisions": r1["decisions"],
                    "runtime_tick_stats": r1["tick_stats"],
                    "runtime_solver_stats": r1["solver"],
                    "autoscaler_ms_per_call": r2["ms_launch"],
                    "autoscaler_residual_ms_per_call": r2["ms_residual"],
                    "autoscaler_device_ms_per_call": r2["device_ms_launch"],
                    "autoscaler_residual_device_ms_per_call":
                        r2["device_ms_residual"],
                    "autoscaler_unfulfilled": r2["unfulfilled"],
                    "autoscaler_to_launch": r2["to_launch"],
                    "cluster_leases": r3["leases"],
                    "cluster_leases_per_s": r3["leases_per_s"],
                    "cluster_lease_p50_ms": r3["p50_ms"],
                    "cluster_lease_p99_ms": r3["p99_ms"],
                    "cluster_spillbacks": r3["spillbacks"],
                    "cluster_rejections": r3["rejections"],
                    "cluster_batched_raylets":
                        r3["raylets_with_batched_ticks"],
                    "cluster_infeasible": r3["infeasible"],
                    "cluster_wall_s": r3["wall_s"],
                    "tasks_single": {k: c1[k] for k in (
                        "num_cpus", "tasks_per_s", "latency_p50_ms",
                        "latency_p99_ms", "args_s", "returns_s",
                        "get_many_s", "batched_ticks", "launches")},
                    "tasks_cluster": {k: c2[k] for k in (
                        "submitted", "dropped_infeasible", "dropped_share",
                        "tasks_per_s", "wall_s", "submit_s",
                        "latency_p50_ms", "latency_p99_ms", "launches",
                        "batched_ticks", "spillbacks",
                        "spillback_rejections", "peak_workers")},
                    "objects": objects,
                    "groups": {k: g1[k] for k in (
                        "groups", "bundles", "create_wait_p50_ms",
                        "create_wait_p99_ms", "bundle_solves",
                        "bundle_solve_ms", "tasks_per_s", "view_columns",
                        "r_pad", "full_syncs", "batched_ticks",
                        "bundle_stats", "device_ms", "profiled_wall_ms",
                        "idle_share", "launches")},
                    "autoscaler_loop": a1,
                    "task_events": c2["events"],
                    "heartbeat_death": h1,
                    "gcs_restart": h2,
                    "actors": k1,
                    "actor_faults": k2,
                    "device_objects": d1,
                    "util": u1,
                    "train_dp": {k: v for k, v in l1.items()
                                 if k not in ("losses", "ref_losses")},
                    "data_ml": l2,
                    "serve_model": s1,
                    "autoscale": s2,
                    "tune_model": n1,
                    "ppo": q1,
                    "dqn_impala": q2,
                    "workflow_pool": w1,
                    "process_workers": x1,
                    "process_train": {k: v for k, v in x2.items()
                                      if k not in ("losses", "ref_losses")},
                    "launches": {"path_a": launches_a,
                                 "path_b": launches_b,
                                 "runtime": r1["launches"],
                                 "autoscaler": r2["launches"],
                                 "cluster": r3["launches"],
                                 "tasks_single": c1["launches"],
                                 "tasks_cluster": c2["launches"],
                                 "objects": {k: o["launches"] for k, o in
                                             objects.items()},
                                 "groups": g1["launches"],
                                 "autoscaler_loop": a1["launches"],
                                 "heartbeat_death": h1["launches"],
                                 "gcs_restart": h2["launches"],
                                 "actors": k1["launches"],
                                 "actor_faults": k2["launches"],
                                 "device_objects": d1["launches"],
                                 "util": u1["launches"],
                                 "forward": launches_m,
                                 "moe_forward": m3["launches"],
                                 "train_forward": t2["launches"][0],
                                 "train_backward": t2["launches"][1],
                                 "moe_train_forward": t3["launches"][0],
                                 "moe_train_backward": t3["launches"][1],
                                 "mesh_train_f32_forward": p1["launches"][0],
                                 "mesh_train_f32_backward":
                                     p1["launches"][1],
                                 "mesh_train_forward": p2["launches"][0],
                                 "mesh_train_backward": p2["launches"][1],
                                 "pp_train_forward": p3["launches"][0],
                                 "pp_train_backward": p3["launches"][1],
                                 "train_dp": {"gang": l1["gang"],
                                              "run": l1["launches"]},
                                 "data_ml": {
                                     "fit": l2["launches_fit"],
                                     "predict": l2["launches_predict"]},
                                 "serve_model": s1["launches"],
                                 "autoscale": s2["launches"],
                                 "tune_model": n1["launches"],
                                 "ppo": q1["launches"],
                                 "dqn_impala": q2["launches"],
                                 "workflow_pool": w1["launches"],
                                 "process_workers": {
                                     "burst": x1["process"]["launches"],
                                     "thread_burst":
                                         x1["threads"]["launches"],
                                     "flash_forward":
                                         x1["model"]["flash_launches"]},
                                 "process_train": {
                                     "class_fill": x2["class_fill"],
                                     "flash_forward": x2["flash_forward"],
                                     "flash_backward":
                                         x2["flash_backward"]}}},
                   default=str))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
