"""Scheduling policies — where a task/bundle should run.

A copy of ``ray_tpu.scheduler.policy`` for the PyTorch port; the
runtime solver routes every non-HYBRID spec through ``schedule``.

Parity targets:
  * ``HybridSchedulingPolicy::Schedule`` (reference
    ``src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc:139``):
    traversal order [local node, others sorted by id]; score =
    critical-resource utilization truncated below
    ``scheduler_spread_threshold`` (ray_config_def.h:138); prefer
    available > feasible; accelerator nodes avoided for CPU-only work
    (ray_config_def.h:533).
  * ``SchedulingType {HYBRID, SPREAD, RANDOM, NODE_AFFINITY}`` enum +
    ``CompositeSchedulingPolicy`` dispatch (policy/scheduling_options.h:27,
    composite_scheduling_policy.h:28-44) — **the plugin point the TPU batch
    backend registers into** (`scheduler_backend=jax`, SURVEY.md §5.6).

TPU-first deviation: scoring is vectorized over the dense [N, R] columnar
view rather than a per-node loop, so single-task scheduling is a numpy op
and the batched path (ray_tpu_torch.scheduler.torch_backend) shares the exact same
inputs.
"""

from __future__ import annotations

import enum
import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.scheduler.resources import (
    ClusterResourceView,
    ResourceRequest,
    accelerator_node_mask,
)


class SchedulingType(enum.Enum):
    HYBRID = "hybrid"
    SPREAD = "spread"
    RANDOM = "random"
    NODE_AFFINITY = "node_affinity"
    JAX_BATCH = "jax_batch"


@dataclass
class SchedulingOptions:
    """Per-request scheduling options (scheduling_options.h parity)."""

    scheduling_type: SchedulingType = SchedulingType.HYBRID
    spread_threshold: float = field(
        default_factory=lambda: get_config().scheduler_spread_threshold)
    avoid_local_node: bool = False
    require_node_available: bool = False
    avoid_accelerator_nodes: bool = field(
        default_factory=lambda: get_config().scheduler_avoid_tpu_nodes)
    node_affinity_node_id: Optional[object] = None
    node_affinity_soft: bool = False

    @classmethod
    def hybrid(cls, **kw):
        return cls(scheduling_type=SchedulingType.HYBRID, **kw)

    @classmethod
    def spread(cls, **kw):
        return cls(scheduling_type=SchedulingType.SPREAD, **kw)

    @classmethod
    def random(cls, **kw):
        return cls(scheduling_type=SchedulingType.RANDOM, **kw)

    @classmethod
    def affinity(cls, node_id, soft=False):
        return cls(scheduling_type=SchedulingType.NODE_AFFINITY,
                   node_affinity_node_id=node_id, node_affinity_soft=soft)


def _masks(view: ClusterResourceView, req: ResourceRequest,
           options: SchedulingOptions):
    """Vectorized feasible/available masks + utilization scores.

    Returns (node_ids, available_mask[N], feasible_mask[N], score[N]) where
    score is the post-placement critical-resource utilization
    (hybrid_scheduling_policy.cc:100-133), truncated below spread_threshold.
    """
    node_ids, total, avail, columns = view.snapshot()
    n = len(node_ids)
    if n == 0:
        return node_ids, np.zeros(0, bool), np.zeros(0, bool), np.zeros(0)
    demand = np.zeros(total.shape[1], dtype=np.float32)
    for name, v in req.to_dict().items():
        col = columns.get(name)
        if col is None:
            # No node in this view has ever offered the resource:
            # infeasible everywhere.
            return node_ids, np.zeros(n, bool), np.zeros(n, bool), \
                np.zeros(n, dtype=np.float32)
        demand[col] = v

    eps = 1e-6
    feasible = (total + eps >= demand).all(axis=1)
    available = (avail + eps >= demand).all(axis=1)

    # Suspect nodes (missed-beats grace) take no NEW placements at all:
    # excluded from BOTH masks — leaving them merely unavailable would
    # let the feasible-fallback branch still pick them.
    masked = view.masked_nodes()
    if masked:
        for i, nid in enumerate(node_ids):
            if nid in masked:
                feasible[i] = False
                available[i] = False

    # Post-placement utilization per resource, max over demanded resources.
    with np.errstate(divide="ignore", invalid="ignore"):
        used_after = np.clip(total - avail + demand, 0.0, None)
        util = np.where(total > 0, used_after / np.maximum(total, eps), 0.0)
    demanded_cols = demand > 0
    if demanded_cols.any():
        score = util[:, demanded_cols].max(axis=1)
    else:
        # Pure control tasks score by overall utilization to still pack.
        score = util.max(axis=1) if util.size else np.zeros(n)
    score = np.where(score < options.spread_threshold, 0.0, score)

    # Avoid accelerator nodes for non-accelerator work: add a soft penalty
    # so they rank last among equals (reference .cc:143-165 hard-skips when
    # alternatives exist; penalty + argsort gives the same preference).
    if options.avoid_accelerator_nodes and not req.uses_accelerator():
        accel = accelerator_node_mask(total)
        score = score + accel.astype(np.float32) * 1.0
    return node_ids, available, feasible, score


def schedule(view: ClusterResourceView, req: ResourceRequest,
             options: SchedulingOptions, local_node_id=None):
    """Composite dispatch (composite_scheduling_policy.h:28-44)."""
    t = options.scheduling_type
    if t is SchedulingType.NODE_AFFINITY:
        return _schedule_affinity(view, req, options)
    if t is SchedulingType.RANDOM:
        return _schedule_random(view, req, options)
    if t is SchedulingType.SPREAD:
        return _schedule_spread(view, req, options, local_node_id)
    return _schedule_hybrid(view, req, options, local_node_id)


def _schedule_hybrid(view, req, options, local_node_id):
    node_ids, available, feasible, score = _masks(view, req, options)
    if not len(node_ids):
        return None
    # Traversal order: local first, then others sorted by id (.cc:35-73).
    order = np.arange(len(node_ids))
    keys = sorted(range(len(node_ids)),
                  key=lambda i: (node_ids[i] != local_node_id, node_ids[i]))
    order = np.array(keys)
    rank = np.empty(len(node_ids))
    rank[order] = np.arange(len(node_ids))
    if options.avoid_local_node and local_node_id in node_ids:
        li = node_ids.index(local_node_id)
        available = available.copy()
        available[li] = False
    # Prefer available over feasible; among available pick min (score, rank).
    cand = np.nonzero(available)[0]
    if len(cand) == 0:
        if options.require_node_available:
            return None
        cand = np.nonzero(feasible)[0]
        if len(cand) == 0:
            return None
    best = min(cand, key=lambda i: (score[i], rank[i]))
    return node_ids[best]


def _schedule_spread(view, req, options, local_node_id):
    # Round-robin over available nodes (scheduling_policy.cc Spread):
    # pick the available node with the lowest utilization, random tie-break.
    node_ids, available, feasible, score = _masks(view, req, options)
    cand = np.nonzero(available)[0]
    if len(cand) == 0:
        cand = np.nonzero(feasible)[0]
        if len(cand) == 0 or options.require_node_available:
            return None
    min_score = score[cand].min()
    ties = [i for i in cand if score[i] <= min_score + 1e-9]
    return node_ids[random.choice(ties)]


def _schedule_random(view, req, options):
    node_ids, available, feasible, _ = _masks(view, req, options)
    cand = np.nonzero(available)[0]
    if len(cand) == 0:
        cand = np.nonzero(feasible)[0]
        if len(cand) == 0:
            return None
    return node_ids[random.choice(list(cand))]


def _schedule_affinity(view, req, options):
    target = options.node_affinity_node_id
    node = view.node_resources(target)
    if node is not None and node.is_available(req):
        return target
    if node is not None and node.is_feasible(req) and not options.node_affinity_soft:
        return target  # queue on the target; it will run when resources free
    if options.node_affinity_soft:
        return _schedule_hybrid(view, req,
                                SchedulingOptions.hybrid(), None)
    return None
