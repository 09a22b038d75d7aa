"""Bundle -> node packing for placement groups.

The counterpart of ``ray_tpu/scheduler/bundle_packing.py`` (reference
parity: ``GcsResourceScheduler::Schedule`` with PACK / SPREAD /
STRICT_PACK / STRICT_SPREAD and the ``LeastResourceScorer`` best fit).
``pack_bundles`` solves a group in one device program
(``BatchSolver.solve_bundles``) when the cluster is large enough
(``pg_kernel_backend`` / ``pg_kernel_min_nodes``), and keeps the numpy
greedy below as the small-cluster path and the validation oracle: the
device's assignment is re-validated against the exact quantized vectors
on the host.

Divergence from the reference, kept on purpose: the reference turns any
exception of the device solve into a greedy solve.  Here the failure is
counted in ``kernel_stats["kernel_errors"]`` and raised, so a broken
device path cannot hide behind the greedy one.  A data miss (the solve
reports a bundle infeasible, its assignment fails validation, no nodes)
still goes to the greedy solve, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.scheduler.resources import (ClusterResourceView,
                                               ResourceRequest)

# How often placement-group packing rode the device solve, missed it
# (greedy after a data miss), failed on it, or used the greedy solve.
kernel_stats = {"kernel_placements": 0, "kernel_misses": 0,
                "kernel_errors": 0, "greedy_placements": 0}


def _kernel_enabled(num_nodes: int) -> bool:
    cfg = get_config()
    mode = cfg.pg_kernel_backend
    if mode == "off":
        return False
    if mode == "force":
        return True
    return num_nodes >= cfg.pg_kernel_min_nodes


def _least_resource_score(avail: Dict[str, int],
                          demand: Dict[str, int]) -> float:
    """LeastResourceScorer: prefer the node that, after allocation, has
    the least leftover of the demanded resources (best fit).  Returns
    -inf if infeasible."""
    score = 0.0
    for name, amount in demand.items():
        have = avail.get(name, 0)
        if have < amount:
            return float("-inf")
        score += 1.0 - (have - amount) / max(have, 1)
    return score / max(len(demand), 1)


def pack_bundles(view: ClusterResourceView,
                 bundles: Sequence[ResourceRequest],
                 strategy: str,
                 exclude_nodes: Optional[Set] = None,
                 device=None) -> Optional[List]:
    """Solve bundle->node placement; returns node id per bundle or None.

    All-or-nothing: placement is simulated on copies of the availability
    maps, so a partial fit never leaks into the live view.  With the
    device solve enabled (``_kernel_enabled``) the group is solved on
    ``device`` (``None``: the card) and validated; a data miss falls
    through to the greedy solve, a device failure is counted and
    raised."""
    if _kernel_enabled(view.num_nodes()):
        try:
            assignment = pack_bundles_kernel(view, bundles, strategy,
                                             exclude_nodes, device=device)
        except Exception:
            kernel_stats["kernel_errors"] += 1
            raise
        if assignment is not None:
            kernel_stats["kernel_placements"] += 1
            return assignment
        kernel_stats["kernel_misses"] += 1
    result = _pack_bundles_greedy(view, bundles, strategy, exclude_nodes)
    if result is not None:
        kernel_stats["greedy_placements"] += 1
    return result


def validate_assignment(view: ClusterResourceView,
                        bundles: Sequence[ResourceRequest],
                        assignment: List, strategy: str,
                        exclude_nodes: Set) -> bool:
    """Exact host-side check of a proposed bundle->node assignment
    against the quantized per-node vectors: sequential feasibility,
    exclusion, and the hard strategy constraints."""
    sim: Dict = {}
    if strategy == "STRICT_PACK" and len(set(assignment)) > 1:
        return False
    if strategy == "STRICT_SPREAD" and \
            len(set(assignment)) != len(assignment):
        return False
    for nid, bundle in zip(assignment, bundles):
        if nid in exclude_nodes:
            return False
        if nid not in sim:
            res = view.node_resources(nid)
            if res is None:
                return False
            sim[nid] = dict(res.available)
        have = sim[nid]
        for k, v in bundle.quantized().items():
            if have.get(k, 0) < v:
                return False
            have[k] = have[k] - v
    return True


def device_rows(bundles: Sequence[ResourceRequest], strategy: str):
    """The rows the device solve places, in its order, as ``(order,
    requests)``: the bundles largest first (FFD; ``order[j]`` is the
    bundle of row j), or for STRICT_PACK one composite row."""
    if strategy == "STRICT_PACK":
        combined: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.to_dict().items():
                combined[k] = combined.get(k, 0.0) + v
        return [0], [ResourceRequest(combined)]
    order = sorted(range(len(bundles)),
                   key=lambda i: -sum(bundles[i].quantized().values()))
    return order, [bundles[i] for i in order]


def pack_bundles_kernel(view: ClusterResourceView,
                        bundles: Sequence[ResourceRequest],
                        strategy: str,
                        exclude_nodes: Optional[Set] = None,
                        device=None) -> Optional[List]:
    """One device program for the group (``BatchSolver.solve_bundles``
    on ``device``).

    The host does what the greedy does around its loop: sort large
    bundles first (FFD), collapse STRICT_PACK into one composite row,
    then validate the device's assignment against the exact quantized
    vectors.  Returns None (the caller's greedy solve) on any miss."""
    from ray_tpu_torch.scheduler.torch_backend import BatchSolver
    exclude_nodes = exclude_nodes or set()
    if not bundles or any(not b.quantized() for b in bundles):
        return None                  # empty bundles: greedy's edge case
    if view.num_nodes() == 0:
        return None
    order, reqs = device_rows(bundles, strategy)
    # demand_matrix first (it may create columns), one snapshot after.
    demand = view.demand_matrix(reqs)
    node_ids, total, avail, _ = view.snapshot()
    if not node_ids:
        return None
    if demand.shape[1] < total.shape[1]:
        demand = np.pad(demand,
                        ((0, 0), (0, total.shape[1] - demand.shape[1])))
    excluded = np.array([nid in exclude_nodes for nid in node_ids],
                        dtype=bool)
    idx, ok = BatchSolver(device=device).solve_bundles(
        avail, total, demand, strategy, excluded)
    if not ok.all():
        return None
    if strategy == "STRICT_PACK":
        n = int(idx[0])
        if not 0 <= n < len(node_ids):
            return None
        assignment: List = [node_ids[n]] * len(bundles)
    else:
        assignment = [None] * len(bundles)
        for j, i in enumerate(order):
            n = int(idx[j])
            if not 0 <= n < len(node_ids):
                return None
            assignment[i] = node_ids[n]
    if not validate_assignment(view, bundles, assignment, strategy,
                               exclude_nodes):
        return None
    return assignment


def _pack_bundles_greedy(view: ClusterResourceView,
                         bundles: Sequence[ResourceRequest],
                         strategy: str,
                         exclude_nodes: Optional[Set] = None
                         ) -> Optional[List]:
    """Reference-parity numpy greedy (LeastResourceScorer best fit): the
    small-cluster path and the device solve's validation oracle."""
    exclude_nodes = exclude_nodes or set()
    node_ids = [n for n in view.node_ids() if n not in exclude_nodes]
    if not node_ids:
        return None
    sim: Dict = {}
    for nid in node_ids:
        res = view.node_resources(nid)
        if res is None:
            continue
        sim[nid] = dict(res.available)

    if strategy == "STRICT_PACK":
        total: Dict[str, int] = {}
        for b in bundles:
            for k, v in b.quantized().items():
                total[k] = total.get(k, 0) + v
        best, best_score = None, float("-inf")
        for nid in node_ids:
            s = _least_resource_score(sim[nid], total)
            if s > best_score:
                best, best_score = nid, s
        if best is None or best_score == float("-inf"):
            return None
        return [best] * len(bundles)

    # Large bundles first (first-fit-decreasing flavour), keeping the
    # original index to un-permute the answer.
    order = sorted(range(len(bundles)),
                   key=lambda i: -sum(bundles[i].quantized().values()))
    placement: List = [None] * len(bundles)
    used_nodes: Set = set()

    for i in order:
        demand = bundles[i].quantized()
        best, best_score = None, float("-inf")
        for nid in node_ids:
            if strategy == "STRICT_SPREAD" and nid in used_nodes:
                continue
            s = _least_resource_score(sim[nid], demand)
            if s == float("-inf"):
                continue
            # PACK prefers already-used nodes; SPREAD prefers fresh nodes.
            if strategy == "PACK" and nid in used_nodes:
                s += 10.0
            elif strategy == "SPREAD" and nid in used_nodes:
                s -= 10.0
            if s > best_score:
                best, best_score = nid, s
        if best is None:
            return None
        placement[i] = best
        used_nodes.add(best)
        for k, v in demand.items():
            sim[best][k] = sim[best].get(k, 0) - v
    return placement


def bundle_resource_names(pg_id, bundle_index: int,
                          resources: ResourceRequest) -> Dict[str, float]:
    """Formatted placement-group resources added to a node on commit:
    for each resource R of the bundle, ``R_group_{pg_id}`` (wildcard) and
    ``R_group_{index}_{pg_id}`` (indexed), plus the bundle marker
    resource; tasks using the group consume those instead of the base
    resources."""
    out: Dict[str, float] = {}
    hexid = pg_id.hex()
    for name, amount in resources.to_dict().items():
        out[f"{name}_group_{hexid}"] = amount
        out[f"{name}_group_{bundle_index}_{hexid}"] = amount
    # The bundle marker lets zero-CPU tasks target a bundle and lets
    # pg.ready() probe placement.
    out[f"bundle_group_{hexid}"] = 1000
    out[f"bundle_group_{bundle_index}_{hexid}"] = 1000
    return out


def rewrite_resources_for_bundle(resources: Dict[str, float], pg_id,
                                 bundle_index: int) -> Dict[str, float]:
    """Rewrite a task's resource demand to the group-formatted resources."""
    hexid = pg_id.hex()
    out: Dict[str, float] = {}
    for name, amount in resources.items():
        if bundle_index >= 0:
            out[f"{name}_group_{bundle_index}_{hexid}"] = amount
        else:
            out[f"{name}_group_{hexid}"] = amount
    # Always demand a sliver of the bundle marker, so even zero-resource
    # tasks wait for (and land on) the bundle's node.
    if bundle_index >= 0:
        out.setdefault(f"bundle_group_{bundle_index}_{hexid}", 0.001)
    else:
        out.setdefault(f"bundle_group_{hexid}", 0.001)
    return out
