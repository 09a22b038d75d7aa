"""ResourceDemandScheduler: demand vector -> node types to launch.

A port of ``ray_tpu.autoscaler.resource_demand_scheduler`` for the
PyTorch port; its pack mode runs the port's device solve
(``BatchSolver.solve_matrices`` with ``invert_util`` and
``zero_shifts``, the class-fill kernel on the card).  Every public
function and the scheduler take ``device=``: the card unless the caller
passes ``"cpu"``.

Divergence: the reference turns any exception of the kernel path into a
numpy solve.  Here the failure is counted in
``kernel_stats["kernel_errors"]`` and raised, as in the port's
placement-group packing.  The numpy path below ``_kernel_enabled``'s
thresholds stays: it is the reference's exact small-problem semantics,
not a fallback.

Reference parity: reference
``python/ray/autoscaler/_private/resource_demand_scheduler.py`` —
``get_nodes_to_launch`` (:143) runs (1) current-resource accounting,
(2) min_workers fill (:683 ``_add_min_workers_nodes``), (3) strict-spread
placement-group reservation (:580 ``reserve_and_allocate_spread``),
(4) first-fit-decreasing residual ``get_bin_pack_residual`` (:895), and
(5) ``get_nodes_for`` to pick node types for the residual, clamped by
``max_workers`` and ``upscaling_speed``.

Columnar packer: instead of dict-of-dict first-fit loops, demands dedup
into (class, count) runs over a shared resource vocabulary and each class
is water-filled against an [N, R] availability matrix, the same math as
``ray_tpu_torch.scheduler.torch_backend``'s tick.
``get_bin_pack_residual`` and ``get_nodes_for`` route through that solve
(pack mode: inverted-utilization ordering, zero per-class shifts —
most-utilized-feasible first, first-fit within a bucket) when the
problem is big enough for the device dispatch to pay
(``autoscaler_kernel_backend`` / ``autoscaler_kernel_min_cells``); the
numpy first-fit-decreasing below stays as the exact small-problem path.
``get_nodes_for`` batches each candidate node type as a hypothetical
fleet of ``max_to_add`` identical nodes and solves all residual demand
classes against it in one call; the per-node python loop only survives
on the numpy path.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device

ResourceDict = Dict[str, float]
NodeType = str

# Kernel-vs-numpy routing telemetry.
kernel_stats = {"kernel_solves": 0, "kernel_errors": 0, "numpy_solves": 0}


def _kernel_enabled(num_nodes: int, num_demands: int) -> bool:
    cfg = get_config()
    mode = cfg.autoscaler_kernel_backend
    if mode == "off":
        return False
    if mode == "force":
        return True
    # A near-single-node pack is trivial host-side — the device
    # dispatch can never pay for it, however long the demand list.
    return num_nodes >= 8 and \
        num_nodes * num_demands >= cfg.autoscaler_kernel_min_cells


def _vocab(node_resources: List[ResourceDict],
           demands: List[ResourceDict]) -> List[str]:
    names: List[str] = []
    seen = set()
    for d in list(node_resources) + list(demands):
        for k in d:
            if k not in seen:
                seen.add(k)
                names.append(k)
    return names


def _to_matrix(dicts: List[ResourceDict], names: List[str]) -> np.ndarray:
    mat = np.zeros((len(dicts), len(names)), dtype=np.float64)
    idx = {n: i for i, n in enumerate(names)}
    for r, d in enumerate(dicts):
        for k, v in d.items():
            mat[r, idx[k]] = v
    return mat


def _sort_key(demand: ResourceDict):
    # Reference ordering (:929): more complex first, then heavier, then
    # lexicographic for stability.
    return (len(demand), sum(demand.values()), sorted(demand.items()))


def _group_sorted(demands: List[ResourceDict]):
    """Sorted (FFD order) then grouped into (demand, count) runs —
    identical consecutive demands waterfill identically to per-item FFD."""
    ordered = sorted(demands, key=_sort_key, reverse=True)
    runs: List[Tuple[ResourceDict, int]] = []
    for d in ordered:
        if runs and runs[-1][0] == d:
            runs[-1] = (d, runs[-1][1] + 1)
        else:
            runs.append((d, 1))
    return runs


def _pack_mode_matrices(node_resources: List[ResourceDict],
                        resource_demands: List[ResourceDict]):
    """Shared host-side prep for the pack-mode kernel solve."""
    names = _vocab(node_resources, resource_demands)
    runs = _group_sorted(resource_demands)
    demand = _to_matrix([d for d, _ in runs], names).astype(np.float32)
    counts = np.array([c for _, c in runs], dtype=np.float32)
    avail = _to_matrix(node_resources, names).astype(np.float32)
    return names, runs, demand, counts, avail


def _pack_mode_solve(runs, demand, counts, avail, device=None):
    """THE pack-mode kernel call (inverted utilization + zero shifts)
    — one implementation behind pack_with_jax_kernel AND the routed
    residual path.  Returns (unfulfilled, alloc[C, N])."""
    from ray_tpu_torch.scheduler.torch_backend import BatchSolver
    alloc = BatchSolver(device=device).solve_matrices(
        avail, avail, demand, counts, spread_threshold=0.0,
        invert_util=True, zero_shifts=True)
    kernel_stats["kernel_solves"] += 1
    unfulfilled: List[ResourceDict] = []
    for i, (d, c) in enumerate(runs):
        short = int(c) - int(alloc[i].sum())
        if short > 0:
            unfulfilled.extend([dict(d)] * short)
    return unfulfilled, alloc


def _kernel_bin_pack(node_resources: List[ResourceDict],
                     resource_demands: List[ResourceDict], device=None,
                     ) -> Tuple[List[ResourceDict], List[ResourceDict], int]:
    """One-device-call bin-pack deriving the residual contract on top
    of :func:`_pack_mode_solve`: (unfulfilled, nodes_after,
    nodes_used)."""
    names, runs, demand, counts, avail = _pack_mode_matrices(
        node_resources, resource_demands)
    unfulfilled, alloc = _pack_mode_solve(runs, demand, counts, avail,
                                          device)
    after = np.maximum(
        avail.astype(np.float64) -
        alloc.T.astype(np.float64) @ demand.astype(np.float64), 0.0)
    idx = {n: i for i, n in enumerate(names)}
    nodes_after = [{k: float(after[r, idx[k]]) for k in orig}
                   for r, orig in enumerate(node_resources)]
    nodes_used = int((alloc.sum(axis=0) > 0).sum())
    return unfulfilled, nodes_after, nodes_used


def get_bin_pack_residual(node_resources: List[ResourceDict],
                          resource_demands: List[ResourceDict],
                          strict_spread: bool = False,
                          _use_kernel: Optional[bool] = None,
                          device=None,
                          ) -> Tuple[List[ResourceDict], List[ResourceDict]]:
    """Columnar first-fit-decreasing. Returns (unfulfilled, nodes_after).

    Semantics match reference ``get_bin_pack_residual`` (:895): demands
    sorted complex/heavy-first; ``strict_spread`` forbids node reuse.
    Big non-strict problems route through the batched device solve
    (``_kernel_bin_pack``); numpy is the exact small-problem path
    (``_use_kernel=False`` pins it — get_nodes_for's numpy loop uses
    it for its single-node packs).  A failure of the device solve is
    counted in ``kernel_stats["kernel_errors"]`` and raised.
    """
    if not resource_demands:
        return [], copy.deepcopy(node_resources)
    use_kernel = _kernel_enabled(len(node_resources),
                                 len(resource_demands)) \
        if _use_kernel is None else _use_kernel
    if not strict_spread and use_kernel:
        try:
            unfulfilled, nodes_after, _ = _kernel_bin_pack(
                node_resources, resource_demands, device)
        except Exception:
            kernel_stats["kernel_errors"] += 1
            raise
        return unfulfilled, nodes_after
    kernel_stats["numpy_solves"] += 1
    names = _vocab(node_resources, resource_demands)
    avail = _to_matrix(node_resources, names)
    used = np.zeros(len(node_resources), dtype=bool)
    unfulfilled: List[ResourceDict] = []
    eps = 1e-9

    for demand, count in _group_sorted(resource_demands):
        d = _to_matrix([demand], names)[0]
        demanded = d > 0
        if not demanded.any():
            continue
        remaining = count
        if strict_spread:
            fits = (avail[:, demanded] + eps >= d[demanded]).all(axis=1)
            fits &= ~used
            for n in np.flatnonzero(fits)[:remaining]:
                avail[n] -= d
                used[n] = True
                remaining -= 1
        else:
            while remaining > 0:
                ratios = np.where(demanded[None, :],
                                  (avail + eps) / np.maximum(d, eps)[None, :],
                                  np.inf)
                cap = np.floor(ratios.min(axis=1)).astype(np.int64)
                if cap.max(initial=0) <= 0:
                    break
                # First-fit order: fill nodes in list order.
                for n in np.flatnonzero(cap > 0):
                    take = min(remaining, int(cap[n]))
                    avail[n] -= take * d
                    remaining -= take
                    if remaining == 0:
                        break
        unfulfilled.extend([dict(demand)] * remaining)

    idx = {n: i for i, n in enumerate(names)}
    nodes_after = []
    for r, orig in enumerate(node_resources):
        nodes_after.append({k: float(avail[r, idx[k]]) for k in orig})
    return unfulfilled, nodes_after


def _kernel_get_nodes_for(node_types: Dict[NodeType, dict],
                          existing_nodes: Dict[NodeType, int],
                          max_to_add: int,
                          resources: List[ResourceDict],
                          strict_spread: bool = False, device=None,
                          ) -> Tuple[Dict[NodeType, int],
                                     List[ResourceDict]]:
    """Batched node-count solve: each candidate type is a hypothetical
    fleet of ``headroom`` identical nodes and ALL residual demand
    classes solve against it in ONE kernel call (pack mode, so the
    solve uses as few fleet nodes as the fill allows); the used-node
    count IS the launch count for the winning type.  Replaces the
    numpy path's one-node-per-iteration python loop."""
    nodes_to_add: Dict[NodeType, int] = {}
    allocated = dict(existing_nodes)
    residual = list(resources)
    while residual and sum(nodes_to_add.values()) < max_to_add:
        budget = max_to_add - sum(nodes_to_add.values())
        best = None  # ((num_fit, -node_size), type, used, new_residual)
        for node_type, spec in node_types.items():
            limit = spec.get("max_workers", 2 ** 30)
            headroom = min(budget, limit - allocated.get(node_type, 0))
            if headroom <= 0:
                continue
            node_res = spec.get("resources", {})
            if not node_res:
                continue
            if strict_spread:
                # Each demand gets its own fresh node: a per-demand fit
                # check is exact (no packing interaction).  Place up to
                # ``headroom`` fitting demands, keep the rest.
                unfulfilled = []
                used = 0
                for d in residual:
                    if used < headroom and all(
                            node_res.get(k, 0) >= v
                            for k, v in d.items()):
                        used += 1
                    else:
                        unfulfilled.append(d)
            else:
                unfulfilled, _, used = _kernel_bin_pack(
                    [dict(node_res)] * headroom, residual, device)
            num_fit = len(residual) - len(unfulfilled)
            if num_fit <= 0:
                continue
            # Most demands fitted first, then FEWEST nodes launched,
            # then the smaller node type (less waste) — mirrors the
            # numpy path's one-node-at-a-time preference for the type
            # that fits the most demands per node.
            score = (num_fit, -max(used, 1), -sum(node_res.values()))
            if best is None or score > best[0]:
                best = (score, node_type, max(used, 1), unfulfilled)
        if best is None:
            break
        _, node_type, used, residual = best
        nodes_to_add[node_type] = nodes_to_add.get(node_type, 0) + used
        allocated[node_type] = allocated.get(node_type, 0) + used
    return nodes_to_add, residual


def get_nodes_for(node_types: Dict[NodeType, dict],
                  existing_nodes: Dict[NodeType, int],
                  max_to_add: int,
                  resources: List[ResourceDict],
                  strict_spread: bool = False, device=None,
                  ) -> Tuple[Dict[NodeType, int], List[ResourceDict]]:
    """Pick node types to satisfy ``resources`` (reference ``get_nodes_for``,
    :812): greedily add the node type whose resources satisfy the largest
    number of demands (utilization-scored), respecting per-type
    ``max_workers`` and the global ``max_to_add``.  Big problems route
    through the batched kernel variant; numpy below is the exact
    small-problem path.  A failure of the device solve is counted in
    ``kernel_stats["kernel_errors"]`` and raised."""
    if _kernel_enabled(max_to_add, len(resources)):
        try:
            return _kernel_get_nodes_for(node_types, existing_nodes,
                                         max_to_add, resources,
                                         strict_spread, device)
        except Exception:
            kernel_stats["kernel_errors"] += 1
            raise
    nodes_to_add: Dict[NodeType, int] = {}
    allocated = dict(existing_nodes)
    residual = list(resources)
    while residual and sum(nodes_to_add.values()) < max_to_add:
        best = None  # (score, node_type, new_residual)
        for node_type, spec in node_types.items():
            limit = spec.get("max_workers", 2 ** 30)
            if allocated.get(node_type, 0) >= limit:
                continue
            node_res = spec.get("resources", {})
            if not node_res:
                continue
            # Single-node pack: always the numpy path.
            fulfilled, _ = get_bin_pack_residual(
                [dict(node_res)], residual, strict_spread=strict_spread,
                _use_kernel=False)
            num_fit = len(residual) - len(fulfilled)
            if num_fit <= 0:
                continue
            # Prefer the type that fits the most demands; tie-break on
            # fewer wasted resources (smaller node).
            score = (num_fit, -sum(node_res.values()))
            if best is None or score > best[0]:
                best = (score, node_type, fulfilled)
        if best is None:
            break
        _, node_type, residual = best
        nodes_to_add[node_type] = nodes_to_add.get(node_type, 0) + 1
        allocated[node_type] = allocated.get(node_type, 0) + 1
        if strict_spread:
            # Each strict-spread bundle got its own node; one node per pass.
            continue
    return nodes_to_add, residual


def _add_min_workers_nodes(node_resources: List[ResourceDict],
                           node_type_counts: Dict[NodeType, int],
                           node_types: Dict[NodeType, dict],
                           max_workers: int,
                           head_node_type: NodeType,
                           ensure_min_cluster_size: Optional[List[ResourceDict]],
                           device=None,
                           ) -> Tuple[List[ResourceDict], Dict[NodeType, int],
                                      Dict[NodeType, int]]:
    """Fill per-type ``min_workers`` (reference :683)."""
    total_nodes_to_add: Dict[NodeType, int] = {}
    for node_type, spec in node_types.items():
        if node_type == head_node_type:
            continue
        target = min(spec.get("min_workers", 0),
                     spec.get("max_workers", 2 ** 30))
        have = node_type_counts.get(node_type, 0)
        if have < target:
            add = target - have
            total_nodes_to_add[node_type] = add
            node_type_counts[node_type] = target
            node_resources.extend(
                [dict(spec.get("resources", {}))] * add)
    # ensure_min_cluster_size: fit this demand against *static* cluster
    # shape, adding nodes if needed (request_resources()).
    if ensure_min_cluster_size:
        unfulfilled, _ = get_bin_pack_residual(
            node_resources, ensure_min_cluster_size, device=device)
        if unfulfilled:
            max_to_add = max_workers + 1 - sum(node_type_counts.values())
            extra, _ = get_nodes_for(node_types, node_type_counts,
                                     max_to_add, unfulfilled,
                                     device=device)
            for t, c in extra.items():
                total_nodes_to_add[t] = total_nodes_to_add.get(t, 0) + c
                node_type_counts[t] = node_type_counts.get(t, 0) + c
                node_resources.extend(
                    [dict(node_types[t].get("resources", {}))] * c)
    return node_resources, node_type_counts, total_nodes_to_add


def placement_groups_to_resource_demands(pending_placement_groups: List[dict]):
    """Flatten PG table data into plain demands + strict-spread bundle
    lists (reference :977). A pending PG dict: ``{"strategy": str,
    "bundles": [{resources...}, ...]}``."""
    resource_demand_vector: List[ResourceDict] = []
    unconverted: List[List[ResourceDict]] = []
    for pg in pending_placement_groups:
        strategy = pg.get("strategy", "PACK")
        bundles = [dict(b) for b in pg.get("bundles", []) if b]
        if strategy in ("PACK", "SPREAD"):
            # Soft constraints: treat as plain demands.
            resource_demand_vector.extend(bundles)
        elif strategy == "STRICT_PACK":
            # Must fit on one node: merge into a single demand.
            combined: ResourceDict = {}
            for b in bundles:
                for k, v in b.items():
                    combined[k] = combined.get(k, 0) + v
            if combined:
                resource_demand_vector.append(combined)
        elif strategy == "STRICT_SPREAD":
            unconverted.append(bundles)
    return resource_demand_vector, unconverted


class ResourceDemandScheduler:
    """``device`` is where the pack-mode solves run: the card unless the
    caller passes ``"cpu"``, resolved here (so construction raises
    without a card)."""

    def __init__(self, node_types: Dict[NodeType, dict],
                 max_workers: int, head_node_type: NodeType = "head",
                 upscaling_speed: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.node_types = copy.deepcopy(node_types)
        self.max_workers = max_workers
        self.head_node_type = head_node_type
        self.upscaling_speed = upscaling_speed

    def get_nodes_to_launch(
            self,
            node_type_counts: Dict[NodeType, int],
            launching_nodes: Dict[NodeType, int],
            resource_demands: List[ResourceDict],
            unused_resources_by_node: Dict[str, ResourceDict],
            pending_placement_groups: Optional[List[dict]] = None,
            node_type_by_node: Optional[Dict[str, NodeType]] = None,
            ensure_min_cluster_size: Optional[List[ResourceDict]] = None,
    ) -> Tuple[Dict[NodeType, int], List[ResourceDict]]:
        """Returns ({node_type: count_to_launch}, unfulfilled_demands)."""
        pending_placement_groups = pending_placement_groups or []
        # (1) Current usable resources: live nodes' *available* resources
        # plus full resources of nodes still launching.
        node_resources: List[ResourceDict] = \
            [dict(r) for r in unused_resources_by_node.values()]
        counts = dict(node_type_counts)
        for node_type, cnt in launching_nodes.items():
            counts[node_type] = counts.get(node_type, 0) + cnt
            node_resources.extend(
                [dict(self.node_types[node_type].get("resources", {}))] * cnt)

        # (2) min_workers fill.
        node_resources, counts, min_workers_to_add = _add_min_workers_nodes(
            node_resources, counts, self.node_types, self.max_workers,
            self.head_node_type, ensure_min_cluster_size, self.device)

        # (3) placement groups.
        pg_demands, strict_spreads = placement_groups_to_resource_demands(
            pending_placement_groups)
        demands = pg_demands + list(resource_demands)

        spread_to_add: Dict[NodeType, int] = {}
        for bundles in strict_spreads:
            # Reserve distinct nodes; launch for what doesn't fit.
            unfulfilled, node_resources = get_bin_pack_residual(
                node_resources, bundles, strict_spread=True,
                device=self.device)
            if unfulfilled:
                max_to_add = self.max_workers + 1 - sum(counts.values())
                to_add, _ = get_nodes_for(self.node_types, counts, max_to_add,
                                          unfulfilled, strict_spread=True,
                                          device=self.device)
                for t, c in to_add.items():
                    spread_to_add[t] = spread_to_add.get(t, 0) + c
                    counts[t] = counts.get(t, 0) + c

        # (4) residual demand after packing onto current+launching nodes.
        unfulfilled, _ = get_bin_pack_residual(node_resources, demands,
                                               device=self.device)

        # (5) node types for the residual.
        max_to_add = self.max_workers + 1 - sum(counts.values())
        demand_to_add, final_unfulfilled = get_nodes_for(
            self.node_types, counts, max_to_add, unfulfilled,
            device=self.device)

        total: Dict[NodeType, int] = {}
        for part in (min_workers_to_add, spread_to_add, demand_to_add):
            for t, c in part.items():
                total[t] = total.get(t, 0) + c
        total = self._apply_upscaling_limit(total, node_type_counts,
                                            launching_nodes)
        return total, final_unfulfilled

    def _apply_upscaling_limit(self, to_launch: Dict[NodeType, int],
                               existing: Dict[NodeType, int],
                               launching: Dict[NodeType, int]):
        """Clamp per-type launches to ``upscaling_speed * max(current, 5)``
        (reference ``_get_nodes_to_launch`` upscaling limit)."""
        limited: Dict[NodeType, int] = {}
        for t, c in to_launch.items():
            current = existing.get(t, 0) + launching.get(t, 0)
            limit = max(5, int(self.upscaling_speed * max(current, 1)))
            limited[t] = min(c, limit)
        return {t: c for t, c in limited.items() if c > 0}


def pack_with_jax_kernel(node_resources: List[ResourceDict],
                         resource_demands: List[ResourceDict], device=None):
    """Batched variant: dedup demands into classes and solve all classes
    against all nodes in ONE device call.  The name is the reference's,
    which callers look for; here it runs the port's solve
    (``torch_backend.BatchSolver.solve_matrices`` in pack mode, the
    class-fill kernel on the card) — the same solve
    ``get_bin_pack_residual`` routes through.  Kept for callers that
    want the raw alloc[C, N]; returns (unfulfilled, alloc)."""
    _, runs, demand, counts, avail = _pack_mode_matrices(
        node_resources, resource_demands)
    return _pack_mode_solve(runs, demand, counts, avail, device)
