"""Resource model — columnar (struct-of-arrays) from the ground up.

A copy of ``ray_tpu.scheduler.resources`` for the PyTorch port, with a
plain ``threading.RLock`` in place of the lock-order witness.

Parity targets: reference ``src/ray/raylet/scheduling/cluster_resource_data.h``
(``NodeResources`` = {total, available} FixedPoint vectors of predefined
resources + custom map, ``ResourceRequest`` same shape) and ``fixed_point.h``
(resource math on 1/10000 granularity).

TPU-first deviation: instead of per-node hash maps, the cluster view is a
dense ``[N, R]`` matrix (numpy on the control path, shipped to the TPU kernel
as-is each tick).  That makes `GetBestSchedulableNode` a vector op and the
batched bin-pack a single device call — this layout *is* the scheduler's
device ABI (SURVEY.md §3.4: demand[C,R] x avail[N,R]).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Fixed-point granularity, matching reference fixed_point.h (1/10000).
FP_SCALE = 10_000

# Predefined resource columns (reference: cluster_resource_data.h predefined
# CPU/MEM/GPU/object-store-mem; we add TPU as a first-class accelerator).
CPU, MEMORY, TPU, GPU, OBJECT_STORE_MEMORY = range(5)
PREDEFINED = ["CPU", "memory", "TPU", "GPU", "object_store_memory"]
_PREDEFINED_INDEX = {name: i for i, name in enumerate(PREDEFINED)}
NUM_PREDEFINED = len(PREDEFINED)
# Accelerator columns avoided for tasks that don't need them
# (reference scheduler_avoid_gpu_nodes, ray_config_def.h:533).
ACCELERATOR_COLUMNS = (TPU, GPU)


def _quantize(value: float) -> int:
    return int(round(float(value) * FP_SCALE))


def accelerator_node_mask(total: np.ndarray) -> np.ndarray:
    """[N] bool mask of nodes carrying any accelerator column — the
    shared input of the greedy policy's avoid-accel penalty and the
    kernel's accel-avoid bucket (one definition, three schedulers)."""
    mask = np.zeros(total.shape[0], dtype=bool)
    for c in ACCELERATOR_COLUMNS:
        if c < total.shape[1]:
            mask |= total[:, c] > 0
    return mask


class ResourceRequest:
    """A task/bundle resource demand as a quantized sparse vector."""

    __slots__ = ("_items", "_key")

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        items: Dict[str, int] = {}
        for name, amount in (resources or {}).items():
            q = _quantize(amount)
            if q < 0:
                raise ValueError(f"Negative resource {name}={amount}")
            if q > 0:
                items[name] = q
        self._items = items
        self._key: Tuple = tuple(sorted(items.items()))

    @property
    def key(self) -> Tuple:
        return self._key

    def is_empty(self) -> bool:
        return not self._items

    def get(self, name: str) -> float:
        return self._items.get(name, 0) / FP_SCALE

    def names(self) -> Iterable[str]:
        return self._items.keys()

    def to_dict(self) -> Dict[str, float]:
        return {k: v / FP_SCALE for k, v in self._items.items()}

    def quantized(self) -> Dict[str, int]:
        return dict(self._items)

    def uses_accelerator(self) -> bool:
        return any(self._items.get(PREDEFINED[c], 0) > 0
                   for c in ACCELERATOR_COLUMNS)

    def __eq__(self, other):
        return isinstance(other, ResourceRequest) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"ResourceRequest({self.to_dict()})"


class NodeResources:
    """One node's {total, available} resource vectors (quantized)."""

    __slots__ = ("total", "available", "labels", "draining")

    def __init__(self, total: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None):
        self.total: Dict[str, int] = {k: _quantize(v) for k, v in total.items()
                                      if _quantize(v) > 0}
        self.available: Dict[str, int] = dict(self.total)
        self.labels = labels or {}
        self.draining = False

    def is_feasible(self, req: ResourceRequest) -> bool:
        return all(self.total.get(k, 0) >= v for k, v in req.quantized().items())

    def is_available(self, req: ResourceRequest) -> bool:
        return all(self.available.get(k, 0) >= v
                   for k, v in req.quantized().items())

    def allocate(self, req: ResourceRequest) -> bool:
        if not self.is_available(req):
            return False
        for k, v in req.quantized().items():
            self.available[k] -= v
        return True

    def release(self, req: ResourceRequest):
        for k, v in req.quantized().items():
            self.available[k] = min(self.total.get(k, 0),
                                    self.available.get(k, 0) + v)

    def copy(self) -> "NodeResources":
        """Value copy.  A NodeResources is a mutable accounting ledger
        (allocate/release), so two views must never share one instance:
        a holder that overwrites ``available`` from a snapshot (e.g. a
        usage-report merge) would erase the other's in-flight
        allocations."""
        nr = NodeResources.__new__(NodeResources)
        nr.total = dict(self.total)
        nr.available = dict(self.available)
        nr.labels = dict(self.labels)
        nr.draining = self.draining
        return nr

    def to_float_dict(self, which: str = "available") -> Dict[str, float]:
        src = self.available if which == "available" else self.total
        return {k: v / FP_SCALE for k, v in src.items()}


class ClusterResourceView:
    """Dense columnar view of all nodes' resources.

    Reference: ``ClusterResourceManager`` holds a NodeID->NodeResources map
    (``cluster_resource_manager.h``); here the authoritative copies stay in
    ``NodeResources`` (exact, quantized) and this view maintains the dense
    float32 ``total``/``avail`` matrices incrementally so every scheduling
    tick — native numpy or TPU — reads the same [N, R] buffers without
    re-packing.  Local views may be briefly stale between broadcasts
    (cluster_resource_data.h:221-227); the dispatch path re-validates with
    the exact per-node vectors before commit, mirroring spillback.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._node_ids: List = []
        self._node_index: Dict = {}
        self._nodes: Dict = {}          # node_id -> NodeResources
        self._columns: Dict[str, int] = dict(_PREDEFINED_INDEX)
        self._total = np.zeros((0, NUM_PREDEFINED), dtype=np.float32)
        self._avail = np.zeros((0, NUM_PREDEFINED), dtype=np.float32)
        self.version = 0  # bumped on structural change (nodes/columns)
        # Row indices whose availability changed since the last
        # drain_dirty() — the delta feed for the device-resident solver.
        self._dirty: set = set()
        # SUSPECT mask (suspect-before-dead failure detection): masked
        # nodes read as zero-available in every scheduling snapshot —
        # no NEW placements — while the authoritative ledgers underneath
        # stay intact, so clearing the mask restores real availability
        # instantly.  Mask flips dirty the affected rows so the
        # device-resident solver's delta feed tracks them too.
        self._masked: set = set()

    # ---- column management ---------------------------------------------
    def _column(self, name: str) -> int:
        idx = self._columns.get(name)
        if idx is None:
            idx = len(self._columns)
            self._columns[name] = idx
            pad = np.zeros((self._total.shape[0], 1), dtype=np.float32)
            self._total = np.concatenate([self._total, pad], axis=1)
            self._avail = np.concatenate([self._avail, pad.copy()], axis=1)
            self.version += 1
        return idx

    @property
    def columns(self) -> Dict[str, int]:
        return self._columns

    @property
    def lock(self) -> threading.RLock:
        """The view's lock, for a holder that changes a row's ledger and
        rebuilds the row as one step (the raylet's bundle commit)."""
        return self._lock

    # ---- node membership ------------------------------------------------
    @staticmethod
    def _snapshot(resources: NodeResources):
        """Copy ``(total, available)`` off a possibly LIVE ledger.

        Raylets hand the view their actual ``NodeResources`` and keep
        mutating it from other threads (PG bundle commit/cancel adds
        and removes formatted resource keys), so iterating — or even
        ``dict()``-copying — the live dicts can die with "dictionary
        changed size during iteration".  The view's own lock cannot
        guard a foreign object; retry the copy until it lands between
        mutations (the window is a few microseconds).
        """
        for _ in range(1000):
            try:
                return dict(resources.total), dict(resources.available)
            except RuntimeError:
                continue
        return dict(resources.total), dict(resources.available)

    def add_node(self, node_id, resources: NodeResources):
        with self._lock:
            if node_id in self._node_index:
                self.update_node(node_id, resources)
                return
            total, avail = self._snapshot(resources)
            for name in total:
                self._column(name)
            row_t = np.zeros((1, len(self._columns)), dtype=np.float32)
            row_a = np.zeros((1, len(self._columns)), dtype=np.float32)
            for name, v in total.items():
                row_t[0, self._columns[name]] = v / FP_SCALE
            for name, v in avail.items():
                row_a[0, self._columns[name]] = v / FP_SCALE
            self._node_index[node_id] = len(self._node_ids)
            self._node_ids.append(node_id)
            self._nodes[node_id] = resources
            self._total = np.concatenate([self._total, row_t], axis=0)
            self._avail = np.concatenate([self._avail, row_a], axis=0)
            self.version += 1

    def remove_node(self, node_id):
        with self._lock:
            idx = self._node_index.pop(node_id, None)
            if idx is None:
                return
            self._node_ids.pop(idx)
            self._nodes.pop(node_id, None)
            self._total = np.delete(self._total, idx, axis=0)
            self._avail = np.delete(self._avail, idx, axis=0)
            for nid, i in list(self._node_index.items()):
                if i > idx:
                    self._node_index[nid] = i - 1
            # Remap dirty row indices past the removed row (stale indices
            # would make drain_dirty read out of bounds).
            self._dirty = {i - 1 if i > idx else i
                           for i in self._dirty if i != idx}
            self.version += 1

    def update_node(self, node_id, resources: NodeResources):
        with self._lock:
            idx = self._node_index.get(node_id)
            if idx is None:
                self.add_node(node_id, resources)
                return
            self._nodes[node_id] = resources
            total, avail = self._snapshot(resources)
            for name in total:
                self._column(name)
            self._total[idx, :] = 0.0
            self._avail[idx, :] = 0.0
            for name, v in total.items():
                self._total[idx, self._columns[name]] = v / FP_SCALE
            for name, v in avail.items():
                self._avail[idx, self._columns[name]] = v / FP_SCALE
            # Totals changed: structural for the device mirror.
            self.version += 1

    def update_available(self, node_id, available: Dict[str, float]):
        """Apply a resource-usage broadcast for one node."""
        with self._lock:
            idx = self._node_index.get(node_id)
            if idx is None:
                return
            node = self._nodes[node_id]
            node.available = {k: _quantize(v) for k, v in available.items()}
            self._avail[idx, :] = 0.0
            for name, v in available.items():
                if name in self._columns:
                    self._avail[idx, self._columns[name]] = v
            self._dirty.add(idx)

    # ---- scheduling-side mutation (dirty local view) --------------------
    def subtract(self, node_id, req: ResourceRequest) -> bool:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.allocate(req):
                return False
            idx = self._node_index[node_id]
            for name, v in req.quantized().items():
                self._avail[idx, self._columns[name]] -= v / FP_SCALE
            self._dirty.add(idx)
            return True

    def add_back(self, node_id, req: ResourceRequest):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            node.release(req)
            idx = self._node_index[node_id]
            for name, v in req.quantized().items():
                col = self._columns[name]
                self._avail[idx, col] = min(
                    self._total[idx, col],
                    self._avail[idx, col] + v / FP_SCALE)
            self._dirty.add(idx)

    # ---- suspect masking ------------------------------------------------
    def set_masked(self, node_ids) -> None:
        """Replace the suspect mask.  Affected rows (newly masked OR
        newly cleared) are dirtied so both the snapshot consumers and
        the device-resident delta feed converge on the new mask."""
        with self._lock:
            new = set(node_ids)
            for nid in new ^ self._masked:
                idx = self._node_index.get(nid)
                if idx is not None:
                    self._dirty.add(idx)
            self._masked = new

    def masked_nodes(self) -> set:
        with self._lock:
            return set(self._masked)

    def _masked_zero(self, avail_copy: np.ndarray) -> np.ndarray:
        """Zero masked rows in an avail COPY (callers own the copy; the
        authoritative matrix is never touched)."""
        for nid in self._masked:
            idx = self._node_index.get(nid)
            if idx is not None:
                avail_copy[idx, :] = 0.0
        return avail_copy

    # ---- dense snapshot (the device ABI) --------------------------------
    def snapshot(self):
        """Return (node_ids, total[N,R], avail[N,R], columns) — the exact
        matrices the TPU kernel consumes.  Masked (suspect) rows read
        zero-available."""
        with self._lock:
            return (list(self._node_ids), self._total.copy(),
                    self._masked_zero(self._avail.copy()),
                    dict(self._columns))

    def snapshot_versioned(self):
        """snapshot() plus the structural version, read atomically —
        the full-upload path of the device-resident solver."""
        with self._lock:
            return (self.version, list(self._node_ids), self._total.copy(),
                    self._masked_zero(self._avail.copy()),
                    dict(self._columns))

    def drain_dirty(self):
        """Atomically take (version, dirty row indices, their current
        avail rows) and clear the dirty set.  Rows re-dirtied by
        concurrent mutations after this call are picked up next drain —
        values are always read fresh, so deltas never go backwards.
        Masked (suspect) rows ship as zero, like the snapshots."""
        with self._lock:
            if not self._dirty:
                return self.version, [], None
            idx = sorted(self._dirty)
            self._dirty.clear()
            rows = self._avail[idx, :].copy()
            if self._masked:
                masked_idx = {self._node_index.get(nid)
                              for nid in self._masked}
                for j, i in enumerate(idx):
                    if i in masked_idx:
                        rows[j, :] = 0.0
            return self.version, idx, rows

    def num_columns(self) -> int:
        with self._lock:
            return len(self._columns)

    def demand_matrix(self, requests: List[ResourceRequest]) -> np.ndarray:
        """Pack demands into [C, R] aligned with this view's columns,
        after adding a column for each name the view lacks (ROADMAP C.10:
        the reference sizes the matrix before it adds them, and raises
        ``IndexError`` on a new name)."""
        with self._lock:
            for req in requests:
                for name in req.names():
                    self._column(name)
            mat = np.zeros((len(requests), len(self._columns)),
                           dtype=np.float32)
            for i, req in enumerate(requests):
                for name, v in req.quantized().items():
                    mat[i, self._columns[name]] = v / FP_SCALE
            return mat

    # ---- queries --------------------------------------------------------
    def node_resources(self, node_id) -> Optional[NodeResources]:
        with self._lock:
            return self._nodes.get(node_id)

    def node_ids(self) -> List:
        with self._lock:
            return list(self._node_ids)

    def num_nodes(self) -> int:
        with self._lock:
            return len(self._node_ids)

    def is_feasible_anywhere(self, req: ResourceRequest) -> bool:
        with self._lock:
            return any(n.is_feasible(req) for n in self._nodes.values())

    def total_cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._nodes.values():
                for k, v in n.total.items():
                    out[k] = out.get(k, 0.0) + v / FP_SCALE
            return out

    def available_cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._nodes.values():
                for k, v in n.available.items():
                    out[k] = out.get(k, 0.0) + v / FP_SCALE
            return out
