"""Push-based shuffle: two-stage map -> merge -> reduce, and
``RandomAccessDataset``.

A copy of ``ray_tpu.data.impl.push_shuffle`` for the PyTorch port
(reference ``python/ray/data/impl/fast_repartition.py`` and the
push-based shuffle execution mode, Exoshuffle): instead of every reducer
consuming one output from EVERY map task (M x N intermediate objects,
N-ary reduces over M args), map outputs are merged in groups of
``merge_factor`` as they appear — reducers then consume M/F merged
shards.  Intermediate object count and per-reduce fan-in drop by F.
The toggle is the reference's ``RAY_TPU_PUSH_BASED_SHUFFLE``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockBuilder


@ray_tpu_torch.remote(num_cpus=1)
def _merge_shards(*shards: Block) -> Block:
    builder = BlockBuilder()
    for s in shards:
        builder.add_block(s)
    return builder.build()


def push_based_enabled(explicit: Optional[bool]) -> bool:
    """Per-call override > env toggle (reference:
    RAY_DATASET_PUSH_BASED_SHUFFLE)."""
    if explicit is not None:
        return explicit
    return os.environ.get("RAY_TPU_PUSH_BASED_SHUFFLE", "") in (
        "1", "true", "TRUE")


def shuffle(blocks: List, n_out: int,
            map_remote_fn, map_args: Callable[[int], tuple],
            reduce_remote_fn, reduce_args: Callable[[int], tuple],
            merge_factor: int = 4):
    """Generic two-stage shuffle plumbing.

    ``map_remote_fn.options(num_returns=n_out).remote(block, *map_args(i))``
    must yield ``n_out`` shards per input block;
    ``reduce_remote_fn.remote(*reduce_args(j), *shards_j)`` (num_returns=2:
    block + metadata) combines partition j.  Merge tasks run between the
    stages so each reduce sees ceil(M / merge_factor) inputs.
    """
    m = len(blocks)
    maps = [map_remote_fn.options(num_returns=n_out).remote(
        b, *map_args(i)) for i, b in enumerate(blocks)]
    if n_out == 1:
        maps = [[s] for s in maps]
    # Merge stage: group map outputs; one merge task per (group, j).
    groups = [maps[g:g + merge_factor]
              for g in range(0, m, merge_factor)]
    merged_cols: List[List] = []     # [group][j] -> merged shard
    for group in groups:
        if len(group) == 1:
            merged_cols.append([group[0][j] for j in range(n_out)])
        else:
            merged_cols.append([
                _merge_shards.remote(*[mp[j] for mp in group])
                for j in range(n_out)])
    pairs = [reduce_remote_fn.remote(
        *reduce_args(j), *[col[j] for col in merged_cols])
        for j in range(n_out)]
    return pairs


class RandomAccessDataset:
    """Serve point lookups over a sorted dataset from a fleet of
    actors (reference ``python/ray/data/random_access_dataset.py``):
    blocks are range-partitioned by the sort key across ``num_workers``
    actors; ``get`` routes the key to its partition's actor, which
    binary-searches its resident blocks."""

    def __init__(self, blocks: List, boundaries: List, key: str,
                 num_workers: int):
        import numpy as np
        self._key = key
        # Round-robin blocks onto workers, keeping range order so a
        # key maps to exactly one (worker, block).
        assignments: List[List[int]] = [[] for _ in range(num_workers)]
        for i in range(len(blocks)):
            assignments[i % num_workers].append(i)
        self._block_to_worker = {}
        self._workers = []
        for idxs in assignments:
            if not idxs:
                continue
            actor = _RandomAccessWorker.remote(
                {i: blocks[i] for i in idxs}, key)
            self._workers.append(actor)
            for i in idxs:
                self._block_to_worker[i] = actor
        self._boundaries = np.asarray(boundaries)

    def _block_index(self, key_value) -> int:
        import numpy as np
        # side="left": boundary b_i is block i's LAST key, so a key
        # EQUAL to it still belongs to block i.
        return int(np.searchsorted(self._boundaries, key_value,
                                   side="left"))

    def get_async(self, key_value):
        """ObjectRef resolving to the matching row dict, or None."""
        if not self._block_to_worker:
            return ray_tpu_torch.put(None)     # empty dataset
        idx = min(self._block_index(key_value),
                  len(self._block_to_worker) - 1)
        return self._block_to_worker[idx].get.remote(idx, key_value)

    def multiget(self, key_values: List):
        return ray_tpu_torch.get([self.get_async(k) for k in key_values])

    def stats(self) -> dict:
        return {"num_workers": len(self._workers),
                "num_blocks": len(self._block_to_worker)}


@ray_tpu_torch.remote(num_cpus=1)
def _last_key(block: Block, key: str):
    """Last sort-key of a block (boundary builder) — ships one scalar
    back instead of the whole block; None for empty blocks."""
    col = _key_column(block, key)
    return col[-1] if len(col) else None


def _key_column(block: Block, key: str):
    """Sorted key column of a block, for columnar AND row blocks."""
    import numpy as np
    acc = BlockAccessor(block)
    try:
        col = np.asarray(acc.to_numpy(column=key))
        if col.dtype != object:
            return col
    except Exception:
        pass
    return np.asarray([row[key] for row in acc.iter_rows()])


@ray_tpu_torch.remote(num_cpus=1)
class _RandomAccessWorker:
    def __init__(self, block_refs: dict, key: str):
        # Refs nested in a container arg are not auto-resolved (core
        # API semantics); materialize this partition's blocks here,
        # keyed by their GLOBAL block index.
        self._key = key
        idxs = sorted(block_refs)
        blocks = ray_tpu_torch.get([block_refs[i] for i in idxs])
        self._blocks = dict(zip(idxs, blocks))
        self._key_cols = {i: _key_column(b, key)
                          for i, b in self._blocks.items()}

    def get(self, block_idx: int, key_value):
        import numpy as np
        block = self._blocks.get(block_idx)
        if block is None:
            return None
        col = self._key_cols[block_idx]
        pos = int(np.searchsorted(col, key_value))
        if pos < len(col) and col[pos] == key_value:
            acc = BlockAccessor(block)
            rows = list(BlockAccessor(
                acc.slice(pos, pos + 1)).iter_rows())
            return rows[0] if rows else None
        return None
