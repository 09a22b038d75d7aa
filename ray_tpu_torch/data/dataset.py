"""Dataset: distributed data on the object store.

A copy of ``ray_tpu.data.dataset`` for the PyTorch port (reference
``python/ray/data/dataset.py``): a Dataset is a list of
``ObjectRef[Block]`` + per-block metadata; transforms run as tasks or
actor-pool calls (``impl/compute.py``); ``repartition``/
``random_shuffle``/``sort`` do distributed all-to-all moves;
consumption via ``iter_rows``/``iter_batches``/``split``/``to_*``;
``window``/``repeat`` produce a
:class:`~ray_tpu_torch.data.dataset_pipeline.DatasetPipeline`.

Blocks are columnar numpy tables; ``iter_batches`` can pad to a fixed
``batch_size`` (static shapes), and ``to_torch(device=...)`` puts padded
batches on a device, where the reference's ``to_jax`` device-puts them
(ROADMAP C.26).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockBuilder,
                                      BlockMetadata, is_table)
from ray_tpu_torch.data.impl.compute import get_compute

T = Any


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _merge_blocks(*blocks: Block):
    builder = BlockBuilder()
    for b in blocks:
        builder.add_block(b)
    out = builder.build()
    return out, BlockAccessor(out).get_metadata()


@ray_tpu_torch.remote(num_cpus=1)
def _split_block(block: Block, n: int):
    """n output shards; invoked with num_returns=n (bare block if n==1)."""
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    bounds = [rows * i // n for i in range(n + 1)]
    parts = [acc.slice(bounds[i], bounds[i + 1]) for i in range(n)]
    return parts[0] if n == 1 else parts


@ray_tpu_torch.remote(num_cpus=1)
def _shuffle_map(block: Block, n: int, seed: Optional[int], idx: int):
    """n output shards; invoked with num_returns=n (bare block if n==1)."""
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(None if seed is None else seed + idx)
    perm = rng.permutation(rows)
    bounds = [rows * i // n for i in range(n + 1)]
    parts = [acc.take_indices(perm[bounds[i]:bounds[i + 1]])
             for i in range(n)]
    return parts[0] if n == 1 else parts


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _shuffle_reduce(seed: Optional[int], idx: int, *shards: Block):
    builder = BlockBuilder()
    for s in shards:
        builder.add_block(s)
    merged = builder.build()
    acc = BlockAccessor(merged)
    rng = np.random.default_rng(None if seed is None else seed * 31 + idx)
    out = acc.take_indices(rng.permutation(acc.num_rows()))
    return out, BlockAccessor(out).get_metadata()


def _sort_key_fn(key) -> Callable[[Any], Any]:
    if key is None:
        return lambda r: r
    if isinstance(key, str):
        return lambda r: r[key]
    return key


@ray_tpu_torch.remote(num_cpus=1)
def _sort_sample(block: Block, key) -> List[Any]:
    acc = BlockAccessor(block)
    kf = _sort_key_fn(key)
    rows = list(acc.iter_rows())
    n = max(1, len(rows) // 20)
    rng = np.random.default_rng(0)
    picks = rng.choice(len(rows), size=min(n, len(rows)), replace=False) \
        if rows else []
    return sorted(kf(rows[int(i)]) for i in picks)


@ray_tpu_torch.remote(num_cpus=1)
def _sort_map(block: Block, key, boundaries: List[Any], descending: bool
              ) -> List[Block]:
    import bisect
    acc = BlockAccessor(block)
    kf = _sort_key_fn(key)
    rows = sorted(acc.iter_rows(), key=kf, reverse=descending)
    parts: List[List[Any]] = [[] for _ in range(len(boundaries) + 1)]
    for r in rows:
        i = bisect.bisect_right(boundaries, kf(r))
        if descending:
            i = len(boundaries) - i
        parts[i].append(r)
    out = []
    for p in parts:
        b = BlockBuilder()
        for r in p:
            b.add(r)
        out.append(b.build())
    return out[0] if len(out) == 1 else out


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _sort_reduce(key, descending: bool, *shards: Block):
    builder = BlockBuilder()
    for s in shards:
        builder.add_block(s)
    merged = builder.build()
    acc = BlockAccessor(merged)
    kf = _sort_key_fn(key)
    rows = sorted(acc.iter_rows(), key=kf, reverse=descending)
    b = BlockBuilder()
    for r in rows:
        b.add(r)
    out = b.build()
    return out, BlockAccessor(out).get_metadata()


@ray_tpu_torch.remote(num_cpus=1)
def _groupby_map(block: Block, key, n: int):
    """n hash partitions; invoked with num_returns=n (bare if n==1)."""
    acc = BlockAccessor(block)
    kf = _sort_key_fn(key)
    parts: List[BlockBuilder] = [BlockBuilder() for _ in range(n)]
    for r in acc.iter_rows():
        parts[hash(kf(r)) % n].add(r)
    built = [p.build() for p in parts]
    return built[0] if n == 1 else built


def _gather_groups(key, shards):
    """shards -> {group_key: rows}, iterated in a stable order (shared
    by every groupby reduce)."""
    groups: Dict[Any, List[Any]] = {}
    kf = _sort_key_fn(key)
    for s in shards:
        for r in BlockAccessor(s).iter_rows():
            groups.setdefault(kf(r), []).append(r)
    for k in sorted(groups.keys(), key=lambda x: (str(type(x)), x)):
        yield k, groups[k]


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _map_groups_reduce(key, fn, *shards: Block):
    """User-function reduce over each hash partition's groups."""
    out = BlockBuilder()
    for _k, rows in _gather_groups(key, shards):
        result = fn(rows)
        if isinstance(result, list):
            for row in result:
                out.add(row)
        else:
            out.add(result)
    block = out.build()
    return block, BlockAccessor(block).get_metadata()


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _groupby_reduce(key, agg_name: str, on, *shards: Block):
    out = BlockBuilder()
    for k, rows in _gather_groups(key, shards):
        if on is not None:
            vals = [r[on] for r in rows]
        else:
            vals = rows
        if agg_name == "count":
            v = len(rows)
        elif agg_name == "sum":
            v = sum(vals)
        elif agg_name == "min":
            v = min(vals)
        elif agg_name == "max":
            v = max(vals)
        elif agg_name == "mean":
            v = sum(vals) / len(vals)
        else:
            raise ValueError(agg_name)
        out.add({(key if isinstance(key, str) else "key"): k,
                 f"{agg_name}({on})" if on else agg_name: v})
    built = out.build()
    return built, BlockAccessor(built).get_metadata()


class Dataset:
    def __init__(self, blocks: List, metadata: Optional[List[BlockMetadata]]
                 = None, metadata_refs: Optional[List] = None):
        """``metadata_refs`` keeps metadata as pending ObjectRefs so
        constructing a Dataset never blocks on upstream tasks — stages
        stay pipelineable; refs resolve lazily on first metadata use."""
        self._blocks = list(blocks)
        self._meta_cache = list(metadata) if metadata is not None else None
        if self._meta_cache is None and metadata_refs is not None:
            self._meta_refs = list(metadata_refs)
        elif self._meta_cache is None:
            self._meta_refs = [_meta_of.remote(b) for b in self._blocks]
        else:
            self._meta_refs = None

    @property
    def _metadata(self) -> List[BlockMetadata]:
        if self._meta_cache is None:
            self._meta_cache = ray_tpu_torch.get(self._meta_refs)
            self._meta_refs = None
        return self._meta_cache

    # ---- transforms ------------------------------------------------------
    def _transform(self, fn, compute=None, **remote_args) -> "Dataset":
        strategy = get_compute(compute)
        refs, meta_refs = strategy.apply(
            fn, self._blocks,
            remote_args=remote_args or None)
        return Dataset(refs, metadata_refs=meta_refs)

    def map(self, fn: Callable[[T], T], *, compute=None, **remote_args
            ) -> "Dataset":
        def _map_block(block: Block) -> Block:
            builder = BlockBuilder()
            for row in BlockAccessor(block).iter_rows():
                builder.add(fn(row))
            return builder.build()
        return self._transform(_map_block, compute, **remote_args)

    def flat_map(self, fn: Callable[[T], List[T]], *, compute=None,
                 **remote_args) -> "Dataset":
        def _flat(block: Block) -> Block:
            builder = BlockBuilder()
            for row in BlockAccessor(block).iter_rows():
                for out in fn(row):
                    builder.add(out)
            return builder.build()
        return self._transform(_flat, compute, **remote_args)

    def filter(self, fn: Callable[[T], bool], *, compute=None, **remote_args
               ) -> "Dataset":
        def _filter(block: Block) -> Block:
            builder = BlockBuilder()
            for row in BlockAccessor(block).iter_rows():
                if fn(row):
                    builder.add(row)
            return builder.build()
        return self._transform(_filter, compute, **remote_args)

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    compute=None, batch_format: str = "native",
                    **remote_args) -> "Dataset":
        def _batches(block: Block) -> Block:
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            size = batch_size or rows or 1
            builder = BlockBuilder()
            for start in range(0, rows, size):
                piece = BlockAccessor(acc.slice(start,
                                                min(start + size, rows)))
                if batch_format == "pandas":
                    batch = piece.to_pandas()
                elif batch_format == "numpy":
                    batch = piece.to_numpy()
                else:
                    batch = piece.to_block()
                out = fn(batch)
                builder.add_block(BlockAccessor.batch_to_block(out))
            return builder.build()
        return self._transform(_batches, compute, **remote_args)

    # ---- shuffles --------------------------------------------------------
    # Map tasks return one ref PER OUTPUT SHARD (num_returns=n) so reduce
    # tasks consume shard refs directly — the all-to-all never moves
    # through the driver (reference impl/shuffle.py two-phase pattern).
    def repartition(self, num_blocks: int, *,
                    push_based: Optional[bool] = None) -> "Dataset":
        from ray_tpu_torch.data.impl import push_shuffle
        n = num_blocks
        if push_shuffle.push_based_enabled(push_based) and \
                len(self._blocks) > 1:
            pairs = push_shuffle.shuffle(
                self._blocks, n,
                _split_block, lambda i: (n,),
                _merge_blocks, lambda j: ())
            return Dataset([p[0] for p in pairs],
                           metadata_refs=[p[1] for p in pairs])
        splits = [_split_block.options(num_returns=n).remote(b, n)
                  for b in self._blocks]
        if n == 1:
            splits = [[s] for s in splits]
        pairs = [_merge_blocks.remote(*[s[j] for s in splits])
                 for j in range(n)]
        return Dataset([p[0] for p in pairs],
                       metadata_refs=[p[1] for p in pairs])

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None,
                       push_based: Optional[bool] = None) -> "Dataset":
        from ray_tpu_torch.data.impl import push_shuffle
        n = num_blocks or max(1, len(self._blocks))
        if push_shuffle.push_based_enabled(push_based) and \
                len(self._blocks) > 1:
            # Two-stage push-based shuffle (fast_repartition.py /
            # Exoshuffle parity): merge map outputs in groups so wide
            # shuffles stay inside the object-store envelope.
            pairs = push_shuffle.shuffle(
                self._blocks, n,
                _shuffle_map, lambda i: (n, seed, i),
                _shuffle_reduce, lambda j: (seed, j))
            return Dataset([p[0] for p in pairs],
                           metadata_refs=[p[1] for p in pairs])
        maps = [_shuffle_map.options(num_returns=n).remote(b, n, seed, i)
                for i, b in enumerate(self._blocks)]
        if n == 1:
            maps = [[m] for m in maps]
        pairs = [_shuffle_reduce.remote(seed, j, *[m[j] for m in maps])
                 for j in range(n)]
        return Dataset([p[0] for p in pairs],
                       metadata_refs=[p[1] for p in pairs])

    def to_random_access_dataset(self, key: str, *,
                                 num_workers: int = 2):
        """Sort by ``key`` and serve point lookups from a fleet of
        block-holding actors (reference random_access_dataset.py)."""
        from ray_tpu_torch.data.impl.push_shuffle import (
            RandomAccessDataset, _last_key)
        ds = self.sort(key)
        # One tiny remote task per block returns just its last key
        # (never the block bytes), fetched in one batched get.  Empty
        # blocks (skewed sort partitions) are dropped — boundary index
        # i must mean "block i's upper bound".
        lasts = ray_tpu_torch.get([_last_key.remote(b, key)
                                   for b in ds._blocks])
        kept = [(b, last) for b, last in zip(ds._blocks, lasts)
                if last is not None]
        boundaries = [last for _b, last in kept[:-1]]
        return RandomAccessDataset([b for b, _l in kept], boundaries,
                                   key, num_workers)

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        if not self._blocks:
            return self
        n = len(self._blocks)
        samples = sorted(itertools.chain.from_iterable(
            ray_tpu_torch.get([_sort_sample.remote(b, key)
                               for b in self._blocks])))
        if not samples:
            return self
        boundaries = [samples[len(samples) * i // n] for i in range(1, n)]
        maps = [_sort_map.options(num_returns=n).remote(
            b, key, boundaries, descending) for b in self._blocks]
        if n == 1:
            maps = [[m] for m in maps]
        pairs = [_sort_reduce.remote(key, descending, *[m[j] for m in maps])
                 for j in range(n)]
        return Dataset([p[0] for p in pairs],
                       metadata_refs=[p[1] for p in pairs])

    def groupby(self, key) -> "GroupedDataset":
        return GroupedDataset(self, key)

    # ---- combining -------------------------------------------------------
    def union(self, *others: "Dataset") -> "Dataset":
        blocks = list(self._blocks)
        meta = list(self._metadata)
        for o in others:
            blocks.extend(o._blocks)
            meta.extend(o._metadata)
        return Dataset(blocks, meta)

    def zip(self, other: "Dataset") -> "Dataset":
        pairs = [_zip_blocks.remote(a, b)
                 for a, b in zip(self._blocks, other._blocks)]
        return Dataset([p[0] for p in pairs],
                       metadata_refs=[p[1] for p in pairs])

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["Dataset"]:
        if equal:
            # Row-exact split: global row bounds total*i//n mapped onto
            # per-block slices (reference _split_at_indices).
            total = self.count()
            bounds = [total * i // n for i in range(n + 1)]
            starts = [0]
            for m in self._metadata:
                starts.append(starts[-1] + m.num_rows)
            shards: List[List] = [[] for _ in range(n)]
            for bi, (b, m) in enumerate(zip(self._blocks, self._metadata)):
                blo, bhi = starts[bi], starts[bi + 1]
                for s in range(n):
                    lo, hi = max(blo, bounds[s]), min(bhi, bounds[s + 1])
                    if lo >= hi:
                        continue
                    if lo == blo and hi == bhi:
                        shards[s].append((b, m))
                    else:
                        shards[s].append((
                            _slice_range.remote(b, lo - blo, hi - blo),
                            None))
            out = []
            for s in range(n):
                blocks = [b for b, _ in shards[s]]
                metas = [m for _, m in shards[s]]
                if all(m is not None for m in metas):
                    out.append(Dataset(blocks, metas))
                else:
                    out.append(Dataset(blocks))
            return out
        out = []
        for i in range(n):
            blocks = self._blocks[i::n]
            meta = self._metadata[i::n]
            out.append(Dataset(blocks, meta))
        return out

    def limit(self, limit: int) -> "Dataset":
        taken, blocks = 0, []
        for b, m in zip(self._blocks, self._metadata):
            if taken >= limit:
                break
            if taken + m.num_rows <= limit:
                blocks.append(b)
                taken += m.num_rows
            else:
                keep = limit - taken
                blocks.append(_slice_head.remote(b, keep))
                taken = limit
        return Dataset(blocks)

    # ---- consumption -----------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        for b in self._blocks:
            yield from BlockAccessor(ray_tpu_torch.get(b)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = None,
                     batch_format: str = "native",
                     drop_last: bool = False,
                     pad_to_batch: bool = False) -> Iterator[Any]:
        """``pad_to_batch`` repeats the final rows so every batch has the
        same static shape — jit-friendly (TPU recompile avoidance)."""
        carry: Optional[Block] = None
        for b in self._blocks:
            block = ray_tpu_torch.get(b)
            if carry is not None:
                builder = BlockBuilder()
                builder.add_block(carry)
                builder.add_block(block)
                block = builder.build()
                carry = None
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            size = batch_size or rows or 1
            full = (rows // size) * size
            for start in range(0, full, size):
                yield self._format_batch(acc.slice(start, start + size),
                                         batch_format)
            if full < rows:
                carry = acc.slice(full, rows)
        if carry is not None and not drop_last:
            acc = BlockAccessor(carry)
            if pad_to_batch and batch_size:
                rows = acc.num_rows()
                idx = np.resize(np.arange(rows), batch_size)
                acc = BlockAccessor(acc.take_indices(idx))
            yield self._format_batch(acc.to_block(), batch_format)

    @staticmethod
    def _format_batch(block: Block, batch_format: str):
        acc = BlockAccessor(block)
        if batch_format == "pandas":
            return acc.to_pandas()
        if batch_format == "numpy":
            return acc.to_numpy()
        return block

    def to_torch(self, *, batch_size: Optional[int] = None,
                 columns: Optional[List[str]] = None,
                 label_column: Optional[str] = None,
                 device=None, sharding=None) -> Iterator[Any]:
        """Batches as tensors.  Without ``device``, the reference's
        ``to_torch`` (``ray_tpu/data/dataset.py:514-522``): CPU tensors
        over numpy's buffers, the tail batch as it comes.  With
        ``device`` given, the reference's ``to_jax`` (``:485-512``): the
        tail batch padded to ``batch_size`` (static shapes) and every
        batch put on ``device``.  ``columns`` picks the feature columns
        (default: all but ``label_column``), and ``label_column`` is kept
        beside them, as ``to_jax`` does; with neither, every column
        (ROADMAP C.26).  ``sharding`` has no counterpart on one card and
        raises (the sharded solve, A.7)."""
        import torch
        if sharding is not None:
            raise NotImplementedError(
                "to_torch(sharding=...): the port runs on one card; "
                "sharded batches wait for ROADMAP A.7")
        dev = None if device is None else torch.device(device)

        def tensor(v):
            return torch.as_tensor(np.ascontiguousarray(v), device=dev)

        for batch in self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                pad_to_batch=dev is not None and batch_size is not None):
            if isinstance(batch, dict):
                if columns:
                    feats = {c: batch[c] for c in columns}
                else:
                    feats = {k: v for k, v in batch.items()
                             if k != label_column}
                out = {k: tensor(v) for k, v in feats.items()}
                if label_column:
                    out[label_column] = tensor(batch[label_column])
                yield out
            else:
                yield tensor(batch)

    def to_pandas(self):
        import pandas as pd
        dfs = [BlockAccessor(ray_tpu_torch.get(b)).to_pandas()
               for b in self._blocks]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_numpy(self, column: Optional[str] = None):
        parts = [BlockAccessor(ray_tpu_torch.get(b)).to_numpy(column)
                 for b in self._blocks]
        if parts and isinstance(parts[0], dict):
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        return np.concatenate(parts) if parts else np.array([])

    def take(self, limit: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def show(self, limit: int = 20):
        for row in self.take(limit):
            print(row)

    # ---- aggregates ------------------------------------------------------
    def count(self) -> int:
        return sum(m.num_rows for m in self._metadata)

    def _column_agg(self, on, np_fn, py_fn):
        @ray_tpu_torch.remote(num_cpus=1)
        def agg(block: Block):
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                return None
            if is_table(block):
                col = block[on] if on else next(iter(block.values()))
                return np_fn(col)
            vals = [r[on] for r in acc.iter_rows()] if on \
                else list(acc.iter_rows())
            return py_fn(vals)
        vals = [v for v in ray_tpu_torch.get(
            [agg.remote(b) for b in self._blocks]) if v is not None]
        return vals

    def sum(self, on: Optional[str] = None):
        return sum(self._column_agg(on, np.sum, sum))

    def min(self, on: Optional[str] = None):
        return min(self._column_agg(on, np.min, min))

    def max(self, on: Optional[str] = None):
        return max(self._column_agg(on, np.max, max))

    def mean(self, on: Optional[str] = None):
        total = self.sum(on)
        return total / self.count()

    def std(self, on: Optional[str] = None):
        arr = self.to_numpy(on)
        if isinstance(arr, dict):
            arr = next(iter(arr.values()))
        return float(np.std(arr, ddof=1))

    # ---- introspection ---------------------------------------------------
    def num_blocks(self) -> int:
        return len(self._blocks)

    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self._metadata)

    def schema(self):
        for m in self._metadata:
            if m.num_rows:
                return m.schema
        return None

    def input_files(self) -> List[str]:
        files = []
        for m in self._metadata:
            if m.input_files:
                files.extend(m.input_files)
        return files

    def get_internal_block_refs(self) -> List:
        return list(self._blocks)

    def __repr__(self):
        return (f"Dataset(num_blocks={self.num_blocks()}, "
                f"num_rows={self.count()}, schema={self.schema()})")

    # ---- pipelining ------------------------------------------------------
    def window(self, *, blocks_per_window: int = 10):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        windows = []
        for i in range(0, len(self._blocks), blocks_per_window):
            windows.append(Dataset(self._blocks[i:i + blocks_per_window],
                                   self._metadata[i:i + blocks_per_window]))
        return DatasetPipeline(windows)

    def repeat(self, times: Optional[int] = None):
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
        return DatasetPipeline.from_repeat(self, times)

    # ---- writes ----------------------------------------------------------
    def write_csv(self, path: str):
        self._write(path, "csv")

    def write_json(self, path: str):
        self._write(path, "json")

    def write_parquet(self, path: str):
        self._write(path, "parquet")

    def write_numpy(self, path: str, column: str = "value"):
        import os
        os.makedirs(path, exist_ok=True)
        for i, b in enumerate(self._blocks):
            arr = BlockAccessor(ray_tpu_torch.get(b)).to_numpy(column)
            np.save(os.path.join(path, f"block_{i:05d}.npy"), arr)

    def _write(self, path: str, fmt: str):
        import os
        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote(num_cpus=1)
        def write_one(block: Block, out: str):
            from ray_tpu_torch.data.block import _PANDAS_LOCK
            if fmt == "parquet":
                # Isolated-subprocess write (see block.parquet_write).
                from ray_tpu_torch.data.block import parquet_write
                acc = BlockAccessor(block)
                cols = block if is_table(block) else \
                    BlockAccessor.batch_to_block(acc.to_pandas())
                parquet_write(cols, out)
                return out
            df = BlockAccessor(block).to_pandas()
            # Serialize: to_csv/to_json build arrow string arrays, which
            # are not construction-thread-safe (see block._PANDAS_LOCK).
            with _PANDAS_LOCK:
                if fmt == "csv":
                    df.to_csv(out, index=False)
                else:
                    df.to_json(out, orient="records", lines=True)
            return out
        ray_tpu_torch.get([
            write_one.remote(b, os.path.join(path, f"block_{i:05d}.{fmt}"))
            for i, b in enumerate(self._blocks)])


@ray_tpu_torch.remote(num_cpus=1)
def _meta_of(block: Block) -> BlockMetadata:
    return BlockAccessor(block).get_metadata()


@ray_tpu_torch.remote(num_cpus=1)
def _slice_head(block: Block, k: int) -> Block:
    return BlockAccessor(block).slice(0, k)


@ray_tpu_torch.remote(num_cpus=1)
def _slice_range(block: Block, lo: int, hi: int) -> Block:
    return BlockAccessor(block).slice(lo, hi)


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _zip_blocks(a: Block, b: Block):
    out = BlockBuilder()
    for ra, rb in zip(BlockAccessor(a).iter_rows(),
                      BlockAccessor(b).iter_rows()):
        if isinstance(ra, dict) and isinstance(rb, dict):
            merged = dict(ra)
            merged.update(rb)
            out.add(merged)
        else:
            out.add((ra, rb))
    built = out.build()
    return built, BlockAccessor(built).get_metadata()


class GroupedDataset:
    """Hash-partition groupby (reference ``grouped_dataset.py``)."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _hash_shuffle(self, reduce_remote_fn, *reduce_args) -> Dataset:
        """Hash-partition shuffle + per-partition reduce (shared by the
        aggregations and map_groups)."""
        n = max(1, self._ds.num_blocks())
        maps = [_groupby_map.options(num_returns=n).remote(b, self._key, n)
                for b in self._ds._blocks]
        if n == 1:
            maps = [[m] for m in maps]
        pairs = [reduce_remote_fn.remote(
            self._key, *reduce_args, *[m[j] for m in maps])
            for j in range(n)]
        return Dataset([p[0] for p in pairs],
                       metadata_refs=[p[1] for p in pairs])

    def _agg(self, name: str, on=None) -> Dataset:
        return self._hash_shuffle(_groupby_reduce, name, on)

    def map_groups(self, fn: Callable) -> Dataset:
        """Apply ``fn(rows) -> row | list[row]`` to every group
        (reference ``GroupedDataset.map_groups``)."""
        return self._hash_shuffle(_map_groups_reduce, fn)

    def count(self) -> Dataset:
        return self._agg("count")

    def sum(self, on=None) -> Dataset:
        return self._agg("sum", on)

    def min(self, on=None) -> Dataset:
        return self._agg("min", on)

    def max(self, on=None) -> Dataset:
        return self._agg("max", on)

    def mean(self, on=None) -> Dataset:
        return self._agg("mean", on)
