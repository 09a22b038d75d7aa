"""Read API: create Datasets from memory and files.

A copy of ``ray_tpu.data.read_api`` for the PyTorch port (reference
``python/ray/data/read_api.py``): ``range``/``range_table``,
``from_items``/``from_numpy``/``from_pandas``/``from_arrow``,
``read_csv``/``read_json``/``read_parquet``/``read_numpy``/
``read_text``/``read_binary_files``; reads fan out one task per file.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, BlockBuilder, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset


def _expand_paths(paths: Union[str, List[str]]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in sorted(os.walk(p)):
                dirs.sort()
                out.extend(sorted(
                    os.path.join(root, f) for f in files
                    if not f.startswith(".")))
        else:
            out.append(p)
    return out


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    blocks, meta = [], []
    for i in builtins.range(parallelism):
        lo = n * i // parallelism
        hi = n * (i + 1) // parallelism
        arr = np.arange(lo, hi, dtype=np.int64)
        blocks.append(ray_tpu_torch.put(list(arr)))
        meta.append(BlockMetadata(hi - lo, (hi - lo) * 8, int))
    return Dataset(blocks, meta)


def range_table(n: int, *, parallelism: int = 8) -> Dataset:
    parallelism = max(1, min(parallelism, n or 1))
    blocks, meta = [], []
    for i in builtins.range(parallelism):
        lo = n * i // parallelism
        hi = n * (i + 1) // parallelism
        block = {"value": np.arange(lo, hi, dtype=np.int64)}
        blocks.append(ray_tpu_torch.put(block))
        meta.append(BlockAccessor(block).get_metadata())
    return Dataset(blocks, meta)


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    parallelism = max(1, min(parallelism, len(items) or 1))
    blocks, meta = [], []
    for i in builtins.range(parallelism):
        lo = len(items) * i // parallelism
        hi = len(items) * (i + 1) // parallelism
        builder = BlockBuilder()
        for item in items[lo:hi]:
            builder.add(item)
        block = builder.build()
        blocks.append(ray_tpu_torch.put(block))
        meta.append(BlockAccessor(block).get_metadata())
    return Dataset(blocks, meta)


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]],
               column: str = "value") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    blocks, meta = [], []
    for arr in arrays:
        block = {column: np.asarray(arr)}
        blocks.append(ray_tpu_torch.put(block))
        meta.append(BlockAccessor(block).get_metadata())
    return Dataset(blocks, meta)


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    blocks, meta = [], []
    for df in dfs:
        block = {c: df[c].to_numpy() for c in df.columns}
        blocks.append(ray_tpu_torch.put(block))
        meta.append(BlockAccessor(block).get_metadata())
    return Dataset(blocks, meta)


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    blocks, meta = [], []
    for t in tables:
        block = {c: t[c].to_numpy(zero_copy_only=False)
                 for c in t.column_names}
        blocks.append(ray_tpu_torch.put(block))
        meta.append(BlockAccessor(block).get_metadata())
    return Dataset(blocks, meta)


def _read_files(paths, reader) -> Dataset:
    files = _expand_paths(paths)

    @ray_tpu_torch.remote(num_cpus=1, num_returns=2)
    def read_one(path: str):
        block = reader(path)
        m = BlockAccessor(block).get_metadata(input_files=[path])
        return block, m
    pairs = [read_one.remote(f) for f in files]
    blocks = [p[0] for p in pairs]
    meta = ray_tpu_torch.get([p[1] for p in pairs])
    return Dataset(blocks, meta)


def read_csv(paths, **pd_kwargs) -> Dataset:
    def reader(path):
        from ray_tpu_torch.data.block import _PANDAS_LOCK, _pd
        with _PANDAS_LOCK:
            df = _pd().read_csv(path, **pd_kwargs)
            return {c: df[c].to_numpy() for c in df.columns}
    return _read_files(paths, reader)


def read_json(paths, **pd_kwargs) -> Dataset:
    def reader(path):
        from ray_tpu_torch.data.block import _PANDAS_LOCK, _pd
        with _PANDAS_LOCK:
            df = _pd().read_json(path, orient="records", lines=True,
                                 **pd_kwargs)
            return {c: df[c].to_numpy() for c in df.columns}
    return _read_files(paths, reader)


def read_parquet(paths, columns: Optional[List[str]] = None) -> Dataset:
    def reader(path):
        # Isolated-subprocess read; still parallel across files (one
        # child per file task). See block.parquet_read.
        from ray_tpu_torch.data.block import parquet_read
        return parquet_read(path, columns)
    return _read_files(paths, reader)


def read_numpy(paths) -> Dataset:
    def reader(path):
        return {"value": np.load(path)}
    return _read_files(paths, reader)


def read_text(paths, *, encoding: str = "utf-8") -> Dataset:
    def reader(path):
        with open(path, encoding=encoding) as f:
            return [line.rstrip("\n") for line in f]
    return _read_files(paths, reader)


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    def reader(path):
        with open(path, "rb") as f:
            data = f.read()
        return [(path, data)] if include_paths else [data]
    return _read_files(paths, reader)
