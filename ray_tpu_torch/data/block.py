"""Blocks: the distributed unit of a Dataset.

A copy of ``ray_tpu.data.block`` for the PyTorch port (reference
``python/ray/data/block.py`` + ``impl/arrow_block.py`` /
``impl/simple_block.py``): a Dataset is a list of ``ObjectRef[Block]``
and per-block ``BlockMetadata``; a ``BlockAccessor`` dispatches on block
type.

Blocks stay the reference's: a table is a **dict of numpy column
arrays**, a simple block a Python list of rows.  Arrow and pandas are
interop formats at the boundary (``to_arrow``/``to_pandas``/
``from_arrow``), imported only when a call needs them: a run that keeps
to numpy batches needs neither installed.  Parquet is read and written
in a ``sys.executable`` subprocess, as in the reference.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

# pandas 3.0's arrow-backed string arrays segfault under concurrent
# construction from multiple executor threads (pyarrow _from_sequence is
# not thread-safe); all DataFrame construction goes through this lock and
# string storage is pinned to the python backend.
_PANDAS_LOCK = threading.Lock()
_pandas_configured = False

# Parquet WRITES run in an isolated subprocess (below); parquet reads and
# csv/json IO run inside ordinary task threads under _PANDAS_LOCK where
# pandas is involved.

_PQ_WRITER_SCRIPT = """\
import pickle, sys
path, cols = pickle.load(sys.stdin.buffer)
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
table = pa.table({k: pa.array(np.asarray(v)) for k, v in cols.items()})
pq.write_table(table, path)
"""

_PQ_READER_SCRIPT = """\
import pickle, sys
path, columns = pickle.load(sys.stdin.buffer)
import pyarrow.parquet as pq
table = pq.read_table(path, columns=columns)
cols = {c: table[c].to_numpy(zero_copy_only=False)
        for c in table.column_names}
sys.stdout.buffer.write(pickle.dumps(cols))
"""


def _run_script(script: str, payload: bytes, what: str) -> bytes:
    """``script`` in a fresh ``python -c`` child fed ``payload``; its
    stdout, or a RuntimeError with the end of its stderr."""
    import subprocess
    proc = subprocess.run([sys.executable, "-c", script], input=payload,
                          capture_output=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"parquet {what} subprocess failed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[-500:]}")
    return proc.stdout


def parquet_read(path: str, columns=None) -> Dict[str, np.ndarray]:
    """Read a parquet file in a fresh isolated subprocess (pyarrow's
    parquet open/write paths crash intermittently inside a heavily
    threaded process)."""
    import pickle
    return pickle.loads(_run_script(
        _PQ_READER_SCRIPT, pickle.dumps((path, columns)), "reader"))


def parquet_write(cols: Dict[str, np.ndarray], path: str):
    """Write a columnar dict to parquet in a fresh isolated subprocess: a
    short-lived ``python -c`` child (not multiprocessing spawn) avoids
    re-importing the user's ``__main__`` and surfaces child crashes as
    errors instead of hanging."""
    import pickle
    _run_script(_PQ_WRITER_SCRIPT, pickle.dumps(
        (path, {k: np.asarray(v) for k, v in cols.items()})), "writer")
    return path


def _pd():
    global _pandas_configured
    import pandas as pd
    if not _pandas_configured:
        with _PANDAS_LOCK:
            try:
                pd.set_option("mode.string_storage", "python")
            except Exception:  # noqa: BLE001 — older pandas lacks it
                pass
            _pandas_configured = True
    return pd


# A block is either a list of rows, or a columnar table.
Block = Union[List[Any], Dict[str, np.ndarray]]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Any = None
    input_files: Optional[List[str]] = None


def is_table(block: Block) -> bool:
    return isinstance(block, dict)


class BlockAccessor:
    """Uniform view over simple (list) and table (columnar) blocks."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ---- shape -----------------------------------------------------------
    def num_rows(self) -> int:
        if is_table(self._b):
            if not self._b:
                return 0
            return len(next(iter(self._b.values())))
        return len(self._b)

    def size_bytes(self) -> int:
        if is_table(self._b):
            return int(sum(v.nbytes if isinstance(v, np.ndarray)
                           else sys.getsizeof(v) for v in self._b.values()))
        return int(sum(sys.getsizeof(r) for r in self._b))

    def schema(self):
        if is_table(self._b):
            return {k: str(v.dtype) for k, v in self._b.items()}
        for r in self._b:
            return type(r)
        return None

    def get_metadata(self, input_files=None) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(),
                             self.schema(), input_files)

    # ---- row access ------------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        if is_table(self._b):
            cols = list(self._b.items())
            for i in range(self.num_rows()):
                yield {k: v[i] for k, v in cols}
        else:
            yield from self._b

    def slice(self, start: int, end: int) -> Block:
        if is_table(self._b):
            return {k: v[start:end] for k, v in self._b.items()}
        return self._b[start:end]

    def take_indices(self, idx: np.ndarray) -> Block:
        if is_table(self._b):
            return {k: v[idx] for k, v in self._b.items()}
        return [self._b[int(i)] for i in idx]

    # ---- format conversion ----------------------------------------------
    def to_numpy(self, column: Optional[str] = None):
        if is_table(self._b):
            if column is not None:
                return self._b[column]
            return dict(self._b)
        return np.asarray(self._b)

    def to_pandas(self):
        pd = _pd()
        with _PANDAS_LOCK:
            if is_table(self._b):
                return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                                     for k, v in self._b.items()})
            rows = list(self._b)
            if rows and isinstance(rows[0], dict):
                return pd.DataFrame(rows)
            return pd.DataFrame({"value": rows})

    def to_arrow(self):
        import pyarrow as pa
        return pa.Table.from_pandas(self.to_pandas())

    def to_block(self) -> Block:
        return self._b

    # ---- builders --------------------------------------------------------
    @staticmethod
    def batch_to_block(batch) -> Block:
        """Normalize a user-returned batch to a block.  A dict or an
        ndarray needs neither pandas nor pyarrow; a DataFrame or an Arrow
        table is converted only where its package is installed (the
        reference imports pandas first on every call)."""
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return {"value": batch}
        pandas = sys.modules.get("pandas")
        if pandas is not None and isinstance(batch, pandas.DataFrame):
            _pd()
            return {c: batch[c].to_numpy() for c in batch.columns}
        pyarrow = sys.modules.get("pyarrow")
        if pyarrow is not None and isinstance(batch, pyarrow.Table):
            return {c: batch[c].to_numpy(zero_copy_only=False)
                    for c in batch.column_names}
        return list(batch)


class BlockBuilder:
    """Accumulates rows/blocks and emits one block of the majority format."""

    def __init__(self):
        self._rows: List[Any] = []
        self._tables: List[Dict[str, np.ndarray]] = []

    def add(self, row: Any):
        self._rows.append(row)

    def add_block(self, block: Block):
        if is_table(block):
            if BlockAccessor(block).num_rows() > 0:
                self._tables.append(block)
        else:
            self._rows.extend(block)

    def num_rows(self) -> int:
        return len(self._rows) + sum(BlockAccessor(t).num_rows()
                                     for t in self._tables)

    def build(self) -> Block:
        if self._tables and not self._rows:
            keys = list(self._tables[0].keys())
            if all(set(t.keys()) == set(keys) for t in self._tables):
                return {k: np.concatenate([t[k] for t in self._tables])
                        for k in keys}
            # Mismatched schemas (e.g. union of unrelated tables):
            # degrade to rows rather than KeyError or dropping columns.
            rows: List[Any] = []
            for t in self._tables:
                rows.extend(BlockAccessor(t).iter_rows())
            return rows
        if self._tables:
            # Mixed: degrade to rows.
            rows = list(self._rows)
            for t in self._tables:
                rows.extend(BlockAccessor(t).iter_rows())
            return rows
        # All dict rows with same keys -> columnar.
        if self._rows and all(isinstance(r, dict) for r in self._rows):
            keys = list(self._rows[0].keys())
            if all(list(r.keys()) == keys for r in self._rows):
                try:
                    return {k: np.asarray([r[k] for r in self._rows])
                            for k in keys}
                except Exception:  # noqa: BLE001 — ragged rows stay rows
                    return list(self._rows)
        return list(self._rows)
