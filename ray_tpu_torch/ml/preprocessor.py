"""Preprocessors: fit on a Dataset, transform Datasets and batches.

A copy of ``ray_tpu.ml.preprocessor`` for the PyTorch port (reference
``python/ray/ml/preprocessor.py`` + ``preprocessors/``: StandardScaler,
MinMaxScaler, BatchMapper, Chain): ``fit`` computes aggregate statistics
with Dataset ops, ``transform`` maps blocks in parallel,
``transform_batch`` serves the same logic at inference time.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, dataset) -> "Preprocessor":
        self._fit(dataset)
        self._fitted = True
        return self

    def transform(self, dataset):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return dataset.map_batches(self.transform_batch)

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        raise NotImplementedError

    def _fit(self, dataset):
        pass

    def _needs_fit(self) -> bool:
        return True


class StandardScaler(Preprocessor):
    """(x - mean) / std per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats: Dict[str, tuple] = {}

    def _fit(self, dataset):
        for col in self.columns:
            mean = dataset.mean(col)
            std = dataset.std(col)
            self.stats[col] = (mean, std if std else 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for col in self.columns:
            mean, std = self.stats[col]
            out[col] = (np.asarray(batch[col], dtype=np.float64) -
                        mean) / std
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats: Dict[str, tuple] = {}

    def _fit(self, dataset):
        for col in self.columns:
            lo = dataset.min(col)
            hi = dataset.max(col)
            self.stats[col] = (lo, (hi - lo) or 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for col in self.columns:
            lo, span = self.stats[col]
            out[col] = (np.asarray(batch[col], dtype=np.float64) -
                        lo) / span
        return out


class BatchMapper(Preprocessor):
    """Stateless user-function preprocessor."""

    def __init__(self, fn: Callable[[Dict], Dict]):
        self.fn = fn

    def transform_batch(self, batch):
        return self.fn(batch)

    def _needs_fit(self) -> bool:
        return False


class Chain(Preprocessor):
    """Sequential composition; fit runs left to right, each stage
    fitting on the previous stage's output."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def fit(self, dataset) -> "Chain":
        for stage in self.stages:
            dataset = stage.fit(dataset).transform(dataset)
        self._fitted = True
        return self

    def transform_batch(self, batch):
        for stage in self.stages:
            batch = stage.transform_batch(batch)
        return batch

    def _needs_fit(self) -> bool:
        return any(s._needs_fit() for s in self.stages)
