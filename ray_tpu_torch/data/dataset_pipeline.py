"""DatasetPipeline: windowed, pipelined dataset execution.

A copy of ``ray_tpu.data.dataset_pipeline`` for the PyTorch port
(reference ``python/ray/data/dataset_pipeline.py`` +
``impl/pipeline_executor.py``): a pipeline is a sequence of dataset
windows flowing through per-window transform stages; ``repeat`` loops
the source for multi-epoch training ingest.  ``to_torch`` takes the
place of the reference's ``to_jax`` (ROADMAP C.26).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from ray_tpu_torch.data.dataset import Dataset


class DatasetPipeline:
    def __init__(self, windows: List[Dataset],
                 stages: Optional[List[Callable[[Dataset], Dataset]]] = None,
                 generator: Optional[Callable[[], Iterator[Dataset]]] = None):
        self._windows = windows
        self._stages = stages or []
        self._generator = generator

    @classmethod
    def from_repeat(cls, ds: Dataset, times: Optional[int]):
        def gen():
            i = 0
            while times is None or i < times:
                yield ds
                i += 1
        return cls([], generator=gen)

    def _source(self) -> Iterator[Dataset]:
        if self._generator is not None:
            return self._generator()
        return iter(self._windows)

    def _execute(self) -> Iterator[Dataset]:
        for window in self._source():
            for stage in self._stages:
                window = stage(window)
            yield window

    # ---- stage builders (lazy, applied per window) ----------------------
    def _with_stage(self, stage) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._stages + [stage],
                               self._generator)

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.filter(fn, **kw))

    def flat_map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.flat_map(fn, **kw))

    def random_shuffle_each_window(self, **kw) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.random_shuffle(**kw))

    def repartition_each_window(self, n: int) -> "DatasetPipeline":
        return self._with_stage(lambda ds: ds.repartition(n))

    # ---- consumption -----------------------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        for ds in self._execute():
            yield from ds.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for ds in self._execute():
            yield from ds.iter_batches(**kw)

    def iter_datasets(self) -> Iterator[Dataset]:
        return self._execute()

    def iter_epochs(self) -> Iterator[Dataset]:
        return self._execute()

    def to_torch(self, **kw) -> Iterator[Any]:
        for ds in self._execute():
            yield from ds.to_torch(**kw)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self._execute())

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Split each window across n consumers (for distributed ingest).

        The pipeline executes ONCE: a shared coordinator runs each window
        (with its stages) a single time and hands shard i of every window
        to consumer i — so nondeterministic stages (e.g. unseeded
        shuffles) still give consumers disjoint, complete coverage.
        """
        coordinator = _SplitCoordinator(self, n)
        pipes = []
        for i in range(n):
            def gen(i=i):
                idx = 0
                while True:
                    shard = coordinator.get_shard(idx, i)
                    if shard is None:
                        return
                    yield shard
                    idx += 1
            pipes.append(DatasetPipeline([], generator=gen))
        return pipes


class _SplitCoordinator:
    """Executes each pipeline window once and caches its n splits until
    every consumer has taken its shard."""

    def __init__(self, pipe: "DatasetPipeline", n: int):
        import threading
        self._n = n
        self._lock = threading.Lock()
        self._source = pipe._execute()
        self._cache: dict = {}   # window idx -> (splits, remaining_count)
        self._next_idx = 0
        self._exhausted = False
        self._consumed = [0] * n  # next expected window per consumer

    def get_shard(self, window_idx: int, consumer: int):
        with self._lock:
            if window_idx != self._consumed[consumer]:
                raise RuntimeError(
                    "A split() pipeline shard can be iterated only once: "
                    f"consumer {consumer} already took window "
                    f"{self._consumed[consumer] - 1}; re-splitting requires "
                    "rebuilding the pipeline.")
            self._consumed[consumer] += 1
            while window_idx >= self._next_idx and not self._exhausted:
                try:
                    ds = next(self._source)
                except StopIteration:
                    self._exhausted = True
                    break
                self._cache[self._next_idx] = [ds.split(self._n), self._n]
                self._next_idx += 1
            entry = self._cache.get(window_idx)
            if entry is None:
                return None
            splits, remaining = entry
            shard = splits[consumer]
            entry[1] -= 1
            if entry[1] == 0:
                del self._cache[window_idx]
            return shard
