"""``multiprocessing.Pool`` adapter backed by the port's actors.

A copy of ``ray_tpu.util.multiprocessing`` for the PyTorch port, over
its ``ActorPool``.

Parity: reference ``python/ray/util/multiprocessing/`` — a drop-in
``Pool`` whose "processes" are actors, so existing multiprocessing code
scales across the cluster unchanged:

    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool(4) as pool:
        squares = pool.map(square, range(100))
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


class _PoolWorkerBody:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(*args) for args in chunk]


_PoolWorker = ray_tpu_torch.remote(_PoolWorkerBody)


def _concat(*batches):
    return [v for b in batches for v in b]


_gather = ray_tpu_torch.remote(_concat)


class AsyncResult:
    """``multiprocessing.pool.AsyncResult`` surface over an ObjectRef."""

    def __init__(self, ref, unpack: Optional[Callable] = None):
        self._ref = ref
        self._unpack = unpack

    def get(self, timeout: Optional[float] = None) -> Any:
        value = ray_tpu_torch.get(self._ref, timeout=timeout)
        return self._unpack(value) if self._unpack else value

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait([self._ref], num_returns=1, timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return bool(ready)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if processes is None:
            import os
            processes = os.cpu_count() or 1
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._actors = [_PoolWorker.remote(initializer, initargs)
                        for _ in range(processes)]
        self._pool = ActorPool(list(self._actors))
        self._rr = itertools.cycle(self._actors)
        self._closed = False

    # ---- apply ---------------------------------------------------------
    def apply(self, fn: Callable, args: tuple = (),
              kwds: Optional[dict] = None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check_open()
        actor = next(self._rr)
        return AsyncResult(actor.run.remote(fn, args, kwds))

    # ---- map -----------------------------------------------------------
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = [(x,) for x in iterable]
        return self._star_chunks(items, chunksize)

    def _star_chunks(self, items: List[tuple],
                     chunksize: Optional[int]) -> List[List[tuple]]:
        if chunksize is None:
            chunksize = max(1, len(items) // (4 * len(self._actors)) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        chunks = self._chunks(iterable, chunksize)
        refs = [next(self._rr).run_batch.remote(fn, c) for c in chunks]
        return AsyncResult(_gather.remote(*refs))

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List:
        self._check_open()
        chunks = self._star_chunks(list(iterable), chunksize)
        refs = [next(self._rr).run_batch.remote(fn, c) for c in chunks]
        return [v for b in ray_tpu_torch.get(refs) for v in b]

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        self._check_open()
        for chunk in self._chunks(iterable, chunksize):
            for v in ray_tpu_torch.get(
                    next(self._rr).run_batch.remote(fn, chunk)):
                yield v

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        self._check_open()
        chunks = self._chunks(iterable, chunksize)
        for chunk in chunks:
            self._pool.submit(
                lambda actor, c: actor.run_batch.remote(fn, c), chunk)
        while self._pool.has_next():
            for v in self._pool.get_next_unordered():
                yield v

    # ---- lifecycle -----------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for actor in self._actors:
            ray_tpu_torch.kill(actor)
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool.join() requires close() first")
        self._actors = []

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.terminate()
