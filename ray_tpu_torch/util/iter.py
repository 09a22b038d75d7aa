"""ParallelIterator: sharded iterators over actors.

A copy of ``ray_tpu.util.iter`` for the PyTorch port (reference
``python/ray/util/iter.py``): ``from_items``,
``from_range``, ``from_iterators``, ``from_actors``;
``ParallelIterator.for_each/filter/batch/flatten/combine/
batch_across_shards/gather_sync/gather_async/take/show/union/
num_shards/shards``; ``LocalIterator`` with the same transforms.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

T = TypeVar("T")
U = TypeVar("U")


class _ParallelIteratorWorker:
    """Actor hosting one shard (reference iter.py ParallelIteratorWorker)."""

    def __init__(self, item_generator, repeat: bool = False):
        self._gen = item_generator
        self._repeat = repeat
        self._it = None
        self._transforms: List[Callable[[Iterator], Iterator]] = []

    def add_transform(self, fn) -> None:
        self._transforms.append(fn)

    def _base_iterator(self) -> Iterator:
        while True:
            if callable(self._gen):
                it = self._gen()
            else:
                it = iter(self._gen)
            for item in it:
                yield item
            if not self._repeat:
                return

    def start(self) -> None:
        it = self._base_iterator()
        for t in self._transforms:
            it = t(it)
        self._it = it

    def par_iter_next(self):
        if self._it is None:
            self.start()
        return next(self._it)

    def par_iter_slice(self, step: int, start: int):
        """Next item of an interleaved slice (for multiple consumers)."""
        if self._it is None:
            self.start()
        return next(itertools.islice(self._it, start, start + 1))


# The actor class over a plain module attribute, so that its export
# pickles the class by reference.
ParallelIteratorWorker = ray_tpu_torch.remote(_ParallelIteratorWorker)


class ParallelIterator:
    """A parallel iterator over ``num_shards`` actor-hosted shards."""

    def __init__(self, actors: List[Any], parent_iterators=None,
                 name: str = "ParallelIterator"):
        self.actors = actors
        self.name = name

    def __repr__(self):
        return f"{self.name}[{len(self.actors)} shards]"

    def num_shards(self) -> int:
        return len(self.actors)

    def shards(self) -> List["LocalIterator"]:
        return [_shard_iterator(a) for a in self.actors]

    # ---- transforms (applied remotely, lazily per shard) ----------------
    def _with_transform(self, make_transform, name_suffix: str):
        ray_tpu_torch.get([a.add_transform.remote(make_transform)
                     for a in self.actors])
        self.name += name_suffix
        return self

    def for_each(self, fn: Callable[[T], U]) -> "ParallelIterator":
        return self._with_transform(
            lambda it, fn=fn: map(fn, it), f".for_each({fn})")

    def filter(self, fn: Callable[[T], bool]) -> "ParallelIterator":
        return self._with_transform(
            lambda it, fn=fn: (x for x in it if fn(x)), f".filter({fn})")

    def batch(self, n: int) -> "ParallelIterator":
        def batcher(it, n=n):
            batch = []
            for x in it:
                batch.append(x)
                if len(batch) >= n:
                    yield batch
                    batch = []
            if batch:
                yield batch
        return self._with_transform(batcher, f".batch({n})")

    def flatten(self) -> "ParallelIterator":
        return self._with_transform(
            lambda it: (x for sub in it for x in sub), ".flatten()")

    def combine(self, fn: Callable[[T], Iterable[U]]) -> "ParallelIterator":
        return self.for_each(fn).flatten()

    # ---- gathering ------------------------------------------------------
    def gather_sync(self) -> "LocalIterator":
        """Round-robin over shards, one item per shard per cycle."""
        def gen():
            alive = list(self.actors)
            while alive:
                nxt = []
                for a in alive:
                    try:
                        yield ray_tpu_torch.get(a.par_iter_next.remote())
                        nxt.append(a)
                    except StopIteration:
                        pass
                alive = nxt
        return LocalIterator(gen, name=self.name + ".gather_sync()")

    def gather_async(self, num_async: int = 1) -> "LocalIterator":
        """Yield items as shards produce them (reference gather_async)."""
        def gen():
            inflight = {}
            for a in self.actors:
                for _ in range(num_async):
                    inflight[a.par_iter_next.remote()] = a
            while inflight:
                ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1)
                ref = ready[0]
                actor = inflight.pop(ref)
                try:
                    yield ray_tpu_torch.get(ref)
                except StopIteration:
                    continue
                inflight[actor.par_iter_next.remote()] = actor
        return LocalIterator(gen, name=self.name + ".gather_async()")

    def batch_across_shards(self) -> "LocalIterator":
        """One list per cycle containing one item from every shard."""
        def gen():
            while True:
                refs = [a.par_iter_next.remote() for a in self.actors]
                try:
                    yield ray_tpu_torch.get(refs)
                except StopIteration:
                    return
        return LocalIterator(gen,
                             name=self.name + ".batch_across_shards()")

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(self.actors + other.actors,
                                name=f"{self.name}.union({other.name})")

    # ---- consumption helpers -------------------------------------------
    def take(self, n: int) -> List[T]:
        return self.gather_sync().take(n)

    def show(self, n: int = 20) -> None:
        for item in self.take(n):
            print(item)

    def __iter__(self):
        return iter(self.gather_sync())


def _shard_iterator(actor) -> "LocalIterator":
    def gen():
        while True:
            try:
                yield ray_tpu_torch.get(actor.par_iter_next.remote())
            except StopIteration:
                return
    return LocalIterator(gen, name="shard")


class LocalIterator:
    """A local, lazily-evaluated iterator with the same transform API."""

    def __init__(self, base_gen: Callable[[], Iterator],
                 name: str = "LocalIterator"):
        self._base_gen = base_gen
        self.name = name

    def __iter__(self):
        return self._base_gen()

    def __next__(self):
        if not hasattr(self, "_it"):
            self._it = self._base_gen()
        return next(self._it)

    def for_each(self, fn) -> "LocalIterator":
        base = self._base_gen
        return LocalIterator(lambda: map(fn, base()),
                             name=self.name + f".for_each({fn})")

    def filter(self, fn) -> "LocalIterator":
        base = self._base_gen
        return LocalIterator(lambda: (x for x in base() if fn(x)),
                             name=self.name + f".filter({fn})")

    def batch(self, n: int) -> "LocalIterator":
        base = self._base_gen

        def gen():
            batch = []
            for x in base():
                batch.append(x)
                if len(batch) >= n:
                    yield batch
                    batch = []
            if batch:
                yield batch
        return LocalIterator(gen, name=self.name + f".batch({n})")

    def flatten(self) -> "LocalIterator":
        base = self._base_gen
        return LocalIterator(lambda: (x for sub in base() for x in sub),
                             name=self.name + ".flatten()")

    def combine(self, fn) -> "LocalIterator":
        return self.for_each(fn).flatten()

    def zip_with_source_actor(self):
        raise NotImplementedError("zip_with_source_actor: driver-side only")

    def take(self, n: int) -> List[Any]:
        return list(itertools.islice(iter(self), n))

    def show(self, n: int = 20) -> None:
        for item in self.take(n):
            print(item)

    def union(self, other: "LocalIterator") -> "LocalIterator":
        a, b = self._base_gen, other._base_gen

        def gen():
            its = [a(), b()]
            q = collections.deque(its)
            while q:
                it = q.popleft()
                try:
                    yield next(it)
                    q.append(it)
                except StopIteration:
                    pass
        return LocalIterator(gen, name=f"{self.name}.union({other.name})")


# ---- constructors -------------------------------------------------------

def from_iterators(generators: List[Any], repeat: bool = False,
                   name=None) -> ParallelIterator:
    actors = [ParallelIteratorWorker.remote(g, repeat) for g in generators]
    return ParallelIterator(
        actors, name=name or f"from_iterators[shards={len(generators)}]")


def from_items(items: List[T], num_shards: int = 2,
               repeat: bool = False) -> ParallelIterator:
    shards: List[List[T]] = [[] for _ in range(num_shards)]
    for i, item in enumerate(items):
        shards[i % num_shards].append(item)
    return from_iterators(shards, repeat,
                          name=f"from_items[{len(items)} items, "
                               f"{num_shards} shards]")


def from_range(n: int, num_shards: int = 2,
               repeat: bool = False) -> ParallelIterator:
    gens = []
    for i in range(num_shards):
        start = i * (n // num_shards)
        end = (i + 1) * (n // num_shards) if i < num_shards - 1 else n
        gens.append(range(start, end))
    return from_iterators(gens, repeat,
                          name=f"from_range[{n}, {num_shards} shards]")


def from_actors(actors: List[Any], name=None) -> ParallelIterator:
    """Wrap existing ParallelIteratorWorker-compatible actors."""
    return ParallelIterator(actors, name=name or "from_actors")
