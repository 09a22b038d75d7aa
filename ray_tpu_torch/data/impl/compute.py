"""Compute strategies: run a block transform via tasks or an actor pool.

A copy of ``ray_tpu.data.impl.compute`` for the PyTorch port (reference
``python/ray/data/impl/compute.py``): ``TaskPoolStrategy`` (one task per
block) and ``ActorPoolStrategy`` (a pool of stateful actors; used for
e.g. model inference where setup is expensive).
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor

BlockTransform = Callable[[Block], Block]


@ray_tpu_torch.remote(num_cpus=1, num_returns=2)
def _transform_block(fn: BlockTransform, block: Block):
    out = fn(block)
    return out, BlockAccessor(out).get_metadata()


class TaskPoolStrategy:
    def apply(self, fn: BlockTransform, blocks: List, *,
              remote_args: Optional[dict] = None
              ) -> Tuple[List, List]:
        """Returns (block_refs, metadata_refs) — no blocking, so a
        downstream stage can start on finished blocks while this stage's
        stragglers still run (DatasetPipeline overlap)."""
        task = _transform_block
        if remote_args:
            task = task.options(num_returns=2, **remote_args)
        pairs = [task.remote(fn, b) for b in blocks]
        return [p[0] for p in pairs], [p[1] for p in pairs]


def _accepts_state_uncached(fn: Callable) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    positional = [
        p for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2


_accepts_state_cached = functools.lru_cache(maxsize=256)(
    _accepts_state_uncached)


def _accepts_state(fn: Callable) -> bool:
    """True if fn declares >=2 positional params, i.e. (block, state) —
    Dataset transforms pass plain 1-arg block fns, which must keep working
    when init_fn is set.  A bare *args fn does NOT count: calling it as
    fn(block, state) would break variadic fns written for one argument.
    Cached when fn is hashable — inspect.signature is too slow to run
    once per block; unhashable callable objects fall back uncached."""
    try:
        return _accepts_state_cached(fn)
    except TypeError:
        return _accepts_state_uncached(fn)


class _PoolWorker:
    def __init__(self, init_fn: Optional[Callable] = None):
        self.state = init_fn() if init_fn else None

    def transform(self, fn: BlockTransform, block: Block):
        if self.state is not None and _accepts_state(fn):
            out = fn(block, self.state)
        else:
            out = fn(block)
        return out, BlockAccessor(out).get_metadata()


class ActorPoolStrategy:
    """min_size..max_size actors; blocks are dealt to the pool round-robin
    (reference ActorPoolStrategy)."""

    def __init__(self, min_size: int = 1, max_size: Optional[int] = None,
                 init_fn: Optional[Callable] = None):
        self.min_size = min_size
        self.max_size = max_size or max(min_size, 2)
        self.init_fn = init_fn

    def apply(self, fn: BlockTransform, blocks: List, *,
              remote_args: Optional[dict] = None
              ) -> Tuple[List, List]:
        n = max(self.min_size, min(self.max_size, len(blocks)))
        actor_cls = ray_tpu_torch.remote(**(remote_args or {"num_cpus": 1}))(
            _PoolWorker)
        actors = [actor_cls.remote(self.init_fn) for _ in range(n)]
        # Round-robin blocks over the pool; outputs stay as ObjectRefs
        # (num_returns=2) — blocks never transit the driver.
        pairs = [
            actors[i % n].transform.options(num_returns=2).remote(fn, b)
            for i, b in enumerate(blocks)]
        block_refs = [p[0] for p in pairs]
        meta_refs = [p[1] for p in pairs]

        # Kill the pool only after all work finished; fire-and-forget
        # cleanup keeps apply() non-blocking.
        def _reap(_meta):
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001 — the pool may be gone
                    pass
        _wait_then(meta_refs, _reap)
        return block_refs, meta_refs


def _wait_then(refs: List, cb: Callable):
    """Run cb(values) on a helper thread once all refs resolve."""
    def run():
        try:
            vals = ray_tpu_torch.get(list(refs))
        except Exception:  # noqa: BLE001 — cleanup runs on failure too
            vals = None
        cb(vals)
    threading.Thread(target=run, daemon=True,
                     name="data-pool-reaper").start()


def get_compute(compute) -> Any:
    if compute is None or compute == "tasks":
        return TaskPoolStrategy()
    if compute == "actors":
        return ActorPoolStrategy()
    if isinstance(compute, (TaskPoolStrategy, ActorPoolStrategy)):
        return compute
    raise ValueError(f"unknown compute strategy: {compute!r}")
