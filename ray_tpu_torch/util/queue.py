"""Distributed Queue backed by an actor.

A copy of ``ray_tpu.util.queue`` for the PyTorch port (reference
``python/ray/util/queue.py``): ``Queue`` with ``put``/``get``/
``put_nowait``/``get_nowait`` semantics, the ``Empty``/``Full``
exceptions, the batch variants and ``shutdown``.
"""

from __future__ import annotations

import queue as stdlib_queue
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = stdlib_queue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            self._q.put(item, block=timeout is not None and timeout > 0,
                        timeout=timeout)
            return True
        except stdlib_queue.Full:
            return False

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except stdlib_queue.Full:
            return False

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._q.maxsize > 0 and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    def get(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return True, self._q.get(block=True)
            return True, self._q.get(block=timeout > 0, timeout=timeout)
        except stdlib_queue.Empty:
            return False, None

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except stdlib_queue.Empty:
            return False, None

    def get_nowait_batch(self, num_items: int):
        if self._q.qsize() < num_items:
            return False, None
        return True, [self._q.get_nowait() for _ in range(num_items)]


# The class stays a plain module attribute, so that the actor's export
# pickles it by reference.
_QueueActorClass = ray_tpu_torch.remote(_QueueActor)


class Queue:
    """A first-in-first-out queue usable from any task or actor.

    Backed by a (optionally named/detached) ``_QueueActor`` so producers
    and consumers anywhere in the cluster share one queue.
    """

    def __init__(self, maxsize: int = 0,
                 actor_options: Optional[dict] = None):
        actor_options = actor_options or {}
        self.maxsize = maxsize
        self.actor = _QueueActorClass.options(
            **actor_options).remote(maxsize)

    def __len__(self) -> int:
        return self.size()

    def size(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def qsize(self) -> int:
        return self.size()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        # Block by polling the actor (the actor's own blocking put would
        # wedge its single-threaded executor).
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(
                self.actor.put_nowait_batch.remote(list(items))):
            raise Full(f"Cannot add {len(items)} items to queue of size "
                       f"{self.maxsize}")

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items))
        if not ok:
            raise Empty(f"Cannot get {num_items} items from queue of size "
                        f"{self.size()}")
        return items

    def shutdown(self, force: bool = False) -> None:
        if self.actor is not None:
            ray_tpu_torch.kill(self.actor)
        self.actor = None
