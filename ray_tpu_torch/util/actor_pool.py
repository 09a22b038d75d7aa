"""ActorPool: fan work out over a fixed set of actors.

A copy of ``ray_tpu.util.actor_pool`` for the PyTorch port, with the
public surface of the reference's ``python/ray/util/actor_pool.py``
(``submit`` / ``get_next`` / ``get_next_unordered`` / ``map`` /
``map_unordered`` / ``has_next`` / ``has_free`` / ``push`` /
``pop_idle``), re-implemented around a ticketed in-flight table: every
submission takes a monotonically increasing ticket, ordered retrieval
walks the ticket sequence, unordered retrieval races the in-flight refs
with ``wait``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private.object_ref import ObjectRef


class ActorPool:
    """Distribute ``fn(actor, value)`` calls across idle pool actors.

    >>> @ray_tpu_torch.remote
    ... class W:
    ...     def double(self, v): return 2 * v
    >>> pool = ActorPool([W.remote(), W.remote()])
    >>> list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    [2, 4, 6, 8]
    """

    def __init__(self, actors: Iterable[Any]):
        self._free: List[Any] = list(actors)
        self._backlog: deque = deque()          # (fn, value) with no actor
        self._inflight: Dict[ObjectRef, Tuple[int, Any]] = {}
        self._ticket_refs: Dict[int, ObjectRef] = {}
        self._ticket_seq = 0                    # next ticket to hand out
        self._emit_cursor = 0                   # next ticket get_next emits

    # ---- submission -----------------------------------------------------
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Launch ``fn(actor, value)`` on a free actor, or queue it."""
        if not self._free:
            self._backlog.append((fn, value))
            return
        actor = self._free.pop()
        ref = fn(actor, value)
        self._inflight[ref] = (self._ticket_seq, actor)
        self._ticket_refs[self._ticket_seq] = ref
        self._ticket_seq += 1

    def has_next(self) -> bool:
        return bool(self._inflight) or bool(self._backlog)

    def has_free(self) -> bool:
        return bool(self._free) and not self._backlog

    # ---- retrieval ------------------------------------------------------
    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Result of the oldest outstanding submission (ticket order).

        A timeout leaves the pool untouched (the submission stays
        retrievable); a task error recycles the actor before re-raising,
        so one failed task never wedges the pool."""
        if not self.has_next():
            raise StopIteration("ActorPool has no outstanding work")
        ref = self._ticket_refs.get(self._emit_cursor)
        if ref is None:
            raise ValueError(
                "ordered get_next() cannot follow get_next_unordered(): "
                "the ticket sequence has a hole")
        try:
            result = ray_tpu_torch.get(ref, timeout=timeout)
        except exceptions.GetTimeoutError:
            raise            # nothing consumed; caller may retry
        except Exception:
            self._consume(self._emit_cursor, ref)
            raise
        self._consume(self._emit_cursor, ref)
        return result

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Whichever outstanding result lands first."""
        if not self.has_next():
            raise StopIteration("ActorPool has no outstanding work")
        done, _rest = ray_tpu_torch.wait(list(self._inflight),
                                         num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError(
                f"no ActorPool result became ready within {timeout}s")
        ref = done[0]
        ticket, _actor = self._inflight[ref]
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._consume(ticket, ref)

    def _consume(self, ticket: int, ref: ObjectRef) -> None:
        """Retire a finished submission: drop its ticket, advance the
        ordered cursor past it, and recycle its actor."""
        self._ticket_refs.pop(ticket, None)
        if ticket == self._emit_cursor:
            self._emit_cursor += 1
        self._recycle(ref)

    def _recycle(self, ref: ObjectRef) -> None:
        """Free the actor behind a finished ref and drain the backlog."""
        _ticket, actor = self._inflight.pop(ref)
        self._free.append(actor)
        if self._backlog:
            self.submit(*self._backlog.popleft())

    # ---- bulk maps ------------------------------------------------------
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---- pool membership ------------------------------------------------
    def push(self, actor) -> None:
        """Grow the pool with one more (idle) actor."""
        if actor in self._free or \
                any(actor is a for _t, a in self._inflight.values()):
            raise ValueError("actor is already a member of this ActorPool")
        self._free.append(actor)
        if self._backlog:
            self.submit(*self._backlog.popleft())

    def pop_idle(self):
        """Detach one idle actor from the pool (None if all are busy)."""
        if self.has_free():
            return self._free.pop()
        return None
