"""Distributed reference counting for objects.

A port of ``ray_tpu._private.reference_counter`` for the PyTorch port,
with plain ``threading`` locks in place of the lock-order witness's and
a logged warning where the reference counts a swallowed exception (both
debug planes, ROADMAP A.4b.7).  The node store's part is here: each
object's pinned node and spill record (``set_pinned_node``,
``set_spilled_url``, ``describe``, which the ``ObjectLostError`` message
reads) and per-object delete callbacks (``add_on_delete``).  The
reference's borrowers serve other owners and come with process workers.

Parity target: reference ``src/ray/core_worker/reference_count.h:61`` —
per-owner counts of (a) local Python refs, (b) refs held by submitted
pending tasks, (c) nested objects contained in still-live outer objects,
plus the lineage pointer to an object's creating task.  An object is
freeable only when local + submitted-task + contained counts are all
zero.

The object-id table is striped 16-way by ``hash(object_id)``, so
concurrent put/release traffic on distinct objects never
contends.  The discipline is **at most one stripe lock held at a time**:
mutators take only the target object's stripe lock; the out-of-scope
cascade (``contains``/``contained_in`` edges cross stripes) is an
iterative worklist that re-acquires each inner object's stripe lock one
at a time, and delete callbacks run with NO stripe lock held (they
re-enter the store and lineage layers).
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.ids import ObjectID, TaskID

logger = logging.getLogger(__name__)


class Reference:
    __slots__ = ("local_refs", "submitted_task_refs", "contained_in",
                 "contains", "owned", "lineage_task_id", "on_delete",
                 "pinned_node", "spilled_url", "out_of_scope")

    def __init__(self, owned: bool = True):
        self.local_refs = 0
        self.submitted_task_refs = 0
        # Outer object ids whose values contain this object id.
        self.contained_in: Set[ObjectID] = set()
        self.contains: Set[ObjectID] = set()
        self.owned = owned
        # Task that created this object — retained while reconstruction is
        # possible (lineage pinning, ray_config_def.h:97).
        self.lineage_task_id: Optional[TaskID] = None
        self.on_delete: List[Callable[[ObjectID], None]] = []
        self.pinned_node = None
        self.spilled_url: Optional[str] = None
        self.out_of_scope = False

    def total(self) -> int:
        return (self.local_refs + self.submitted_task_refs +
                len(self.contained_in))


#: Stripe count for the object-id table (power of two so the selector is
#: a mask; 16-way matches shm_store.cpp's striped object-table locks).
_NUM_STRIPES = 16


class _RefStripe:
    """One lock-striped shard of the reference table."""

    __slots__ = ("lock", "refs")

    def __init__(self, index: int):
        self.lock = threading.RLock()
        self.refs: Dict[ObjectID, Reference] = {}


class ReferenceCounter:
    def __init__(self):
        self._stripes = [_RefStripe(i) for i in range(_NUM_STRIPES)]
        # Subscribers list has its own (tiny, uncontended) lock so the
        # cascade can snapshot it without holding any stripe lock.
        self._subs_lock = threading.RLock()
        self._delete_subscribers: List[Callable[[ObjectID], None]] = []
        # Destructor-context releases (release_local_ref_async): an
        # ObjectRef.__del__ can fire from GC at ANY allocation point —
        # including inside a store-lock or task-manager-lock region of
        # the interrupted thread.  Running the out-of-scope cascade
        # (store delete, lineage eviction) inline there nests those
        # locks in arbitrary orders; the lock-order witness caught a
        # real MemoryStore<->TaskManager ABBA formed exactly this way.
        # Instead, __del__ only enqueues; a dedicated drain thread (or
        # a query API needing the settled state) runs the release from
        # a clean, no-locks-held context.  (Reference parity: Ray's
        # dtor hands RemoveLocalReference to the core worker's
        # io_service rather than running deletion in the GC context.)
        self._release_queue: "collections.deque[ObjectID]" = \
            collections.deque()
        self._release_cv = threading.Condition()
        self._release_thread: Optional[threading.Thread] = None
        #: Releases the drain thread has popped but not yet applied —
        #: flush must wait these out or a query could read stale state
        #: (queue empty != queue settled).
        self._release_inflight = 0
        self._closed = False

    def _stripe(self, object_id: ObjectID) -> _RefStripe:
        return self._stripes[hash(object_id) & (_NUM_STRIPES - 1)]

    # ---- registration ---------------------------------------------------
    def add_owned_object(self, object_id: ObjectID,
                        lineage_task_id: Optional[TaskID] = None,
                        contained_ids: Optional[List[ObjectID]] = None):
        # Inner ``contained_in`` edges go in FIRST (each under its own
        # stripe lock) so the inner objects are pinned before the outer
        # ref's ``contains`` set becomes visible — the cascade never
        # finds a contains edge whose reverse edge is missing.
        for inner in contained_ids or []:
            istripe = self._stripe(inner)
            with istripe.lock:
                inner_ref = istripe.refs.setdefault(
                    inner, Reference(owned=False))
                inner_ref.contained_in.add(object_id)
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.setdefault(object_id, Reference(owned=True))
            ref.owned = True
            ref.lineage_task_id = lineage_task_id
            for inner in contained_ids or []:
                ref.contains.add(inner)

    # ---- local refs (ObjectRef ctor/dtor) -------------------------------
    def add_local_ref(self, object_id: ObjectID):
        stripe = self._stripe(object_id)
        with stripe.lock:
            stripe.refs.setdefault(object_id, Reference()).local_refs += 1

    def remove_local_ref(self, object_id: ObjectID):
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            if ref is None:
                return
            # Floored: a duplicate decrement must degrade to a leak, not
            # a negative count that cancels out refs someone else holds
            # and frees the object under them.
            ref.local_refs = max(0, ref.local_refs - 1)
            item = self._maybe_delete_locked(stripe, object_id)
        if item is not None:
            self._run_delete_cascade(item)

    def release_local_ref_async(self, object_id: ObjectID):
        """Destructor-safe local-ref release: enqueue only, never run
        the out-of-scope cascade in the caller's (GC-interrupted) lock
        context.  The drain thread — or the next settled-state query —
        performs the actual :meth:`remove_local_ref`.

        After :meth:`close` (shutdown teardown, nothing left to race)
        the release applies inline — a dead drain thread must not turn
        late destructors into silent leaks."""
        with self._release_cv:
            if not self._closed:
                self._release_queue.append(object_id)
                if self._release_thread is None:
                    self._release_thread = threading.Thread(
                        target=self._release_loop, daemon=True,
                        name="ray_tpu_torch::ref_release")
                    self._release_thread.start()
                self._release_cv.notify()
                return
        self.remove_local_ref(object_id)

    def flush_pending_releases(self):
        """Apply queued destructor releases NOW, in the calling thread
        (which, unlike a ``__del__`` context, holds no runtime locks),
        and wait out any release the drain thread has in flight.  Query
        APIs call this so ``del ref; gc.collect()`` is observably
        synchronous, exactly as the inline destructor was."""
        while True:
            with self._release_cv:
                if not self._release_queue:
                    # Queue empty is not settled: the drain may have
                    # popped an oid it hasn't applied yet.
                    while self._release_inflight:
                        self._release_cv.wait(timeout=0.1)
                    return
                oid = self._release_queue.popleft()
            self.remove_local_ref(oid)

    def _release_loop(self):
        while True:
            with self._release_cv:
                while not self._release_queue and not self._closed:
                    self._release_cv.wait(timeout=0.5)
                if not self._release_queue:
                    if self._closed:
                        return
                    continue
                oid = self._release_queue.popleft()
                self._release_inflight += 1
            try:
                self.remove_local_ref(oid)
            except Exception:
                logger.exception("releasing a local reference failed")
            finally:
                with self._release_cv:
                    self._release_inflight -= 1
                    self._release_cv.notify_all()

    def close(self):
        """Stop the drain thread (cluster shutdown); pending releases
        are applied inline first so nothing leaks silently."""
        self.flush_pending_releases()
        with self._release_cv:
            self._closed = True
            self._release_cv.notify_all()
        t = self._release_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)

    # ---- task-arg refs --------------------------------------------------
    def add_submitted_task_refs(self, object_ids: List[ObjectID]):
        for oid in object_ids:
            stripe = self._stripe(oid)
            with stripe.lock:
                stripe.refs.setdefault(
                    oid, Reference()).submitted_task_refs += 1

    def remove_submitted_task_refs(self, object_ids: List[ObjectID]):
        for oid in object_ids:
            stripe = self._stripe(oid)
            item = None
            with stripe.lock:
                ref = stripe.refs.get(oid)
                if ref is None:
                    continue
                ref.submitted_task_refs = max(
                    0, ref.submitted_task_refs - 1)
                item = self._maybe_delete_locked(stripe, oid)
            if item is not None:
                self._run_delete_cascade(item)

    # ---- queries --------------------------------------------------------
    # Queries settle pending destructor releases first: a test's
    # `del ref; gc.collect(); assert not has_reference(...)` must see
    # the release applied, and the flushing thread is a clean (no
    # runtime locks held) context to run the cascade from.
    def has_reference(self, object_id: ObjectID) -> bool:
        self.flush_pending_releases()
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            return ref is not None and not ref.out_of_scope

    def lineage_task(self, object_id: ObjectID) -> Optional[TaskID]:
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            return ref.lineage_task_id if ref else None

    def set_pinned_node(self, object_id: ObjectID, node_id):
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            if ref is not None:
                ref.pinned_node = node_id

    def describe(self, object_id: ObjectID) -> Optional[dict]:
        """Snapshot of one reference (ownership, counts, pinned node,
        spill record): the ObjectLostError message reads it."""
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            if ref is None:
                return None
            return {
                "owned": ref.owned,
                "local_refs": ref.local_refs,
                "submitted_task_refs": ref.submitted_task_refs,
                "pinned_node": ref.pinned_node,
                "spilled_url": ref.spilled_url,
                "out_of_scope": ref.out_of_scope,
            }

    def set_spilled_url(self, object_id: ObjectID, url: str):
        stripe = self._stripe(object_id)
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            if ref is not None:
                ref.spilled_url = url

    # ---- deletion -------------------------------------------------------
    def subscribe_deleted(self, cb: Callable[[ObjectID], None]):
        """Register a callback fired when an object goes out of scope
        (the object store uses this to evict the value)."""
        with self._subs_lock:
            self._delete_subscribers.append(cb)

    def add_on_delete(self, object_id: ObjectID,
                      cb: Callable[[ObjectID], None]):
        """``cb(object_id)`` when this object goes out of scope (at once
        if it already has)."""
        stripe = self._stripe(object_id)
        fire = False
        with stripe.lock:
            ref = stripe.refs.get(object_id)
            if ref is None or ref.out_of_scope:
                fire = True
            else:
                ref.on_delete.append(cb)
        if fire:
            cb(object_id)

    def _maybe_delete_locked(self, stripe: _RefStripe,
                             object_id: ObjectID):
        """Out-of-scope check for ``object_id``; must hold
        ``stripe.lock`` (the stripe owning ``object_id``).  Removes the
        ref from the table and returns a ``(object_id, on_delete,
        contains)`` work item for :meth:`_run_delete_cascade`, or
        ``None`` if the object stays live.  Callbacks and cross-stripe
        edge removal are deliberately NOT done here — they need other
        stripes' locks (or none)."""
        ref = stripe.refs.get(object_id)
        if ref is None or ref.out_of_scope or ref.total() > 0:
            return None
        ref.out_of_scope = True
        del stripe.refs[object_id]
        return (object_id, ref.on_delete, ref.contains)

    def _run_delete_cascade(self, item) -> None:
        """Run the out-of-scope cascade for one freed object, holding
        at most one stripe lock at any instant.  Releasing an outer
        object releases the ``contained_in`` edges of its inner objects
        — possibly cascading (reference: nested refs) — via an
        iterative worklist (outer's callbacks fire before its inners').
        Delete callbacks run with NO stripe lock held: they re-enter
        store/lineage layers and must not create lock-order edges."""
        worklist = collections.deque([item])
        while worklist:
            object_id, on_delete, contains = worklist.popleft()
            for inner in contains:
                istripe = self._stripe(inner)
                inner_item = None
                with istripe.lock:
                    inner_ref = istripe.refs.get(inner)
                    if inner_ref is not None:
                        inner_ref.contained_in.discard(object_id)
                        inner_item = self._maybe_delete_locked(
                            istripe, inner)
                if inner_item is not None:
                    worklist.append(inner_item)
            with self._subs_lock:
                callbacks = list(on_delete) + list(self._delete_subscribers)
            for cb in callbacks:
                try:
                    cb(object_id)
                except Exception:
                    # A failed delete subscriber leaks its copy of the
                    # object: say so.
                    logger.exception("delete subscriber failed for %s",
                                     object_id)
