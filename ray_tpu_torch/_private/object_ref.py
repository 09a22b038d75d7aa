"""ObjectRef — the user-facing future/handle to a stored object.

A copy of ``ray_tpu._private.object_ref`` for the PyTorch port.

Parity target: the reference's ``ObjectRef`` (Cython,
``python/ray/includes/object_ref.pxi``): holds the binary id + owner address,
participates in distributed refcounting via ctor/dtor hooks, supports
``future()`` interop and is awaitable.
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID, WorkerID


class ObjectRef:
    __slots__ = ("_id", "_owner_id", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_id: Optional[WorkerID] = None,
                 skip_adding_local_ref: bool = False):
        self._id = object_id
        self._owner_id = owner_id
        self._registered = False
        if not skip_adding_local_ref:
            wk = _current_worker()
            if wk is not None:
                wk.core_worker.reference_counter.add_local_ref(self._id)
                self._registered = True

    # -- identity ---------------------------------------------------------
    def object_id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def owner_id(self) -> Optional[WorkerID]:
        return self._owner_id

    def owner_id_binary(self):
        return self._owner_id.binary() if self._owner_id else None

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self._id == other._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Plain pickling path (outside the store serializer): keep identity,
        # do not register a local ref — the store serializer handles borrows.
        return (ObjectRef, (self._id, self._owner_id, True))

    def __copy__(self):
        # A copied handle is a real second reference (unlike the pickle
        # path): it must pin independently or its deletion under-counts.
        return ObjectRef(self._id, self._owner_id)

    def __deepcopy__(self, _memo):
        return ObjectRef(self._id, self._owner_id)

    # -- refcounting hooks ------------------------------------------------
    def __del__(self):
        # ENQUEUE-only (release_local_ref_async): a destructor fires
        # from GC at whatever allocation point interrupted the thread —
        # possibly inside a store-lock or task-manager-lock region.
        # Running the out-of-scope cascade inline there nests runtime
        # locks in arbitrary orders (the lock-order witness caught a
        # MemoryStore<->TaskManager ABBA formed exactly this way); the
        # reference counter's drain applies the release from a clean
        # context, and its query APIs settle the queue synchronously.
        if self._registered:
            try:
                wk = _current_worker()
                if wk is not None and wk.core_worker is not None:
                    wk.core_worker.reference_counter \
                        .release_local_ref_async(self._id)
            except Exception:
                pass  # interpreter teardown: module globals may be gone

    # -- future interop ---------------------------------------------------
    def future(self) -> concurrent.futures.Future:
        """A concurrent.futures.Future resolving to the object's value."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _cb(value, err):
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(value)

        wk = _current_worker()
        wk.core_worker.get_async(self, _cb)
        return fut

    def __await__(self):
        import asyncio
        return asyncio.wrap_future(self.future()).__await__()


def _current_worker():
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.global_worker_or_none()
    if w is None or not w.connected:
        return None
    return w
