"""The owner's in-process object store.

The ``CoreWorkerMemoryStore`` half of ``ray_tpu._private.object_store``
for the PyTorch port (reference
``src/ray/core_worker/store_provider/memory_store/``): small objects,
error markers and pending futures of one owner; a blocking ``get`` with
a timeout and ``get_async`` callbacks fired on the thread that seals the
object.

The reference's node store (``NodeObjectStore``, the plasma
equivalent with spilling), its ``InPlasmaMarker`` and its
``DeviceObject`` come with the object plane and the device-object plane
(ROADMAP A.4b.2, A.5).  So an entry here holds a ``SerializedObject`` or
an error, and its reader pins and spill fields are not kept.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import deserialize


class _Entry:
    __slots__ = ("data", "error", "size", "sealed")

    def __init__(self, data=None, error=None, size=0):
        self.data = data              # SerializedObject | None
        self.error = error            # Exception to raise at get()
        self.size = size
        self.sealed = data is not None or error is not None


class MemoryStore:
    """In-process store: small objects, error markers, pending futures.

    ``get`` blocks on a condition variable until the object is sealed
    (reference: memory store ``GetAsync``/``Get`` with timeout).
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._get_callbacks: Dict[ObjectID, list] = {}

    def put(self, object_id: ObjectID, data, error=None) -> int:
        size = data.total_bytes if data is not None else 0
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry.sealed:
                return entry.size  # idempotent re-put
            entry = _Entry(data=data, error=error, size=size)
            self._entries[object_id] = entry
            callbacks = self._get_callbacks.pop(object_id, [])
            self._lock.notify_all()
        for cb in callbacks:
            cb(entry)
        return size

    def put_error(self, object_id: ObjectID, error: BaseException):
        self.put(object_id, None, error=error)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed

    def get_entry(self, object_id: ObjectID) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(object_id)

    def get(self, object_id: ObjectID,
            timeout: Optional[float] = None) -> _Entry:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                e = self._entries.get(object_id)
                if e is not None and e.sealed:
                    return e
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise exceptions.GetTimeoutError(
                        f"Get timed out for {object_id}")
                self._lock.wait(timeout=remaining if remaining is None
                                else min(remaining, 0.5))

    def get_async(self, object_id: ObjectID, cb: Callable[[_Entry], None]):
        """``cb(entry)`` once the object is sealed: at once on this
        thread if it is, else on the thread that seals it."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed:
                self._get_callbacks.setdefault(object_id, []).append(cb)
                return
        cb(e)

    def cancel_get_async(self, object_id: ObjectID,
                         cb: Callable[[_Entry], None]):
        """Deregister a pending get_async callback (no-op if it already
        fired): callers that stop waiting must not leak closures."""
        with self._lock:
            cbs = self._get_callbacks.get(object_id)
            if cbs is None:
                return
            try:
                cbs.remove(cb)
            except ValueError:
                return
            if not cbs:
                del self._get_callbacks[object_id]

    def delete(self, object_id: ObjectID):
        with self._lock:
            self._entries.pop(object_id, None)
            self._get_callbacks.pop(object_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._entries)


def entry_value(entry: _Entry):
    """Deserialize an entry to its Python value (raising stored errors)."""
    if entry.error is not None:
        raise entry.error
    return deserialize(entry.data)
