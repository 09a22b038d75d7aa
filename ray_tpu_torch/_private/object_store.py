"""The owner's in-process object store and the per-node object store.

A port of ``ray_tpu._private.object_store`` for the PyTorch port:

* ``MemoryStore`` (reference ``CoreWorkerMemoryStore``,
  ``src/ray/core_worker/store_provider/memory_store/``): small objects,
  error markers, ``InPlasmaMarker``\\s and pending futures of one owner; a
  blocking ``get`` with a timeout and ``get_async`` callbacks fired on
  the thread that seals the object.
* ``NodeObjectStore`` (the plasma equivalent, with
  ``raylet/local_object_manager.cc``'s spilling): one node's objects,
  with capacity accounting, reader pins, the create-request queue that
  holds an over-capacity put until space frees or its grace period ends
  (``ObjectStoreFullError``), spilling into fused batch files recorded
  as ``path?offset=&size=``, restore on read, and the transfer surface of
  the pull path: ``TransferLedger`` (sender admission),
  ``_HeapTransferWriter`` (one writer per object and store) and
  ``_PartialTransfer`` (the relay read of an in-flight transfer).

The store holds objects the way the reference's python-held path does
(``native_backend=None``): a ``SerializedObject`` per entry, or a
``DeviceObject``, a tensor kept where it lies (the card, or the CPU for
a cluster on ``device="cpu"``).  A device entry counts its bytes against
the store's capacity like any entry, is never a spill candidate, turns
into its host form for a pull or a forced spill, and is handed out as
the stored tensor on the same node.  The native shared-memory segment
(``_NativeHandle``, ``_SegmentTransferWriter``, ``segment_chunk_source``)
is ROADMAP A.4b.2b, and the chunk server's hooks
(``partial_chunk_source``) come with the cross-process fetch.  The
reference's fault-injection points, flight recorder and tracing spans
(A.4b.7) are left out.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)
from ray_tpu_torch._private.serialization import (SerializedObject,
                                                  aligned_flat_buffer,
                                                  copy_into_view,
                                                  deserialize, serialize)


def _spill_url(path: str, offset: int, size: int) -> str:
    """Spill location record: fused batch files hold many objects, so a
    bare path is not enough (reference ``spilled_url``)."""
    return f"{path}?offset={offset}&size={size}"


def _parse_spill_url(url: str) -> Tuple[str, int, int]:
    path, _, query = url.partition("?")
    offset = size = 0
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == "offset":
            offset = int(v)
        elif k == "size":
            size = int(v)
    return path, offset, size


def write_flat(f, data: SerializedObject) -> int:
    """Write ``data``'s flat form to the open file ``f`` piece by piece
    (no contiguous copy first); returns the bytes written."""
    n = 0
    for _, piece in data.flat_chunks(1 << 62):
        f.write(piece)
        n += piece.nbytes
    return n


class DeviceObject:
    """A store entry whose payload is a tensor, kept on its device
    (reference ``DeviceObject``, whose payload is a ``jax.Array``).

    Readers on the same node get the stored tensor itself, with no host
    copy; the host form is made only for a pull to another node or a
    forced spill.  The tensor is the store's private copy (ROADMAP
    C.19): a reader must not write into it."""

    __slots__ = ("value", "nbytes")

    def __init__(self, value):
        self.value = value
        self.nbytes = value.numel() * value.element_size()

    def to_serialized(self) -> SerializedObject:
        return serialize(self.value)


class _Entry:
    __slots__ = ("data", "error", "size", "pin_count", "last_access",
                 "spilled_path", "sealed", "is_device", "primary",
                 "spilling")

    def __init__(self, data=None, error=None, size=0):
        self.data = data   # SerializedObject | DeviceObject | marker | None
        self.error = error            # Exception to raise at get()
        self.size = size
        # READER pins only (executor argument reads): a reader-pinned
        # entry is never spilled out from under the read.  Primary
        # copies are spillable; the owner's primary-copy claim is the
        # separate ``primary`` flag.
        self.pin_count = 0
        self.primary = False
        # The spill thread is copying this entry out; guards double
        # selection (a delete still wins).
        self.spilling = False
        self.last_access = time.monotonic()
        #: Spill location URL (``path?offset=&size=``) once on disk.
        self.spilled_path: Optional[str] = None
        self.sealed = data is not None or error is not None
        self.is_device = isinstance(data, DeviceObject)


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

    def fail(self, object_id: ObjectID, error: BaseException):
        """Seal ``error`` over the entry, replacing any value: the
        owner's death invalidates the object even where its bytes still
        exist, and every borrower must observe the error (reference
        OWNER_DIED on Get)."""
        with self._lock:
            entry = _Entry(data=None, error=error)
            self._entries[object_id] = entry
            callbacks = self._get_callbacks.pop(object_id, [])
            self._lock.notify_all()
        for cb in callbacks:
            cb(entry)

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


class TransferLedger:
    """Sender-side outbound-transfer accounting for ONE store: active
    transfers, in-flight bytes and a FIFO admission queue
    (push_manager.cc's bounded concurrent sends, made a per-store
    budget).  Its gauges land in the store's ``stats``.  The condition
    is a leaf lock: nothing else is taken under it."""

    __slots__ = ("_cond", "_active", "_inflight", "_queue", "stats")

    def __init__(self, stats: dict):
        self._cond = threading.Condition()
        self._active = 0
        self._inflight = 0
        self._queue: list = []        # FIFO of waiter tokens
        self.stats = stats
        for key in ("outbound_sessions_active", "outbound_inflight_bytes",
                    "transfer_admission_queue_depth",
                    "transfer_admission_waits",
                    "outbound_served_bytes", "relay_served_bytes"):
            stats.setdefault(key, 0)

    def _sync_gauges_locked(self) -> None:
        self.stats["outbound_sessions_active"] = self._active
        self.stats["outbound_inflight_bytes"] = self._inflight
        self.stats["transfer_admission_queue_depth"] = len(self._queue)

    def enqueue(self) -> object:
        """Join the FIFO admission queue; the returned ticket keeps its
        place across bounded ``wait_grant`` polls.  Pair with
        ``wait_grant``/``cancel``."""
        token = object()
        with self._cond:
            self._queue.append(token)
            self._sync_gauges_locked()
            if len(self._queue) > 1 or self._active >= max(
                    1, get_config().object_transfer_max_outbound_sessions):
                self.stats["transfer_admission_waits"] += 1
        return token

    def wait_grant(self, token, timeout: Optional[float] = None,
                   nbytes: int = 0) -> bool:
        """Wait up to ``timeout`` for ``token`` to reach the queue's head
        with a free slot.  False on timeout; the ticket keeps its place
        (call again, or ``cancel``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                cap = max(1, get_config()
                          .object_transfer_max_outbound_sessions)
                if self._queue and self._queue[0] is token and \
                        self._active < cap:
                    self._queue.pop(0)
                    self._active += 1
                    self._inflight += int(nbytes)
                    self._sync_gauges_locked()
                    # The next waiter may be grantable now.
                    self._cond.notify_all()
                    return True
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=0.2 if remaining is None
                                else min(remaining, 0.2))

    def cancel(self, token) -> None:
        """Leave the queue without a grant (timeout / re-selection)."""
        with self._cond:
            if token in self._queue:
                self._queue.remove(token)
                self._sync_gauges_locked()
                self._cond.notify_all()

    def try_acquire(self, nbytes: int = 0,
                    timeout: Optional[float] = None) -> bool:
        """FIFO slot acquisition; True on grant, False (out of the
        queue) on timeout."""
        token = self.enqueue()
        if self.wait_grant(token, timeout=timeout, nbytes=nbytes):
            return True
        self.cancel(token)
        return False

    def release(self, nbytes: int = 0) -> None:
        with self._cond:
            self._active = max(0, self._active - 1)
            self._inflight = max(0, self._inflight - int(nbytes))
            self._sync_gauges_locked()
            self._cond.notify_all()

    def note_served(self, nbytes: int, relay: bool = False) -> None:
        with self._cond:
            self.stats["outbound_served_bytes"] += int(nbytes)
            if relay:
                self.stats["relay_served_bytes"] += int(nbytes)

    def load_score(self) -> Tuple[int, int]:
        """(transfers incl. queued, in-flight bytes): what load-aware
        source selection ranks candidates by."""
        with self._cond:
            return (self._active + len(self._queue), self._inflight)

    def has_free_slot(self) -> bool:
        with self._cond:
            cap = max(1, get_config()
                      .object_transfer_max_outbound_sessions)
            return not self._queue and self._active < cap

    def load_snapshot(self) -> dict:
        """Wire form for resource reports."""
        with self._cond:
            return {"active": self._active, "queued": len(self._queue),
                    "inflight_bytes": self._inflight}


class _PartialTransfer:
    """Relay surface over ONE in-flight transfer writer: tracks the
    contiguous assembly watermark and serves prefix reads to downstream
    pullers while the upstream chunks still land (the chain half of a
    broadcast).

    Registered by the transfer writer (one per object and store),
    advanced per landed chunk, promoted at seal (later reads resolve
    through the sealed entry or the writer's buffer) or failed at abort
    (readers get None and re-select).  A read never crosses the
    watermark, so no chunk is torn; seal and abort drain the raw readers
    first."""

    __slots__ = ("store", "object_id", "nbytes", "_cond", "_watermark",
                 "_ooo", "_readers", "_failed", "_sealing", "_sealed",
                 "_read_raw", "_raw_after_seal", "_sealed_cache")

    def __init__(self, store: "NodeObjectStore", object_id: ObjectID,
                 nbytes: int, read_raw):
        self.store = store
        self.object_id = object_id
        self.nbytes = nbytes
        self._cond = threading.Condition()
        self._watermark = 0
        self._ooo: Dict[int, int] = {}   # offset -> end, out of order
        self._readers = 0
        self._failed = False
        self._sealing = False
        self._sealed = False
        self._read_raw = read_raw        # (start, end) -> buffer view
        # A heap writer's buffer stays valid past seal: tail relay reads
        # keep using it instead of going through the store.
        self._raw_after_seal = False
        # One flat copy for a sealed entry with no range read.
        self._sealed_cache: Optional[bytes] = None

    # ---- writer side ---------------------------------------------------
    def advance(self, offset: int, length: int) -> None:
        """A chunk landed at [offset, offset+length): extend the
        contiguous watermark."""
        with self._cond:
            self._ooo[offset] = offset + length
            while self._watermark in self._ooo:
                self._watermark = self._ooo.pop(self._watermark)
            self._cond.notify_all()

    def quiesce_for_seal(self) -> None:
        """Stop raw reads and drain the ones in flight, before the
        buffer becomes a sealed entry."""
        with self._cond:
            self._sealing = True
            self._cond.notify_all()
            while self._readers:
                self._cond.wait(timeout=0.1)

    def mark_sealed(self, raw_still_valid: bool = False) -> None:
        """Promote to sealed; ``raw_still_valid`` says the raw buffer
        cannot be recycled (a heap buffer the read closure keeps
        alive)."""
        with self._cond:
            self._sealed = True
            self._raw_after_seal = raw_still_valid
            if not raw_still_valid:
                self._read_raw = None
            self._sealing = False
            self._watermark = self.nbytes
            self._cond.notify_all()

    def mark_failed(self) -> None:
        """The upstream transfer died: fail downstream readers and drain
        raw reads; the read closure is dropped."""
        with self._cond:
            self._failed = True
            self._read_raw = None
            self._cond.notify_all()
            while self._readers:
                self._cond.wait(timeout=0.1)

    @property
    def watermark(self) -> int:
        with self._cond:
            return self._watermark

    @property
    def failed(self) -> bool:
        with self._cond:
            return self._failed

    # ---- reader side ---------------------------------------------------
    def read_range(self, start: int, end: int,
                   timeout: Optional[float] = None):
        """Bytes of ``[start, end)`` once the watermark covers them.
        Raises TimeoutError while the range is still being assembled;
        returns None when the upstream transfer failed."""
        end = min(end, self.nbytes)
        deadline = None if timeout is None else time.monotonic() + timeout
        raw = None
        with self._cond:
            while True:
                if self._failed:
                    return None
                if self._sealed:
                    if self._raw_after_seal:
                        return bytes(self._read_raw(start, end))
                    break
                if self._watermark >= end and not self._sealing:
                    self._readers += 1
                    raw = self._read_raw
                    break
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"relay watermark {self._watermark} < {end}")
                self._cond.wait(timeout=0.2 if remaining is None
                                else min(remaining, 0.2))
        if raw is not None:
            try:
                return bytes(raw(start, end))
            finally:
                with self._cond:
                    self._readers -= 1
                    self._cond.notify_all()
        # Sealed: the bytes live in the store entry now.
        data = self.store.read_sealed_range(self.object_id, start, end)
        if data is not None:
            return data
        with self._cond:
            blob = self._sealed_cache
        if blob is None:
            serialized = self.store.get_serialized(self.object_id)
            if serialized is None:
                return None
            blob = serialized.to_bytes()
            with self._cond:
                self._sealed_cache = blob
        return blob[start:end]


class NodeObjectStore:
    """The plasma equivalent of one node: capacity, reader pins,
    spilling (module docstring).

    Reference behaviours kept: the create/seal lifecycle, primary copies
    (``local_object_manager.h:37``), spilling over the threshold in
    fused batches, restore on demand, delete when out of scope, and a
    put that queues for space and fails only when spilling cannot make
    room within the grace period.
    """

    def __init__(self, node_id, capacity_bytes: int, spill_dir: str,
                 spill_threshold: float = 0.8,
                 on_spilled: Optional[Callable] = None):
        self.node_id = node_id
        self.capacity = capacity_bytes
        self.spill_threshold = spill_threshold
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Condition()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._used = 0
        # Bytes reserved by in-flight transfer writers (charged before
        # the chunks land, so concurrent pulls cannot over-commit the
        # budget; moved into _used at seal, dropped at abort).
        self._transfer_reserved = 0
        # Objects with an in-flight transfer writer: at most one writer
        # per (object, store); later pulls wait and adopt its copy.
        self._active_transfers: set = set()
        # In-flight transfers relayable downstream: object ->
        # _PartialTransfer (rides the single-writer claim above).
        self._partials: Dict[ObjectID, _PartialTransfer] = {}
        # Create-request queue depth (create_request_queue.h): puts over
        # capacity wait on the store condition.  ``_queued_bytes`` is
        # what they wait to reserve: the spill thread's shortfall counts
        # it (a divergence, ROADMAP C.5).
        self._create_waiters = 0
        self._queued_bytes = 0
        # The raylet's spill thread (LocalObjectManager); a store built
        # bare spills inline.
        self._spill_manager = None
        #: ``on_spilled(object_id, url)``: records the spilled_url with
        #: the owner, wired by the raylet.
        self._on_spilled = on_spilled
        # Live objects per spill file: a fused batch file is unlinked
        # only once every object it holds is deleted.
        self._spill_files: Dict[str, set] = {}
        self.stats = {"spilled_bytes": 0, "restored_bytes": 0,
                      "spilled_objects": 0, "restored_objects": 0,
                      "queued_creates": 0, "create_queue_wait_ms": 0.0,
                      "create_queue_timeouts": 0, "spill_errors": 0}
        # Outbound transfer admission (the sender side of a broadcast);
        # its gauges live in self.stats.
        self.transfer_ledger = TransferLedger(self.stats)
        nid = getattr(node_id, "hex", lambda: str(node_id))()[:12]

        def _collect(store):
            labels = {"node": nid}
            record_internal("ray_tpu.object_store.used_bytes",
                            store._used, **labels)
            record_internal("ray_tpu.object_store.capacity_bytes",
                            store.capacity, **labels)
            record_internal("ray_tpu.object_store.num_objects",
                            len(store._entries), **labels)
            record_internal("ray_tpu.object_store.create_queue_depth",
                            store._create_waiters, **labels)
            for k, v in list(store.stats.items()):
                record_internal(f"ray_tpu.object_store.{k}", v, **labels)
        get_metrics_registry().register_collector(self, _collect)

    def attach_spill_manager(self, manager) -> None:
        """Wire the raylet's LocalObjectManager: spilling over the
        threshold moves off the put path onto its thread, and queued
        creates kick it instead of spilling inline."""
        with self._lock:
            self._spill_manager = manager

    # ---- create/seal (plasma lifecycle) --------------------------------
    def put(self, object_id: ObjectID, data, pin: bool = True) -> int:
        """Store ``data`` (a ``SerializedObject`` or a ``DeviceObject``,
        whose ``nbytes`` count against the capacity alike); a put over
        capacity waits in the create queue (``_ensure_capacity``).  A
        second put of an id returns the first one's size."""
        size = data.nbytes if isinstance(data, DeviceObject) \
            else data.total_bytes
        with self._lock:
            existing = self._entries.get(object_id)
            if existing is None and self._ensure_capacity(size):
                # The request queued with the lock released: a racing
                # put of the same id may have landed meanwhile.
                existing = self._entries.get(object_id)
            if existing is not None:
                return existing.size
            e = _Entry(data=data, size=size)
            e.primary = pin
            self._entries[object_id] = e
            self._used += size
            self._lock.notify_all()
            return size

    def create_transfer_writer(self, object_id: ObjectID, nbytes: int,
                               pin: bool = False):
        """Writer for an incoming transfer of ``nbytes`` flat bytes: a
        heap buffer the chunks are copied into, sealed into an entry.

        The store budget is enforced here (queueing, spilling, raising
        ObjectStoreFullError when even spilling cannot make room) and
        the bytes stay charged to ``_transfer_reserved`` until seal or
        abort.  If another writer of this object is in flight, this
        blocks until it seals or aborts, and returns None when the
        object landed (the caller adopts that copy)."""
        with self._lock:
            while object_id in self._active_transfers:
                self._lock.wait(0.5)
            e = self._entries.get(object_id)
            if e is not None and e.sealed:
                return None
            # Claim before the capacity wait, which releases the lock.
            self._active_transfers.add(object_id)
            try:
                self._ensure_capacity(nbytes)
                e = self._entries.get(object_id)
                if e is not None and e.sealed:
                    self._active_transfers.discard(object_id)
                    self._lock.notify_all()
                    return None
                self._transfer_reserved += nbytes
            except BaseException:
                self._active_transfers.discard(object_id)
                self._lock.notify_all()
                raise
        return _HeapTransferWriter(self, object_id, nbytes, pin)

    def _release_transfer_reservation(self, nbytes: int,
                                      object_id: Optional[ObjectID] = None
                                      ) -> None:
        with self._lock:
            self._transfer_reserved -= nbytes
            if object_id is not None:
                self._active_transfers.discard(object_id)
                self._lock.notify_all()

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed

    def get(self, object_id: ObjectID) -> Optional[_Entry]:
        """The sealed entry, restored from its spill file if it was
        spilled; None when absent.  Raises ObjectVanishedError when the
        spill file is gone (``drop_vanished`` heals the entry)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed:
                return None
            e.last_access = time.monotonic()
            if e.data is None and e.spilled_path is not None:
                self._restore(object_id, e)
            return e

    def get_serialized(self, object_id: ObjectID
                       ) -> Optional[SerializedObject]:
        """The entry's serialized form: a device entry's host form for
        a pull."""
        try:
            e = self.get(object_id)
        except ObjectVanishedError:
            return None
        if e is None:
            return None
        data = e.data
        if isinstance(data, DeviceObject):
            return data.to_serialized()
        return data

    def pin(self, object_id: ObjectID):
        """Reader pin: protects the entry from spill selection."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                e.pin_count += 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.pin_count > 0:
                e.pin_count -= 1

    def drop_vanished(self, object_id: ObjectID) -> bool:
        """Self-heal an entry whose bytes are gone: a spilled entry
        whose spill file was removed underneath (the reference's case is
        a segment block freed underneath).  Such an entry makes
        ``contains`` lie, so pulls would short-circuit "local" for ever
        while reads miss.  Returns True if dropped."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed or e.data is not None or \
                    e.spilled_path is None:
                return False
            if os.path.exists(_parse_spill_url(e.spilled_path)[0]):
                return False        # readable after all
            del self._entries[object_id]
            self.stats["vanished_objects"] = \
                self.stats.get("vanished_objects", 0) + 1
            self._release_spill_region_locked(object_id, e.spilled_path)
            self._lock.notify_all()
        return True

    def delete(self, object_id: ObjectID):
        with self._lock:
            e = self._entries.pop(object_id, None)
            if e is None:
                return
            # An entry holds budget while its bytes are in memory;
            # spilled entries released theirs at spill.
            if e.data is not None:
                self._used -= e.size
            if e.spilled_path:
                self._release_spill_region_locked(object_id,
                                                  e.spilled_path)
            # Freed budget may admit a queued create request.
            self._lock.notify_all()

    def _release_spill_region_locked(self, object_id: ObjectID,
                                     url: str) -> None:
        """Drop ``object_id``'s claim on its spill file; a fused batch
        file is unlinked only when its last live object goes."""
        path, _, _ = _parse_spill_url(url)
        live = self._spill_files.get(path)
        if live is not None:
            live.discard(object_id)
            if live:
                return
            del self._spill_files[path]
        try:
            os.unlink(path)
        except OSError:
            pass

    # ---- capacity / spilling -------------------------------------------
    def _spillable_locked(self, e: _Entry) -> bool:
        """Spill candidate: sealed bytes in memory, no reader pins, not
        device-resident (``select_spill_victims`` and the inline spill
        never pick a device entry), not already being spilled by the
        spill thread."""
        return (e.data is not None and e.sealed and not e.is_device
                and e.pin_count == 0 and not e.spilling)

    def _spill_safe_locked(self, e: _Entry, now: float) -> bool:
        """Spillable and not touched within the last second: ``get()``
        returns the entry and callers read ``e.data`` without a pin, so
        a spill right after an access would race that read.  Only
        ``spill_now`` skips this guard."""
        return self._spillable_locked(e) and now - e.last_access > 1.0

    def _spill_toward_locked(self, target: int, incoming: int) -> None:
        """Inline LRU spill until ``used + reserved + incoming`` fits
        under ``target`` or candidates run out; a victim whose write
        fails is skipped."""
        now = time.monotonic()
        candidates = sorted(
            ((e.last_access, oid) for oid, e in self._entries.items()
             if self._spill_safe_locked(e, now)),
            key=lambda t: t[0])
        for _, oid in candidates:
            if self._used + self._transfer_reserved + incoming <= target:
                return
            e = self._entries.get(oid)
            if e is None or not self._spillable_locked(e):
                continue
            try:
                self._spill(oid, e)
            except OSError:
                self.stats["spill_errors"] += 1

    def _ensure_capacity(self, incoming: int, wait: bool = True) -> bool:
        """Admit a reservation of ``incoming`` bytes (must hold the
        lock).

        Under the spill threshold: admit.  Over it: a bare store spills
        inline toward the threshold; under hard capacity the request is
        admitted and the spill thread asked to work utilization back
        down.  Over capacity the request QUEUES on the store condition,
        releasing the lock, and is retried as deletes and spills free
        space, raising ObjectStoreFullError after the grace period.
        Returns True when the request waited (callers re-check what they
        read before the call)."""
        limit = int(self.capacity * self.spill_threshold)
        if self._used + self._transfer_reserved + incoming <= limit:
            return False
        if self._spill_manager is None:
            self._spill_toward_locked(limit, incoming)
        if self._used + self._transfer_reserved + incoming <= \
                self.capacity:
            if self._spill_manager is not None:
                self._spill_manager.request_spill()
            return False
        if incoming > self.capacity:
            raise self._full_error(incoming, infeasible=True)
        if not wait:
            raise self._full_error(incoming)
        cfg = get_config()
        deadline = time.monotonic() + cfg.object_store_full_grace_period_s
        retry_s = max(cfg.object_store_full_retry_ms, 1) / 1000.0
        self._create_waiters += 1
        self._queued_bytes += incoming
        self.stats["queued_creates"] += 1
        t0 = time.monotonic()
        try:
            while self._used + self._transfer_reserved + incoming > \
                    self.capacity:
                if self._spill_manager is not None:
                    # The spill thread frees space; each finished batch
                    # wakes this wait.
                    self._spill_manager.request_spill()
                else:
                    self._spill_toward_locked(limit, incoming)
                if self._used + self._transfer_reserved + incoming <= \
                        self.capacity:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.stats["create_queue_timeouts"] += 1
                    raise self._full_error(incoming, queued=True)
                self._lock.wait(timeout=min(remaining, retry_s))
        finally:
            self._create_waiters -= 1
            self._queued_bytes -= incoming
            self.stats["create_queue_wait_ms"] += \
                (time.monotonic() - t0) * 1000.0
        return True

    def _full_error(self, incoming: int, infeasible: bool = False,
                    queued: bool = False) -> exceptions.ObjectStoreFullError:
        """Actionable context: capacity against the request, in-flight
        reservations, what is evictable, the queue's depth."""
        nid = getattr(self.node_id, "hex",
                      lambda: str(self.node_id))()[:12]
        evictable = sum(e.size for e in self._entries.values()
                        if self._spillable_locked(e))
        msg = (f"cannot reserve {incoming} bytes on node {nid}: "
               f"{self._used}/{self.capacity} bytes used, "
               f"{self._transfer_reserved} reserved by in-flight "
               f"transfers, {evictable} evictable, "
               f"{self._create_waiters} queued create(s)")
        if infeasible:
            msg += ("; the object exceeds total store capacity and can "
                    "NEVER fit — raise object_store_memory")
        elif queued:
            grace = get_config().object_store_full_grace_period_s
            msg += (f"; queued {grace}s (object_store_full_grace_period"
                    f"_s) without space freeing — raise "
                    f"object_store_memory, lower "
                    f"object_spilling_threshold, or check spill_dir "
                    f"{self.spill_dir}")
        err = exceptions.ObjectStoreFullError(msg)
        # Pulls must not retry an object that can never fit.
        err.infeasible = bool(infeasible)
        return err

    def _spill(self, object_id: ObjectID, e: _Entry):
        """Synchronous single-object spill (must hold the lock).
        Re-spilling a restored entry is free: its bytes are on disk
        already."""
        if e.spilled_path is not None:
            if e.data is not None:
                e.data = None
                self._used -= e.size
                self.stats["spilled_objects"] += 1
                self._lock.notify_all()
            return
        data = e.data
        if isinstance(data, DeviceObject):
            # Only a direct call spills a device entry: its host form
            # goes to disk, and a restore reads it back as host bytes.
            data = data.to_serialized()
            e.is_device = False
        path = os.path.join(self.spill_dir, object_id.hex())
        with open(path, "wb") as f:
            nbytes = write_flat(f, data)
        self._register_spill_locked(object_id, e, path, 0, nbytes)

    def _register_spill_locked(self, object_id: ObjectID, e: _Entry,
                               path: str, offset: int,
                               nbytes: int) -> None:
        """Publish a completed spill: record the URL, release the
        budget, wake queued creates, report the URL to the owner."""
        url = _spill_url(path, offset, nbytes)
        e.spilled_path = url
        e.data = None
        e.spilling = False
        self._used -= e.size
        self._spill_files.setdefault(path, set()).add(object_id)
        self.stats["spilled_bytes"] += nbytes
        self.stats["spilled_objects"] += 1
        self._lock.notify_all()
        if self._on_spilled is not None:
            self._on_spilled(object_id, url)

    def _restore(self, object_id: ObjectID, e: _Entry):
        path, offset, size = _parse_spill_url(e.spilled_path)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                head = f.read(min(size, 64 * 1024))
                blob = aligned_flat_buffer(size, head)
                blob[:len(head)] = head
                got = len(head) + (f.readinto(blob[len(head):])
                                   if size > len(head) else 0)
        except OSError as err:
            raise ObjectVanishedError(
                f"spill file of {object_id} is gone: {err}") from err
        if got != size:
            raise ObjectVanishedError(
                f"spill file of {object_id} holds {got} of its {size} "
                "bytes")
        e.data = SerializedObject.from_bytes(blob.toreadonly())
        self._used += e.size
        self.stats["restored_bytes"] += size
        self.stats["restored_objects"] += 1
        # A restore re-charges the budget without a capacity gate (a get
        # must not deadlock on its own store): the spill thread works
        # the overshoot back down.
        if self._spill_manager is not None and \
                self._used + self._transfer_reserved > \
                int(self.capacity * self.spill_threshold):
            self._spill_manager.request_spill()

    # ---- the spill thread's batch surface (LocalObjectManager) ---------
    def select_spill_victims(self, max_bytes: int):
        """Pick LRU spill candidates totalling up to ``max_bytes`` (at
        least one if any exists) and mark them ``spilling``, so that the
        copy-out runs outside the store lock.  Returns
        ``[(object_id, entry, SerializedObject)]``.  Restored entries
        that are spillable again re-spill for free here."""
        out = []
        with self._lock:
            now = time.monotonic()
            candidates = sorted(
                ((e.last_access, oid) for oid, e in self._entries.items()
                 if self._spill_safe_locked(e, now)
                 and e.spilled_path is None),
                key=lambda t: t[0])
            total = 0
            for _, oid in candidates:
                if out and total >= max_bytes:
                    break
                e = self._entries[oid]
                e.spilling = True
                total += e.size
                out.append((oid, e, e.data))
            for oid, e in list(self._entries.items()):
                if (e.spilled_path is not None and e.data is not None
                        and self._spill_safe_locked(e, now)):
                    self._spill(oid, e)
        return out

    def finish_spill_batch(self, path: str, results) -> int:
        """Finalize a batch: ``results`` is
        ``[(object_id, entry, offset, nbytes, ok)]``.  Entries deleted
        mid-copy are skipped (the delete won).  Returns the number of
        entries that became spilled."""
        done = 0
        with self._lock:
            for object_id, e, offset, nbytes, ok in results:
                if self._entries.get(object_id) is not e:
                    e.spilling = False
                    continue
                if not ok:
                    e.spilling = False
                    self.stats["spill_errors"] += 1
                    continue
                self._register_spill_locked(object_id, e, path, offset,
                                            nbytes)
                done += 1
            self._lock.notify_all()
        return done

    def spill_shortfall(self) -> int:
        """Bytes over the spill threshold (<= 0 when under it), the
        queued creates' bytes counted in.  The reference leaves them
        out, so a put of more than the headroom above the threshold
        (a fifth of the store by default), arriving under it, waits for
        a spill that never starts and fails after the grace period
        (ROADMAP C.5)."""
        with self._lock:
            return (self._used + self._transfer_reserved
                    + self._queued_bytes
                    - int(self.capacity * self.spill_threshold))

    def open_spilled_view(self, object_id: ObjectID):
        """A read surface over a spilled object that restores nothing:
        an mmap of its spill-file region, so a transfer is served
        straight from disk.  Returns ``(memoryview, release)`` or
        None."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or not e.sealed or e.spilled_path is None \
                    or e.data is not None:
                return None
            url = e.spilled_path
        path, offset, size = _parse_spill_url(url)
        try:
            f = open(path, "rb")
        except OSError:
            return None              # deleted in the window
        try:
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        except (OSError, ValueError):
            return None
        finally:
            f.close()                # the mmap holds the file
        view = memoryview(mm)[offset:offset + size]

        def release(mm=mm, view=view):
            try:
                view.release()
                mm.close()
            except BufferError:
                pass    # a slice is still alive: the mmap closes at GC

        return view, release

    # ---- chunk relay ----------------------------------------------------
    def _register_partial(self, object_id: ObjectID, nbytes: int,
                          read_raw) -> _PartialTransfer:
        """Publish an in-flight transfer as relayable (called by the
        writer that holds the single-writer claim)."""
        p = _PartialTransfer(self, object_id, nbytes, read_raw)
        with self._lock:
            self._partials[object_id] = p
        return p

    def _unregister_partial(self, object_id: ObjectID,
                            p: _PartialTransfer) -> None:
        with self._lock:
            if self._partials.get(object_id) is p:
                del self._partials[object_id]

    def open_relay_source(self, object_id: ObjectID
                          ) -> Optional[_PartialTransfer]:
        """The relay read surface over an in-flight transfer of
        ``object_id``, or None when nothing is being assembled here.
        It stays valid past seal and abort."""
        with self._lock:
            return self._partials.get(object_id)

    def num_partials(self) -> int:
        with self._lock:
            return len(self._partials)

    def read_sealed_range(self, object_id: ObjectID, start: int,
                          end: int) -> Optional[bytes]:
        """A byte range of a sealed object that has a range read: a
        spilled object, from its spill file.  None otherwise (the relay
        caller flattens the object once and caches it)."""
        spilled = self.open_spilled_view(object_id)
        if spilled is None:
            return None
        view, release = spilled
        try:
            return bytes(view[start:end])
        finally:
            release()

    def spill_now(self) -> int:
        """Force-spill every spillable entry (test hook); reader-pinned
        entries are refused."""
        n = 0
        with self._lock:
            for oid, e in list(self._entries.items()):
                if self._spillable_locked(e):
                    try:
                        self._spill(oid, e)
                    except OSError:
                        self.stats["spill_errors"] += 1
                        continue
                    n += 1
        return n

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def num_objects(self) -> int:
        with self._lock:
            return len(self._entries)

    def close(self) -> None:
        """Drop every entry and spill file and the spill directory (the
        raylet's shutdown, after its spill thread stopped): a removed
        node's copies are unreachable, and its memory and disk go with
        it."""
        with self._lock:
            self._entries.clear()
            self._used = 0
            paths, self._spill_files = list(self._spill_files), {}
            self._lock.notify_all()
        for path in paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        try:
            os.rmdir(self.spill_dir)
        except OSError:
            pass


class InPlasmaMarker:
    """Memory-store marker: the value's bytes live in a node store.

    Sealed into the owner's memory store when a large return lands in a
    node store, so that owner-side waits unblock at once (the
    reference's "in plasma" reply on the Get path)."""

    __slots__ = ("node_id", "total_bytes")

    def __init__(self, node_id):
        self.node_id = node_id
        self.total_bytes = 0


def _maybe_register_partial(store: NodeObjectStore, object_id: ObjectID,
                            nbytes: int,
                            read_raw) -> Optional[_PartialTransfer]:
    """Relay registration gate: multi-chunk transfers only, and only
    when relay is on (the naive arm stays relay-free)."""
    cfg = get_config()
    if not cfg.object_transfer_relay_enabled or \
            nbytes <= cfg.object_manager_chunk_size:
        return None
    return store._register_partial(object_id, nbytes, read_raw)


class _HeapTransferWriter:
    """Incoming-transfer sink: chunks are copied into a heap buffer at
    their final offsets, and ``seal`` stores the object over that
    buffer (its buffers are views of it, no second copy).  The buffer is
    allocated at the first chunk, which holds the flat form's header, so
    that the object's first buffer lands aligned
    (``aligned_flat_buffer``).  While in flight the assembled prefix is
    relayable; the relay read closes over the buffer itself, so late
    relay reads stay valid after seal."""

    __slots__ = ("_store", "_object_id", "nbytes", "_pin", "_buf",
                 "_reserved", "_partial")

    def __init__(self, store: NodeObjectStore, object_id: ObjectID,
                 nbytes: int, pin: bool):
        self._store = store
        self._object_id = object_id
        self.nbytes = nbytes
        self._pin = pin
        self._buf: Optional[memoryview] = None
        self._reserved = True
        self._partial = _maybe_register_partial(
            store, object_id, nbytes, self._read_raw)

    def _read_raw(self, start: int, end: int):
        return self._buf[start:end]

    def write(self, offset: int, data) -> None:
        if self._buf is None:
            self._buf = aligned_flat_buffer(
                self.nbytes, data if offset == 0 else b"")
        n = copy_into_view(self._buf, offset, data)
        if self._partial is not None:
            self._partial.advance(offset, n)

    def _release(self) -> None:
        if self._reserved:
            self._reserved = False
            self._store._release_transfer_reservation(self.nbytes,
                                                      self._object_id)

    def seal(self) -> None:
        store = self._store
        partial = self._partial
        if partial is not None:
            partial.quiesce_for_seal()
        sealed_ok = False
        try:
            # Inside the try: a corrupt payload must not leak the
            # reservation or the single-writer claim.  Read-only views:
            # a reader must not write into the stored copy.
            if self._buf is None:       # an empty object
                self._buf = aligned_flat_buffer(self.nbytes, b"")
            restored = SerializedObject.from_bytes(self._buf.toreadonly())
            if self._reserved:
                self._reserved = False
                # put() charges _used itself; the claim is held until
                # the entry is registered, so a waiting duplicate pull
                # adopts it.
                store._release_transfer_reservation(self.nbytes)
            store.put(self._object_id, restored, pin=self._pin)
            sealed_ok = True
        finally:
            with store._lock:
                if self._reserved:
                    self._reserved = False
                    store._transfer_reserved -= self.nbytes
                store._active_transfers.discard(self._object_id)
                store._lock.notify_all()
            if partial is not None:
                store._unregister_partial(self._object_id, partial)
                if sealed_ok:
                    partial.mark_sealed(raw_still_valid=True)
                else:
                    partial.mark_failed()

    def abort(self) -> None:
        partial = self._partial
        if partial is not None:
            self._store._unregister_partial(self._object_id, partial)
            partial.mark_failed()
        self._release()


class ObjectVanishedError(LookupError):
    """An entry's bytes were gone when it was read (a spill file removed
    underneath).  Callers treat it as a store miss and re-resolve."""


def entry_value(entry: _Entry):
    """Deserialize an entry to its Python value (raising stored
    errors)."""
    if entry.error is not None:
        raise entry.error
    data = entry.data
    if data is None:
        raise ObjectVanishedError(f"{entry!r} was spilled mid-read")
    if isinstance(data, DeviceObject):
        return data.value
    return deserialize(data)
