"""The object directory and the pull path between node stores.

A port of the in-process half of ``ray_tpu._private.object_manager`` for
the PyTorch port (reference ``src/ray/object_manager/``): the
``ObjectDirectory`` (where each object's full copies are, the size of
each, and the PARTIAL rows of nodes mid-pull that can relay what they
have assembled) and the ``NodeObjectManager`` of one raylet, whose
pulls (``PullManager``) run on a pool of four threads: deduplicated per
object, subscribed to the directory and the owner's memory store when
no copy exists yet, choosing among sources by their live outbound load
under each source's ``TransferLedger``, and chaining off a peer's
in-flight transfer (chunk relay), so that a 1->N broadcast completes as
a pipeline and not as N copies out of the origin.

One divergence: a python-held source (the port's only kind; the
reference's ``_copy_via_serialized`` leg) is copied chunk by chunk
into a transfer writer over its flat form (``flat_chunks``), as the
reference copies a segment block, so that its pulls are admitted,
relayed and counted as the reference's default store's are; a spilled
source is served from its spill file either way.

The cross-process fetch (``fetch_object_into`` and the wire leg of
``_fetch_from``) comes with process workers; the reference's tracing
span, fault point and flight recorder are its debug planes (ROADMAP
A.4b.7).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.daemon_pool import DaemonPool
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  observe_internal,
                                                  record_internal)
from ray_tpu_torch._private.object_store import InPlasmaMarker


class ObjectDirectory:
    """Object location directory (ownership-based in the reference; the
    owner's table lives with the driver's core worker and this is its
    queryable index)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._locations: Dict[ObjectID, Set[NodeID]] = {}
        # Serialized bytes per object, recorded with its first location:
        # the arg-locality cost weighs nodes by these.
        self._sizes: Dict[ObjectID, int] = {}
        self._subscribers: Dict[ObjectID, List[Callable]] = {}
        # PARTIAL rows (chunk relay): node -> registration seq, for
        # nodes mid-pull of an object.  Never returned by get_locations,
        # only by get_candidates.
        self._partials: Dict[ObjectID, Dict[NodeID, int]] = {}
        self._partial_seq: Dict[ObjectID, int] = {}

    def add_partial_location(self, object_id: ObjectID,
                             node_id: NodeID) -> int:
        """Register ``node_id`` as mid-pull of the object.  Returns the
        row's per-object sequence number: a puller relays only from rows
        with a lower seq than its own, so chains have no cycle."""
        with self._lock:
            seq = self._partial_seq.get(object_id, 0) + 1
            self._partial_seq[object_id] = seq
            self._partials.setdefault(object_id, {})[node_id] = seq
        return seq

    def remove_partial_location(self, object_id: ObjectID,
                                node_id: NodeID):
        """Drop a partial row.  The object's seq counter stays while it
        lives, so a new row never reuses a seq a puller compares
        against."""
        with self._lock:
            rows = self._partials.get(object_id)
            if rows:
                rows.pop(node_id, None)
                if not rows:
                    del self._partials[object_id]

    def get_candidates(self, object_id: ObjectID) -> List[dict]:
        """Every source a pull may stream from: full rows
        (``partial=False, seq=0``) and partial rows with their seq, each
        with the object's size hint."""
        with self._lock:
            size = self._sizes.get(object_id, 0)
            full = self._locations.get(object_id, set())
            out = [{"node_id": n, "partial": False, "seq": 0,
                    "size": size}
                   for n in full]
            for n, seq in (self._partials.get(object_id) or {}).items():
                if n not in full:
                    out.append({"node_id": n, "partial": True,
                                "seq": seq, "size": size})
        return out

    def add_location(self, object_id: ObjectID, node_id: NodeID,
                     size: Optional[int] = None):
        with self._lock:
            self._locations.setdefault(object_id, set()).add(node_id)
            if size:
                self._sizes[object_id] = int(size)
            subs = self._subscribers.pop(object_id, [])
        for cb in subs:
            cb(node_id)

    def size_hint(self, object_id: ObjectID) -> int:
        """Serialized bytes of the object, or 0 when unknown (inline
        objects never register: they cost nothing to move)."""
        with self._lock:
            return self._sizes.get(object_id, 0)

    def remove_location(self, object_id: ObjectID, node_id: NodeID):
        with self._lock:
            locs = self._locations.get(object_id)
            if locs:
                locs.discard(node_id)
                if not locs:
                    del self._locations[object_id]
                    self._sizes.pop(object_id, None)

    def remove_object(self, object_id: ObjectID):
        with self._lock:
            self._locations.pop(object_id, None)
            self._sizes.pop(object_id, None)
            self._partials.pop(object_id, None)
            self._partial_seq.pop(object_id, None)
            # A freed object never gains a location: drop its waiters.
            self._subscribers.pop(object_id, None)

    def get_locations(self, object_id: ObjectID) -> Set[NodeID]:
        with self._lock:
            return set(self._locations.get(object_id, ()))

    def subscribe_location(self, object_id: ObjectID, cb: Callable):
        """``cb(node_id)`` when the first location appears (at once if
        one exists)."""
        with self._lock:
            locs = self._locations.get(object_id)
            if locs:
                node = next(iter(locs))
            else:
                self._subscribers.setdefault(object_id, []).append(cb)
                return
        cb(node)

    def unsubscribe_location(self, object_id: ObjectID, cb: Callable):
        """Deregister a pending subscription (no-op if it fired)."""
        with self._lock:
            subs = self._subscribers.get(object_id)
            if subs is None:
                return
            try:
                subs.remove(cb)
            except ValueError:
                return
            if not subs:
                del self._subscribers[object_id]

    def on_node_death(self, node_id: NodeID) -> List[ObjectID]:
        """Remove every location on a dead node; returns the objects
        that lost their last copy (candidates for reconstruction)."""
        lost = []
        with self._lock:
            for oid, locs in list(self._locations.items()):
                if node_id in locs:
                    locs.discard(node_id)
                    if not locs:
                        del self._locations[oid]
                        self._sizes.pop(oid, None)
                        lost.append(oid)
            # A dead node relays nothing.
            for oid, rows in list(self._partials.items()):
                if rows.pop(node_id, None) is not None and not rows:
                    del self._partials[oid]
        return lost


class NodeObjectManager:
    """One raylet's pulls (PullManager/PushManager parity)."""

    #: Bounded pull rounds: each consumes one candidate source (or one
    #: reset of the tried set); a pull that cannot land in this many
    #: fails, and lineage recovery decides what follows.
    MAX_SOURCE_ROUNDS = 16
    #: The source was merely busy and a freer one exists: select again
    #: without marking it failed.
    _RESELECT = object()

    def __init__(self, raylet, directory: ObjectDirectory):
        self._raylet = raylet
        self._directory = directory
        self._lock = threading.Lock()
        self._inflight_pulls: Dict[ObjectID, List[Callable]] = {}
        # Transfers run on their own threads: a large pull on the
        # raylet's loop would stall its ticks.
        self._pull_pool = DaemonPool(
            4, name=f"ray_tpu_torch::pull::{raylet.node_id.hex()[:6]}")
        self.stats = {"pulled_objects": 0, "pulled_bytes": 0,
                      # Bytes fetched from OTHER nodes for local work:
                      # what the arg-locality cost should shrink.
                      "cross_node_fetch_bytes": 0,
                      "chunks_transferred": 0, "failed_pulls": 0,
                      "transfer_gbps_last": 0.0,
                      # Pulls streamed from a relay (partial) source, and
                      # admission waits left for a less-loaded source.
                      "relay_pulls": 0, "load_reselects": 0}
        nid = raylet.node_id.hex()[:12]

        def _collect(om):
            labels = {"node": nid}
            for k, v in list(om.stats.items()):
                record_internal(f"ray_tpu.object_manager.{k}", v, **labels)
        get_metrics_registry().register_collector(self, _collect)

    # ---- queries --------------------------------------------------------
    def is_local_or_inline(self, object_id: ObjectID) -> bool:
        if self._raylet.object_store.contains(object_id):
            return True
        # Small objects live in the owner's memory store, readable from
        # any node in-process; an InPlasmaMarker does not count: its
        # bytes are on some node and must be pulled.
        core = self._raylet.core_worker
        if core is None:
            return False
        entry = core.memory_store.get_entry(object_id)
        return entry is not None and entry.sealed and \
            not isinstance(entry.data, InPlasmaMarker)

    # ---- pull path ------------------------------------------------------
    def pull_async(self, object_id: ObjectID, cb: Callable[[bool], None]):
        """Make the object local; ``cb(ok)`` once it is (or the pull
        failed).  One pull per object at a time: later callers join
        it."""
        if self.is_local_or_inline(object_id):
            cb(True)
            return
        with self._lock:
            waiters = self._inflight_pulls.get(object_id)
            if waiters is not None:
                waiters.append(cb)
                return
            self._inflight_pulls[object_id] = [cb]

        def finish(ok: bool):
            with self._lock:
                waiters = self._inflight_pulls.pop(object_id, None)
            if waiters is None:
                return  # another path already finished this pull
            for w in waiters:
                w(ok)

        def attempt(_hint=None):
            if self.is_local_or_inline(object_id):
                finish(True)
                return
            # finish() runs however the transfer dies: an escaped
            # exception would leave every waiter hung.
            try:
                ok = self._pull_once(object_id)
            except Exception:
                ok = False
            finish(ok)

        def submit(*args):
            try:
                self._pull_pool.submit(attempt, *args)
            except RuntimeError:
                finish(False)         # the raylet is shutting down

        if self._directory.get_candidates(object_id):
            submit()
            return
        # A freed object is never produced again: fail at once (the
        # caller may try lineage reconstruction).
        core = self._raylet.core_worker
        if core is not None and \
                not core.reference_counter.has_reference(object_id) and \
                not core.task_manager.is_pending(object_id.task_id()):
            finish(False)
            return
        # No location yet: the object may still be computing.  Watch
        # the directory (big objects land in a node store) and the
        # owner's memory store (small returns), first one wins.
        self._directory.subscribe_location(object_id, submit)
        if core is not None:
            core.memory_store.get_async(object_id,
                                        lambda entry: finish(True))

    def stop(self):
        self._pull_pool.stop()

    # ---- source selection (load-aware, relay-capable) -------------------
    def _source_store(self, node_id: NodeID):
        raylet = self._raylet.cluster.raylet(node_id)
        return None if raylet is None else raylet.object_store

    def _source_load(self, row: dict):
        """Live outbound load of a candidate source, from its ledger."""
        store = self._source_store(row["node_id"])
        return (0, 0) if store is None \
            else store.transfer_ledger.load_score()

    def _source_has_free_slot(self, row: dict) -> bool:
        store = self._source_store(row["node_id"])
        return store is not None and store.transfer_ledger.has_free_slot()

    def _select_source(self, object_id: ObjectID, tried: set,
                       my_seq: Optional[int],
                       require_free: bool = False,
                       rows: Optional[List[dict]] = None
                       ) -> Optional[dict]:
        """The candidate row to pull from, or None: the least outbound
        load wins, so concurrent pulls of one object spread over every
        node that holds it; a PARTIAL row qualifies only with a lower
        seq than ours, and ties go to the highest seq (the deepest link
        of the chain).  ``require_free`` keeps only sources with a free
        admission slot now (the probe while queued; "load" mode only)."""
        cfg = get_config()
        if require_free and \
                cfg.object_transfer_source_selection != "load":
            return None
        local_id = self._raylet.node_id
        allow_partial = cfg.object_transfer_relay_enabled and \
            my_seq is not None
        usable = []
        if rows is None:
            rows = self._directory.get_candidates(object_id)
        for row in rows:
            nid = row["node_id"]
            if nid is None or nid in tried:
                continue
            if nid == local_id:
                # A stale self-row (our copy was dropped after it was
                # written): drop it.  Our own partial row is skipped.
                if not row.get("partial") and \
                        not self._raylet.object_store.contains(object_id):
                    self._directory.remove_location(object_id, local_id)
                continue
            if row.get("partial"):
                if not allow_partial or row.get("seq", 0) >= my_seq:
                    continue
            usable.append(row)
        if not usable:
            return None
        if cfg.object_transfer_source_selection != "load":
            # Naive arm: the first full row.
            for row in usable:
                if not row.get("partial"):
                    return row
            return usable[0]
        if require_free:
            usable = [r for r in usable if self._source_has_free_slot(r)]
            if not usable:
                return None
        return min(usable,
                   key=lambda r: (self._source_load(r),
                                  -int(r.get("seq", 0))))

    def _relay_worthwhile(self, object_id: ObjectID,
                          rows: List[dict]) -> bool:
        """Register a partial row only for multi-chunk objects (an
        unknown size, 0, registers)."""
        size = max((int(r.get("size") or 0) for r in rows), default=0)
        if size == 0:
            size = self._directory.size_hint(object_id)
        return size == 0 or size > get_config().object_manager_chunk_size

    def _pull_once(self, object_id: ObjectID) -> bool:
        """One complete pull: register our PARTIAL row first
        (downstream pullers can chain off our transfer), then stream
        from load-ranked sources until one delivers."""
        cfg = get_config()
        tried: set = set()
        my_seq = None
        local_id = self._raylet.node_id
        first_rows = self._directory.get_candidates(object_id)
        if cfg.object_transfer_relay_enabled and \
                self._relay_worthwhile(object_id, first_rows):
            my_seq = self._directory.add_partial_location(object_id,
                                                          local_id)
        try:
            reset_used = False
            partial_failures = 0
            for _round in range(self.MAX_SOURCE_ROUNDS):
                if self.is_local_or_inline(object_id):
                    return True
                # After two failed relay attempts, full rows only; the
                # last round takes full rows with unbounded patience, so
                # a healthy origin never fails a pull.
                final = _round >= self.MAX_SOURCE_ROUNDS - 1
                eff_seq = my_seq if partial_failures < 2 and not final \
                    else None
                rows = first_rows if first_rows is not None else \
                    self._directory.get_candidates(object_id)
                first_rows = None
                row = self._select_source(object_id, tried, eff_seq,
                                          rows=rows)
                if row is None:
                    if tried and not reset_used:
                        # Every candidate failed transiently: one fresh
                        # pass over the directory.
                        tried.clear()
                        reset_used = True
                        continue
                    # One last patient attempt on the best full row.
                    tried.clear()
                    last = self._select_source(object_id, tried, None)
                    if last is None:
                        return False
                    return self._fetch_from(object_id, last["node_id"],
                                            tried, None,
                                            others_available=False)
                target = row["node_id"]
                others = (not final) and self._select_source(
                    object_id, tried | {target}, eff_seq,
                    rows=rows) is not None
                if self._fetch_from(object_id, target, tried, eff_seq,
                                    others_available=others):
                    return True
                # Only a real relay failure counts (a reselect took the
                # busy target back out of ``tried``).
                if row.get("partial") and target in tried:
                    partial_failures += 1
            return False
        finally:
            if my_seq is not None:
                self._directory.remove_partial_location(object_id,
                                                        local_id)

    def _fetch_from(self, object_id: ObjectID, node_id: NodeID,
                    tried: set, my_seq: Optional[int] = None,
                    others_available: bool = False) -> bool:
        """Chunked copy of the object from ``node_id``'s store into the
        local one (ObjectBufferPool chunk assembly).  True only when the
        object is local afterwards; a False return leaves ``node_id`` in
        ``tried`` unless the source was merely busy."""
        tried.add(node_id)
        local_id = self._raylet.node_id
        if node_id == local_id or node_id is None:
            return self._raylet.object_store.contains(object_id)
        src = self._source_store(node_id)
        if src is None:
            return False            # the source died; try others
        t0 = time.monotonic()

        def on_chunk(nbytes: int):
            self.stats["chunks_transferred"] += 1

        nbytes = self._pull_in_process(object_id, src, node_id, tried,
                                       my_seq, on_chunk,
                                       allow_reselect=others_available)
        if nbytes is self._RESELECT:
            return False
        if nbytes is None:
            self.stats["failed_pulls"] += 1
            return False
        self.stats["pulled_objects"] += 1
        # The object is local either way.
        self._directory.add_location(object_id, local_id,
                                     size=nbytes or None)
        if nbytes:
            # 0 = a racing transfer's copy was adopted: this pull moved
            # no bytes.
            self.stats["pulled_bytes"] += nbytes
            self.stats["cross_node_fetch_bytes"] += nbytes
            elapsed = max(time.monotonic() - t0, 1e-9)
            self.stats["transfer_gbps_last"] = round(
                nbytes / elapsed / 1e9, 3)
            record_internal("ray_tpu.object_manager.transfer_gbps",
                            nbytes / elapsed / 1e9,
                            node=local_id.hex()[:12])
            observe_internal("ray_tpu.object_manager.transfer_seconds",
                             elapsed)
        return True

    def _pull_in_process(self, object_id: ObjectID, src, node_id: NodeID,
                         tried: set, my_seq: Optional[int], on_chunk,
                         allow_reselect: bool = True):
        """A store-to-store pull under the source's admission: queue
        FIFO on its ledger, but keep probing for a source with a free
        slot while queued (a relay one hop downstream beats waiting
        behind the origin, which is what turns a 1->N burst into a
        chain).  Returns the byte count, None on failure, or
        ``_RESELECT``."""
        ledger = src.transfer_ledger
        deadline = time.monotonic() + 300.0
        # One ticket for the whole wait: the FIFO place is kept across
        # the probes.
        ticket = ledger.enqueue()
        while not ledger.wait_grant(ticket, timeout=0.25):
            if time.monotonic() >= deadline or self._pull_pool.stopped:
                ledger.cancel(ticket)
                return None
            if not allow_reselect:
                continue        # the final patient round
            better = self._select_source(object_id, tried, my_seq,
                                         require_free=True)
            if better is not None:
                ledger.cancel(ticket)
                tried.discard(node_id)
                self.stats["load_reselects"] += 1
                return self._RESELECT
        try:
            relay = None
            if not src.contains(object_id):
                relay = src.open_relay_source(object_id)
            if relay is not None:
                nbytes = self._relay_copy_local(object_id, relay,
                                                on_chunk)
                if nbytes:
                    ledger.note_served(nbytes, relay=True)
                    self.stats["relay_pulls"] += 1
                return nbytes
            nbytes = self._copy_local(object_id, src, on_chunk)
            if nbytes:
                ledger.note_served(nbytes)
            return nbytes
        finally:
            ledger.release()

    def _relay_copy_local(self, object_id: ObjectID, relay,
                          on_chunk) -> Optional[int]:
        """Chunk-copy the assembled prefix of a peer's IN-FLIGHT
        transfer into a local writer, chasing its watermark.  An
        upstream abort fails this transfer cleanly (the caller
        re-selects); a stalled upstream is left after 60 s without
        progress."""
        nbytes = relay.nbytes
        writer = self._raylet.object_store.create_transfer_writer(
            object_id, nbytes)
        if writer is None:
            return 0             # a concurrent pull delivered it
        cfg = get_config()
        chunk = cfg.object_manager_chunk_size
        step_wait = max(cfg.object_transfer_relay_wait_s, 0.1)
        try:
            off = 0
            last_progress = time.monotonic()
            while off < nbytes:
                end = min(off + chunk, nbytes)
                try:
                    data = relay.read_range(off, end, timeout=step_wait)
                except TimeoutError:
                    if time.monotonic() - last_progress > 60.0 or \
                            self._pull_pool.stopped:
                        writer.abort()
                        return None
                    continue
                if data is None:          # the upstream transfer died
                    writer.abort()
                    return None
                writer.write(off, data)
                on_chunk(len(data))
                off = end
                last_progress = time.monotonic()
            writer.seal()
        except BaseException:
            writer.abort()
            raise
        return nbytes

    def _copy_local(self, object_id: ObjectID, src,
                    on_chunk) -> Optional[int]:
        """Store-to-store copy in chunks: a spilled source is served
        straight from its spill file (the sender restores nothing), a
        python-held one from its flat form (module docstring)."""
        chunk = get_config().object_manager_chunk_size
        spilled = src.open_spilled_view(object_id)
        if spilled is not None:
            view, release = spilled
            try:
                return self._chunk_copy_into_local(
                    object_id, view.nbytes,
                    ((off, view[off:off + chunk])
                     for off in range(0, view.nbytes, chunk)),
                    on_chunk)
            finally:
                release()
        serialized = src.get_serialized(object_id)
        if serialized is None:
            return None
        return self._chunk_copy_into_local(
            object_id, serialized.flat_nbytes,
            serialized.flat_chunks(chunk), on_chunk)

    def _chunk_copy_into_local(self, object_id: ObjectID, nbytes: int,
                               chunks, on_chunk) -> int:
        """Copy ``(offset, view)`` chunks of a flat source into a local
        transfer writer and seal it."""
        writer = self._raylet.object_store.create_transfer_writer(
            object_id, nbytes)
        if writer is None:
            return 0             # a concurrent pull delivered it
        try:
            for off, view in chunks:
                writer.write(off, view)
                on_chunk(view.nbytes)
            writer.seal()
        except BaseException:
            writer.abort()
            raise
        return nbytes
