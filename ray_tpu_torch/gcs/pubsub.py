"""Pubsub: a batched publisher with per-subscriber mailboxes.

A port of ``ray_tpu.gcs.pubsub`` (reference ``src/ray/pubsub/``): a
subscriber takes one key or a whole channel; with an event loop, a
publish appends to each target subscriber's mailbox and posts a drain
only for subscribers whose drain is not already pending, so a burst of
K messages costs one loop post a subscriber, in FIFO order, callbacks
run on the loop outside the publisher's lock.  Without a loop (the
GCS's own publisher) a publish calls the subscribers inline.

Where the reference notes a failed subscriber callback on its debug
plane (``swallow.noted``, ROADMAP A.4b.7), this publisher logs it and
counts it in ``stats["subscriber_errors"]``: the fan-out goes on.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# Channel names (pubsub.proto ChannelType).
ACTOR_CHANNEL = "ACTOR"
NODE_CHANNEL = "NODE"
WORKER_FAILURE_CHANNEL = "WORKER_FAILURE"
OBJECT_LOCATION_CHANNEL = "OBJECT_LOCATION"
JOB_CHANNEL = "JOB"
ERROR_INFO_CHANNEL = "ERROR_INFO"
RESOURCE_USAGE_CHANNEL = "RESOURCE_USAGE"
TASK_EVENT_CHANNEL = "TASK_EVENT"
TIMELINE_CHANNEL = "TIMELINE"


class Publisher:
    def __init__(self, event_loop=None):
        self._lock = threading.RLock()
        # (channel, key or None) -> {subscriber_id: callback}
        self._subs: Dict[Tuple[str, Optional[bytes]], Dict[int, Callable]] = {}
        self._next_id = 0
        self._loop = event_loop
        # subscriber_id -> [callback, [(key, message), ...]]; _scheduled
        # holds the subscribers with a drain post in flight.
        self._mailboxes: Dict[int, list] = {}
        self._scheduled: set = set()
        self.stats = {"published": 0, "drain_posts": 0,
                      "subscriber_errors": 0}

    def subscribe(self, channel: str, key: Optional[bytes],
                  callback: Callable[[bytes, Any], None]) -> int:
        """Subscribe to one key, or to the whole channel with key=None."""
        with self._lock:
            self._next_id += 1
            sid = self._next_id
            self._subs.setdefault((channel, key), {})[sid] = callback
            return sid

    def unsubscribe(self, channel: str, key: Optional[bytes], sub_id: int):
        with self._lock:
            subs = self._subs.get((channel, key))
            if subs:
                subs.pop(sub_id, None)
            # Queued, undrained messages die with the subscription.
            self._mailboxes.pop(sub_id, None)
            self._scheduled.discard(sub_id)

    def _deliver(self, cb, key, message) -> None:
        try:
            cb(key, message)
        except Exception:
            self.stats["subscriber_errors"] += 1
            logger.exception("pubsub subscriber failed")

    def _drain(self, sid: int):
        """One coalesced delivery for one subscriber: everything queued
        since its drain was scheduled, run outside the lock."""
        with self._lock:
            self._scheduled.discard(sid)
            box = self._mailboxes.get(sid)
            if not box or not box[1]:
                return
            cb, batch = box[0], box[1]
            box[1] = []
        for key, message in batch:
            self._deliver(cb, key, message)

    def publish(self, channel: str, key: bytes, message: Any):
        if self._loop is None:
            with self._lock:
                targets = list(self._subs.get((channel, key), {}).values())
                targets += list(self._subs.get((channel, None),
                                               {}).values())
                self.stats["published"] += 1
            for cb in targets:
                self._deliver(cb, key, message)
            return
        if getattr(self._loop, "_stopped", False):
            return    # shutdown: no drain would run
        need_post = []
        with self._lock:
            self.stats["published"] += 1
            pairs = list(self._subs.get((channel, key), {}).items())
            pairs += list(self._subs.get((channel, None), {}).items())
            for sid, cb in pairs:
                box = self._mailboxes.get(sid)
                if box is None:
                    box = self._mailboxes[sid] = [cb, []]
                box[1].append((key, message))
                if sid not in self._scheduled:
                    self._scheduled.add(sid)
                    need_post.append(sid)
            self.stats["drain_posts"] += len(need_post)
        for sid in need_post:
            self._loop.post(lambda sid=sid: self._drain(sid),
                            name="pubsub.drain")
