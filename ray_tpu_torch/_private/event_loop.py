"""Instrumented event loops.

A copy of ``ray_tpu._private.event_loop`` for the PyTorch port: a thread
with a queue of posted handlers and a timer heap, per-handler stats
(``handler_stats``), the post-to-run lag and the slowest handler, all
exported at scrape time through the port's metrics registry under the
reference's names.  The reference's stall watchdog, its fault-injection
point and its lock-order witness are debug planes the port does not
have yet.

Divergence: ``schedule_every(..., catch_up=n)`` keeps a timer on its
period's grid: a late run does not push the next one back, and up to
``n`` runs that a busy loop missed run at once, one after another; a
longer pause loses the rest.  The GCS's heartbeat check uses it, so that
its count of missed beats keeps up with the periods however late the
loop's thread got the interpreter lock, while a pause of the whole
process (a long hold of the lock, when no beat could be sent either)
counts a few periods only; the reference's timers all drift by each
run's lateness.

Divergence: the reference prints a handler's exception and goes on.
This loop goes on too, and also counts the failure, in
``handler_stats[name]["errors"]`` and the
``ray_tpu.event_loop.handler_errors`` gauge, so that a failed scheduling
tick cannot vanish.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Callable, Dict, Optional

from ray_tpu_torch._private import thread_registry
from ray_tpu_torch._private.metrics_agent import (get_metrics_registry,
                                                  record_internal)

logger = logging.getLogger(__name__)


class EventLoop:
    def __init__(self, name: str = "loop"):
        self.name = name
        self._cond = threading.Condition()
        self._queue = []            # (name, fn, t_posted) immediate handlers
        # (deadline, seq, period, name, fn, catch_up)
        self._timers = []
        self._seq = 0
        self._stopped = False
        self.handler_stats: Dict[str, dict] = {}
        # Post-to-run lag and the slowest handler: plain accumulation on
        # the loop thread, rendered by the collector.
        self.lag_count = 0
        self.lag_sum_s = 0.0
        self.lag_max_s = 0.0
        self.slowest_handler_s = 0.0
        get_metrics_registry().register_collector(self, _collect)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ray_tpu_torch::{name}")
        self._thread.start()

    def post(self, fn: Callable, name: str = "anon"):
        with self._cond:
            if self._stopped:
                return
            self._queue.append((name, fn, time.monotonic()))
            self._cond.notify()

    def schedule_every(self, period_s: float, fn: Callable, name: str,
                       catch_up: Optional[int] = None):
        """Periodic timer, rescheduled after each run: ``period_s`` after
        the run's start, or, with ``catch_up``, at the next point of the
        period's grid, which may be past already (at most ``catch_up``
        missed runs are made up)."""
        with self._cond:
            if self._stopped:
                return
            self._seq += 1
            heapq.heappush(self._timers,
                           (time.monotonic() + period_s, self._seq,
                            period_s, name, fn, catch_up))
            self._cond.notify()

    def schedule_after(self, delay_s: float, fn: Callable,
                       name: str = "timer"):
        with self._cond:
            if self._stopped:
                return
            self._seq += 1
            heapq.heappush(self._timers,
                           (time.monotonic() + delay_s, self._seq,
                            None, name, fn, None))
            self._cond.notify()

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2)

    def _record(self, name: str, elapsed: float, failed: bool):
        st = self.handler_stats.setdefault(
            name, {"count": 0, "total_s": 0.0, "max_s": 0.0, "errors": 0})
        st["count"] += 1
        st["total_s"] += elapsed
        st["max_s"] = max(st["max_s"], elapsed)
        st["errors"] += failed
        self.slowest_handler_s = max(self.slowest_handler_s, elapsed)

    def _run(self):
        # This thread IS the "<kind>" loop for the @loop_only checks;
        # unregistered on exit, since the OS reuses thread idents.
        thread_registry.register_current(self.name)
        try:
            self._run_inner()
        finally:
            thread_registry.unregister_current()

    def _run_inner(self):
        while True:
            posted_at = None
            with self._cond:
                while not self._stopped:
                    now = time.monotonic()
                    if self._queue:
                        name, fn, posted_at = self._queue.pop(0)
                        break
                    if self._timers and self._timers[0][0] <= now:
                        deadline, _, period, name, fn, catch_up = \
                            heapq.heappop(self._timers)
                        if period is not None:
                            nxt = now + period if catch_up is None else \
                                max(deadline, now - catch_up * period) \
                                + period
                            self._seq += 1
                            heapq.heappush(
                                self._timers,
                                (nxt, self._seq, period, name, fn,
                                 catch_up))
                        break
                    timeout = None
                    if self._timers:
                        timeout = max(0.0, self._timers[0][0] - now)
                    self._cond.wait(timeout=timeout)
                if self._stopped:
                    return
            t0 = time.monotonic()
            if posted_at is not None:
                lag = t0 - posted_at
                self.lag_count += 1
                self.lag_sum_s += lag
                if lag > self.lag_max_s:
                    self.lag_max_s = lag
            failed = False
            try:
                fn()
            except Exception:
                # The loop must keep serving its other handlers: log the
                # traceback and count the failure for /metrics.
                failed = True
                logger.exception("event loop %s: handler %s failed",
                                 self.name, name)
            self._record(name, time.monotonic() - t0, failed)


def _collect(loop: EventLoop) -> None:
    """Scrape-time collector: per-handler stats and the lag gauges,
    cumulative values exported as gauges (a collector re-runs per
    exposition, so a counter's inc would double-count)."""
    label = {"loop": loop.name}
    for handler, st in list(loop.handler_stats.items()):
        hl = dict(label, handler=handler)
        record_internal("ray_tpu.event_loop.handler_count", st["count"], **hl)
        record_internal("ray_tpu.event_loop.handler_total_s", st["total_s"],
                        **hl)
        record_internal("ray_tpu.event_loop.handler_max_s", st["max_s"], **hl)
        record_internal("ray_tpu.event_loop.handler_errors", st["errors"],
                        **hl)
    record_internal("ray_tpu.event_loop.queue_depth", len(loop._queue),
                    **label)
    record_internal("ray_tpu.event_loop.lag_max_s", loop.lag_max_s, **label)
    record_internal("ray_tpu.event_loop.lag_mean_s",
                    loop.lag_sum_s / loop.lag_count if loop.lag_count
                    else 0.0, **label)
    record_internal("ray_tpu.event_loop.slowest_handler_s",
                    loop.slowest_handler_s, **label)
