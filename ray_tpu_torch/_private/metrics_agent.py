"""Process-wide metrics registry + Prometheus text exposition.

The registry half of ``ray_tpu._private.metrics_agent`` for the PyTorch
port: series, scrape-time collectors held by a weak reference to their
owner, and the Prometheus text rendering, with the same metric names,
types and labels.  The reference's cross-node delta shipping and head
federation belong to the GCS, which the port does not have yet.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)

_LabelKey = Tuple[Tuple[str, str], ...]

# Generic latency-shaped default buckets (seconds).
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


class _Hist:
    """Fixed-bucket histogram accumulator: O(buckets) memory however
    many observations land."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, num_buckets: int):
        self.counts = [0] * num_buckets     # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float, buckets) -> None:
        for i, b in enumerate(buckets):
            if value <= b:
                self.counts[i] += 1
                break
        self.sum += value
        self.count += 1


class MetricRecord:
    __slots__ = ("type", "description", "series", "buckets")

    def __init__(self, mtype: str, description: str, buckets=None):
        self.type = mtype
        self.description = description
        # label-tuple -> float (counter/gauge) or _Hist (histogram)
        self.series: Dict[_LabelKey, object] = {}
        self.buckets = buckets or []


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, MetricRecord] = {}
        # Scrape-time collectors: (weakref-to-owner, fn, written).
        # fn(owner) runs at every exposition and records through
        # record_internal, so hot paths only bump plain counters on
        # their own objects.
        self._collectors: List = []
        # While a collector runs, every series it writes is noted here
        # (thread-local), so the series die with the collector's owner.
        self._tracking = threading.local()

    def register_collector(self, owner, fn) -> None:
        """Call ``fn(owner)`` at every scrape while ``owner`` is alive;
        the entry, and every series it wrote, drops once the owner is
        collected."""
        with self._lock:
            self._collectors.append((weakref.ref(owner), fn, set()))

    def run_collectors(self) -> None:
        """Drop the entries of collected owners with the series they
        wrote, then run the live collectors.  In that order: a series
        that a dead owner and a live one both write (an unlabelled
        module-wide counter) is written again by the live one, where
        pruning after the run would take it out of this exposition."""
        with self._lock:
            live, dead = [], []
            for entry in self._collectors:
                (live if entry[0]() is not None else dead).append(entry)
            self._collectors = list(live)
            for _ref, _fn, written in dead:
                for name, labels in written:
                    rec = self._metrics.get(name)
                    if rec is not None:
                        rec.series.pop(labels, None)
        for ref, fn, written in live:
            owner = ref()
            if owner is None:
                continue
            self._tracking.keys = written
            try:
                fn(owner)
            except Exception:
                # One broken collector must not take the scrape down.
                logger.exception("metrics collector of %r failed", owner)
            finally:
                self._tracking.keys = None

    def _note_write(self, name: str, labels: _LabelKey) -> None:
        sink = getattr(self._tracking, "keys", None)
        if sink is not None:
            sink.add((name, labels))

    def claim_series(self, name: str, **labels) -> None:
        """Tie a series written outside a collector (a histogram
        observed on a hot path) to the collector now running, so it is
        pruned with that collector's owner."""
        self._note_write(name, tuple(sorted(labels.items())))

    def register(self, name: str, mtype: str, description: str = "",
                 buckets=None) -> None:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = MetricRecord(mtype, description,
                                                   buckets)

    def inc(self, name: str, value: float, labels: _LabelKey) -> None:
        self._note_write(name, labels)
        with self._lock:
            rec = self._metrics[name]
            rec.series[labels] = rec.series.get(labels, 0.0) + value

    def set(self, name: str, value: float, labels: _LabelKey) -> None:
        self._note_write(name, labels)
        with self._lock:
            self._metrics[name].series[labels] = value

    def observe(self, name: str, value: float, labels: _LabelKey) -> None:
        self._note_write(name, labels)
        with self._lock:
            rec = self._metrics[name]
            if not rec.buckets:
                rec.buckets = list(_DEFAULT_BUCKETS)
            h = rec.series.get(labels)
            if not isinstance(h, _Hist):
                h = rec.series[labels] = _Hist(len(rec.buckets))
            h.observe(value, rec.buckets)

    def get_value(self, name: str, labels: _LabelKey = ()):
        with self._lock:
            rec = self._metrics.get(name)
            if rec is None:
                return None
            return rec.series.get(labels)

    def snapshot(self) -> Dict[str, MetricRecord]:
        with self._lock:
            return dict(self._metrics)

    # ---- Prometheus text format ----------------------------------------
    def render_prometheus(self) -> str:
        self.run_collectors()
        out: List[str] = []
        for name, rec in sorted(self.snapshot().items()):
            pname = name.replace(".", "_")
            if rec.description:
                out.append(f"# HELP {pname} {rec.description}")
            out.append(f"# TYPE {pname} {rec.type}")
            for labels, val in sorted(rec.series.items()):
                lstr = ",".join(f'{k}="{v}"' for k, v in labels)
                lsuf = "{" + lstr + "}" if lstr else ""
                if rec.type != "histogram":
                    out.append(f"{pname}{lsuf} {val}")
                    continue
                acc = 0
                for i, b in enumerate(rec.buckets):
                    acc += val.counts[i]
                    blab = (lstr + "," if lstr else "") + f'le="{b}"'
                    out.append(f"{pname}_bucket{{{blab}}} {acc}")
                blab = (lstr + "," if lstr else "") + 'le="+Inf"'
                out.append(f"{pname}_bucket{{{blab}}} {val.count}")
                out.append(f"{pname}_sum{lsuf} {val.sum}")
                out.append(f"{pname}_count{lsuf} {val.count}")
        return "\n".join(out) + "\n"


_registry = MetricsRegistry()


def get_metrics_registry() -> MetricsRegistry:
    return _registry


def record_internal(name: str, value: float, mtype: str = "gauge",
                    **labels) -> None:
    """Fire-and-forget internal runtime metric."""
    _registry.register(name, mtype)
    key = tuple(sorted(labels.items()))
    if mtype == "counter":
        _registry.inc(name, value, key)
    else:
        _registry.set(name, value, key)


def observe_internal(name: str, value: float, buckets=None,
                     **labels) -> None:
    """Fire-and-forget histogram observation.  ``buckets`` is honoured
    only at first registration (a series' buckets never change)."""
    _registry.register(name, "histogram",
                       buckets=buckets or _DEFAULT_BUCKETS)
    _registry.observe(name, value, tuple(sorted(labels.items())))
