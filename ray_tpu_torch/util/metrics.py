"""User-facing metrics API: Counter, Gauge, Histogram.

A copy of ``ray_tpu.util.metrics`` for the PyTorch port (reference
``python/ray/util/metrics.py``): user metrics land in the process-wide
registry of ``ray_tpu_torch._private.metrics_agent`` beside the
runtime's own series, and ``render_prometheus`` renders them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from ray_tpu_torch._private.metrics_agent import get_metrics_registry


class Metric:
    """Base class; holds name, description and default tag values."""

    _type = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Union[Tuple[str, ...], List[str]]] = None):
        if not name:
            raise ValueError("name must not be empty")
        tag_keys = tuple(tag_keys or ())
        for k in tag_keys:
            if not isinstance(k, str):
                raise TypeError("tag_keys must be strings")
        self._name = name
        self._description = description
        self._tag_keys = tag_keys
        self._default_tags: Dict[str, str] = {}
        get_metrics_registry().register(
            name, self._type, description,
            buckets=getattr(self, "_boundaries", None))

    @property
    def info(self) -> Dict:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }

    def set_default_tags(self, default_tags: Dict[str, str]) -> "Metric":
        for k in default_tags:
            if k not in self._tag_keys:
                raise ValueError(f"Unrecognized tag key {k!r}")
        self._default_tags = dict(default_tags)
        return self

    def _label_key(self, tags: Optional[Dict[str, str]]):
        merged = dict(self._default_tags)
        if tags:
            for k in tags:
                if k not in self._tag_keys:
                    raise ValueError(f"Unrecognized tag key {k!r}")
            merged.update(tags)
        missing = set(self._tag_keys) - set(merged)
        if missing:
            raise ValueError(
                f"Missing value for tag key(s): {sorted(missing)}")
        return tuple(sorted(merged.items()))


class Counter(Metric):
    """A cumulative metric that only increases."""

    _type = "counter"

    def inc(self, value: Union[int, float] = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError("value must be positive")
        get_metrics_registry().inc(self._name, float(value),
                                   self._label_key(tags))


class Gauge(Metric):
    """A point-in-time value that can go up and down."""

    def set(self, value: Union[int, float],
            tags: Optional[Dict[str, str]] = None) -> None:
        get_metrics_registry().set(self._name, float(value),
                                   self._label_key(tags))


class Histogram(Metric):
    """Observations bucketed into configurable boundaries."""

    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys=None):
        if not boundaries:
            raise ValueError("boundaries must be a non-empty list")
        self._boundaries = sorted(boundaries)
        super().__init__(name, description, tag_keys)

    def observe(self, value: Union[int, float],
                tags: Optional[Dict[str, str]] = None) -> None:
        get_metrics_registry().observe(self._name, float(value),
                                       self._label_key(tags))
