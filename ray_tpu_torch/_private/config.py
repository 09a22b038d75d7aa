"""The scheduler knobs the batched tick reads.

A copy of the four scheduler fields of ``ray_tpu._private.config.Config``
with the same names and defaults.  The rest of that config belongs to the
runtime, which this package does not port yet.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class Config:
    #: Utilization below which the hybrid policy packs instead of spreads.
    scheduler_spread_threshold: float = 0.5
    #: Prefer non-accelerator nodes for tasks that need no accelerator.
    scheduler_avoid_tpu_nodes: bool = True
    #: Heterogeneity cost weight (1/16 of weight = one fill bucket).
    scheduler_het_weight: float = 0.25
    #: Arg-locality cost weight (negative cost on nodes holding the
    #: class's argument bytes).
    scheduler_locality_weight: float = 0.5


_lock = threading.Lock()
_global_config = None


def get_config() -> Config:
    """Process-wide config singleton."""
    global _global_config
    with _lock:
        if _global_config is None:
            _global_config = Config()
        return _global_config
