"""The runtime knobs the port reads.

A copy of the fields of ``ray_tpu._private.config.Config`` that the
ported modules read, with the same names and defaults: the scheduler
fields, the placement-group and autoscaler packing fields, and the knobs
of the raylet's scheduling plane (event loop, wakeup debounce, worker
pool, resource broadcast).  One value differs by design:
``scheduler_backend`` names the device backend ``"torch"`` where the
reference says ``"jax"``.  The rest of that config belongs to modules the
port does not have yet.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class Config:
    # ------ scheduler ------
    #: Utilization below which the hybrid policy packs instead of spreads.
    scheduler_spread_threshold: float = 0.5
    #: Prefer non-accelerator nodes for tasks that need no accelerator.
    scheduler_avoid_tpu_nodes: bool = True
    #: Which backend solves the task->node assignment each tick:
    #: "torch" = the batched device solve (``DeviceRuntimeSolver``, the
    #: class-fill kernel on the card), "native" = the greedy per-task
    #: policy.
    scheduler_backend: str = "torch"
    #: Heterogeneity cost weight (1/16 of weight = one fill bucket).
    scheduler_het_weight: float = 0.25
    #: Arg-locality cost weight (negative cost on nodes holding the
    #: class's argument bytes).
    scheduler_locality_weight: float = 0.5
    #: Placement-group bundle packing backend: "auto" routes through the
    #: device bundle solve when the cluster has at least
    #: pg_kernel_min_nodes nodes (greedy numpy below that), "force"
    #: always, "off" never.
    pg_kernel_backend: str = "auto"
    pg_kernel_min_nodes: int = 32
    #: Autoscaler demand-solve backend: "auto" routes
    #: get_bin_pack_residual / get_nodes_for through the device solve
    #: when nodes x demands >= autoscaler_kernel_min_cells (exact numpy
    #: below), "force" always, "off" never.
    autoscaler_kernel_backend: str = "auto"
    autoscaler_kernel_min_cells: int = 2048
    #: Event-driven scheduling wakeup debounce: an arrival or a release
    #: schedules the tick this many ms out, and further wakeups inside
    #: the window fold into that one tick.  0 = post the tick at once.
    scheduler_wakeup_debounce_ms: float = 1.0

    # ------ worker pool ------
    #: Warm workers started ahead of a queued burst (0 = lazily in
    #: pop_worker).
    num_prestart_workers: int = 0
    #: Also prestart from the submit edge, not only from dispatch.
    prestart_on_submit: bool = False
    #: Hard per-node worker cap.
    max_workers_per_node: int = 20_000

    # ------ resource broadcast ------
    #: Period of the resource usage poll/broadcast loop.
    gcs_resource_broadcast_period_milliseconds: int = 100

    # ------ event loop ------
    #: Period of the raylet's fallback scheduling tick.
    event_loop_tick_ms: int = 5


_lock = threading.Lock()
_global_config = None


def get_config() -> Config:
    """Process-wide config singleton."""
    global _global_config
    with _lock:
        if _global_config is None:
            _global_config = Config()
        return _global_config
