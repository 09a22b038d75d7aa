"""The runtime knobs the port reads.

A copy of the fields of ``ray_tpu._private.config.Config`` that the
ported modules read, with the same names and defaults: the scheduler
fields, the placement-group and autoscaler packing fields, the knobs
of the raylet's scheduling plane (event loop, wakeup debounce, worker
pool, resource broadcast) and those of the task path (the submitter's
leases, the owner's memory store, retries, lineage, the thread workers'
start slots) and those of the object plane (the node store, spilling,
transfers and relay, lineage reconstruction).  Three values differ by
design: ``scheduler_backend`` names the device backend ``"torch"`` where
the reference says ``"jax"``; ``use_native_object_store`` is False, as
the native shared-memory segment is not ported (ROADMAP A.4b.2b) and
True raises; ``temp_dir``, where the node stores spill, is the port's own
directory under the process's temporary directory.  The rest of that
config belongs to modules the port does not have yet: the wire fetch's
``object_transfer_pipeline_depth`` and ``object_transfer_admission_wait_s``
come with the cross-process fetch.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Optional


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

    # ------ lease protocol (the direct task submitter) ------
    #: Max lease requests in flight per scheduling class
    #: (ray_config_def.h:342).  Batched lease requests count each
    #: entry against this cap.
    max_pending_lease_requests_per_scheduling_category: int = 10
    #: Max lease entries coalesced into one request_worker_lease_batch
    #: round trip.  1 disables batching.
    lease_batch_size: int = 10
    #: Retry delay for lease-batch entries the raylet returned as
    #: ``backlog`` when nothing else re-pumps the class first.
    lease_backlog_retry_ms: int = 20
    #: How long an idle leased worker is parked submitter-side before
    #: its lease goes back to the raylet.  0 = return it at once.
    worker_lease_keepalive_ms: int = 0
    #: Submit-side flow control: past this class-queue depth the
    #: submitting thread yields the GIL (``time.sleep(0)``).  0 disables.
    submit_backpressure_depth: int = 64

    # ------ object store ------
    #: Objects larger than this leave the owner's in-process memory
    #: store for a node store (the reference's 100KB promotion
    #: threshold in CoreWorker::Put).
    max_direct_call_object_size: int = 100 * 1024
    #: Per-node object store capacity in bytes before spilling kicks in.
    object_store_memory: int = 2 * 1024 * 1024 * 1024
    #: Spill when store utilization exceeds this fraction.
    object_spilling_threshold: float = 0.8
    #: Bytes fused into one spill file by the spill thread
    #: (reference: local_object_manager.h min_spilling_size).
    min_spilling_size: int = 100 * 1024 * 1024
    #: How long an over-capacity create/put/transfer reservation may
    #: queue for space before ObjectStoreFullError surfaces (reference:
    #: oom_grace_period_s over the plasma create_request_queue).
    object_store_full_grace_period_s: float = 10.0
    #: Delay between retries while a queued create waits for space.
    object_store_full_retry_ms: int = 20
    #: The native C++ shared-memory segment: not ported (ROADMAP
    #: A.4b.2b), so False; True raises ``NotImplementedError`` when a
    #: raylet starts.
    use_native_object_store: bool = False
    #: Chunk size of a transfer between node stores (object_manager.cc).
    object_manager_chunk_size: int = 5 * 1024 * 1024
    #: Sender-side transfer admission: most concurrent outbound
    #: transfers per store; further pulls queue FIFO.
    object_transfer_max_outbound_sessions: int = 4
    #: Chunk-level relay: a node mid-pull registers a PARTIAL location
    #: row and serves the assembled prefix of its in-flight transfer to
    #: downstream pullers, so a 1->N broadcast completes as a chain.
    object_transfer_relay_enabled: bool = True
    #: Source selection among several locations: "load" weighs the
    #: sources' live outbound load, "first" takes the first directory
    #: row (the naive arm).
    object_transfer_source_selection: str = "load"
    #: How long a relay read waits for the upstream's watermark to pass
    #: the chunk it asks for before it asks again.
    object_transfer_relay_wait_s: float = 2.0

    # ------ core worker / task path ------
    #: Args at or below this size are inlined into the task spec.
    task_args_inline_bytes_limit: int = 100 * 1024
    #: Default max retries for normal tasks (reference: default 3).
    task_max_retries: int = 3
    #: Lineage pinning for reconstruction (ray_config_def.h:97,110).
    lineage_pinning_enabled: bool = True
    #: Max lineage bytes kept per owner before the oldest pins go.
    max_lineage_bytes: int = 1024 * 1024 * 1024
    #: Max recursion depth when reconstructing a lost object whose
    #: creating task's args are lost too (object_recovery_manager).
    max_lineage_reconstruction_depth: int = 10
    #: Base of the per-task exponential backoff between repeated
    #: reconstructions of the same creating task.
    lineage_reconstruction_backoff_s: float = 0.2

    # ------ worker pool ------
    #: "thread" = executor threads in the node's process (the only
    #: mode of the port so far); "process" raises.
    worker_process_mode: str = "thread"
    #: Soft cap of idle workers kept alive per node (ray_config_def.h:129).
    num_workers_soft_limit: int = 64
    #: Maximum workers starting up concurrently on one node (a throttle
    #: on starts, not a total cap).
    maximum_startup_concurrency: int = 64
    #: Process-wide cap on workers in startup across every pool; a pop
    #: over the cap returns None and the dispatch tick retries.  0
    #: disables the gate.
    worker_global_startup_concurrency: int = 128
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

    # ------ misc ------
    #: Where the node stores spill (``<temp_dir>/spill/<node>``).
    temp_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "ray_tpu_torch"))


_lock = threading.Lock()
_global_config = None


def get_config() -> Config:
    """Process-wide config singleton."""
    global _global_config
    with _lock:
        if _global_config is None:
            _global_config = Config()
        return _global_config


def initialize_config(system_config: Optional[dict] = None) -> Config:
    """A fresh config with ``system_config``'s overrides (``init``'s
    ``_system_config``); an unknown key raises.  The reference also
    reads ``RAY_TPU_<NAME>`` environment variables here; the port reads
    none."""
    global _global_config
    cfg = Config()
    for key, value in (system_config or {}).items():
        if not hasattr(cfg, key):
            raise ValueError(f"Unknown system config key: {key}")
        setattr(cfg, key, value)
    with _lock:
        _global_config = cfg
    return cfg
