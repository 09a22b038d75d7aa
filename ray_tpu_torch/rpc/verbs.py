"""Retry classification of the cluster's RPC verbs.

A copy of ``ray_tpu.rpc.verbs`` for the PyTorch port: the same
registries, so that a verb the port's node hosts take later (ROADMAP
A.4b.9b) is classified as the reference classifies it.

Reference analogue: gRPC method idempotency options +
``src/ray/rpc/retryable_grpc_client`` — the reference marks which
core-worker/raylet RPCs may be transparently retried after a transport
failure.  Here every verb that ``RpcClient.call`` may auto-retry on a
timeout or connection loss is classified explicitly:

* **idempotent** — re-running the handler is a no-op or a pure read;
  retries need no extra machinery (heartbeats, KV/directory reads,
  object fetches).
* **dedup** — the handler MUTATES state (grants a lease, registers an
  actor/location, stores a return) so a blind retry could double the
  side effect.  These verbs are retried under a client-minted dedup
  token: every send of the same logical call carries the same token,
  and the server's bounded dedup window runs the handler once and
  replays the recorded reply to duplicates — whether the duplicate came
  from a client retry or from duplicate DELIVERY on a flaky wire.

Verbs that mutate state but are deliberately NEVER auto-retried live
in ``NO_RETRY_VERBS`` — long-polls like ``wait_object``,
delta-shipping like ``metrics_report`` whose loss handling is
application-level, timing probes like ``clock_probe``, and the whole
driver/worker-link surface whose retries belong to the caller.  The
set exists so graftcheck's R9 pass can tell "consciously exempt" from
"someone added a mutating verb and forgot": every mutating handler's
verb must appear in exactly one of these registries, and every entry
must name a verb that still exists.

``_CONTROL_VERBS`` are additionally exempt from the ``rpc.send`` /
``rpc.recv`` fault points: they are the chaos plane's own control
channel (arming and healing a partition must work THROUGH the
partition).
"""

from __future__ import annotations

from typing import Optional

#: Pure reads / naturally idempotent writes: retry without a token.
IDEMPOTENT_VERBS = frozenset({
    "ping",
    "heartbeat",
    "kv_get",
    "get_locations",
    "get_node_address",
    "get_resource_report",
    "fetch_object",
    "fault_fired",
    "observability_stats",
    # removals / upserts that are no-ops on re-delivery:
    "unregister_node",         # second removal of a node row is a no-op
    "update_resource_usage",   # head's latest-usage broadcast: pure upsert
    "remove_partial_location", # directory row removal, absent row is fine
    "delete_object",           # deleting an absent object is a no-op
    "pubsub_unsubscribe",      # pop of the subscriber entry, idempotent
})

#: Mutating verbs: retried only under a server-side dedup window keyed
#: by a client-minted token (lease grant/return, actor assignment and
#: task pushes — "exactly once" side effects — registration, location
#: rows, inline return storage, the PG 2PC edges).
DEDUP_VERBS = frozenset({
    "register_node",
    "request_worker_lease",
    "request_worker_lease_batch",
    "return_worker",
    "reconcile_leases",
    "push_task",
    "assign_actor",
    "push_actor_task",
    "actor_worker_died",
    "add_location",
    "remove_location",
    "put_inline",
    "prepare_bundle",
    "commit_bundle",
    "cancel_bundle",
})

#: The chaos plane's own control channel: exempt from rpc.send/rpc.recv
#: fault points so a partition can always be healed through it.
CONTROL_VERBS = frozenset({"arm_fault", "disarm_fault", "fault_fired"})

#: Mutating verbs that are DELIBERATELY never auto-retried.  Each entry
#: is a conscious decision, grouped by why the transport must not
#: retry it:
NO_RETRY_VERBS = frozenset({
    # loss-tolerant shipping — the application heals a lost report
    # (delta shippers re-send on the next change / force a full):
    "metrics_report",
    "wedge_report",
    # timing / long-poll surfaces — a retry would skew the measurement
    # or re-enter a parked wait the caller already abandoned:
    "clock_probe",
    "wait_object",
    # supervised same-host worker link — a wedged worker is REPLACED by
    # the pool (watchdog + reaper), not retried into; a blind re-push
    # would double-execute the task:
    "push",
    "stop",
    "register_worker",
    # shm segment control (same supervised link; create/seal/abort are
    # one-shot lease steps whose failure aborts the put):
    "shm_create",
    "shm_locate",
    "shm_release",
    "shm_seal",
    "shm_abort",
    # pubsub: the first subscribe MINTS the subscriber id (a retry
    # would mint a second), and batch delivery is at-least-once with
    # re-publish handled by the publisher itself:
    "pubsub_subscribe",
    "publish_batch",
    # driver/job surface — the client library and CLI own retries and
    # surface failures to the user instead of silently re-submitting:
    "kv_put",
    "submit_task",
    "submit_actor_task",
    "create_actor",
    "kill_actor",
    "put_object",
    "submit_job",
    "stop_job",
})


def needs_dedup(method: str) -> bool:
    return method in DEDUP_VERBS


def is_retryable(method: str) -> bool:
    return method in IDEMPOTENT_VERBS or method in DEDUP_VERBS


def is_control(method: str) -> bool:
    return method in CONTROL_VERBS


def classify(method: str) -> Optional[str]:
    """"idempotent" | "dedup" | None (never auto-retried)."""
    if method in DEDUP_VERBS:
        return "dedup"
    if method in IDEMPOTENT_VERBS:
        return "idempotent"
    return None
