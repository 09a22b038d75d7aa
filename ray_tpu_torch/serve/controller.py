"""ServeController: the serve control plane actor.

A copy of ``ray_tpu.serve.controller`` for the PyTorch port: plain
``threading`` locks where the reference takes ``diag_lock``,
``diag_rlock`` and ``diag_condition``, and ``handle.noted`` where it
calls ``swallow.noted``.  ``_kernel_place`` solves on the port's
``_pack_mode_matrices`` / ``_pack_mode_solve``, on the cluster's device
(the class-fill kernel on the card).

Divergence (ROADMAP C.30): a device or kernel error of that solve is
counted in ``autoscaler_stats["kernel_errors"]`` and raised, as the
port's other device solves do (C.2); the reference notes it and places
every replica by DEFAULT.  Its data misses stay: mode ``off``, fewer
nodes than ``serve_kernel_min_nodes`` under ``auto``, no nodes, an
empty demand, and replicas the solve cannot fit each give ``None``
placements (DEFAULT).

Parity: reference ``python/ray/serve/controller.py`` (:39
``ServeController``) + ``deployment_state.py`` (:45,602 reconciler) —
goal state per deployment (replica count, config), reconcile loop
creating/stopping replica actors, long-poll change notifications
(long_poll.py), queue-metric autoscaling (autoscaling_policy.py:
scale to ceil(total_queued / target_num_ongoing_requests_per_replica)
clamped to [min,max]).

Autoscaling (this repo's serving-under-load lever): the queue-depth
signal is the sum of replica in-flight counts (probed) and router
queue reports (:meth:`report_router_queue` — callers parked waiting
for a free replica slot).  The signal is EWMA-smoothed and the policy
has hysteresis: a scale decision fires only after the pressure
persists past ``upscale_delay_s`` / ``downscale_delay_s`` (reference
``autoscaling_policy.py`` delay semantics), so a one-tick burst never
churns replicas.  New replicas are PLACED through the pack-mode
kernel solve (``resource_demand_scheduler._pack_mode_solve`` — the
same device-resident path tasks and placement groups ride) and pinned
with soft node affinity; the solve is gated by
``serve_kernel_placement`` and falls back to DEFAULT placement on any
failure.  Decision series are exported at /metrics
(``ray_tpu_serve_autoscaler_*``).

Updates are *rolling* (reference ``deployment_state.py`` version-aware
reconciler): a redeploy that changes code/config marks live replicas as
old-version; the reconciler surges new-version replicas in, waits for
them to pass ``check_health``, then retires the same number of
old-version ones — serving capacity never drops below the target.  A
redeploy that changes only ``user_config`` skips restarts entirely and
calls ``reconfigure`` on the live replicas in place (reference
``deployment_state.py`` lightweight-update path).  The reconciler also
runs periodic health checks and replaces replicas that fail them
(reference ``replica.py`` health-check loop).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.serve.handle import noted

CONTROLLER_NAME = "SERVE_CONTROLLER_ACTOR"

# Fraction of the target replica count a rolling update may surge above
# it while replacing old-version replicas (reference max_surge semantics).
_ROLLING_SURGE_FRACTION = 0.25
_HEALTH_CHECK_PERIOD_S = 2.5
_HEALTH_CHECK_FAILURE_THRESHOLD = 2
_RECONCILE_PERIOD_S = 0.25
# Router queue reports older than this are ignored when aggregating the
# queue-depth signal (a stopped router must not pin its last depth).
_ROUTER_REPORT_TTL_S = 2.0
# EWMA smoothing for the load signal (per reconcile tick).
_LOAD_EWMA_ALPHA = 0.5
# Hysteresis defaults when autoscaling_config doesn't set them.
_UPSCALE_DELAY_S = 0.3
_DOWNSCALE_DELAY_S = 2.0


class DeploymentInfo:
    def __init__(self, name: str, serialized_init, num_replicas: int,
                 ray_actor_options: Optional[dict] = None,
                 max_concurrent_queries: int = 100,
                 autoscaling_config: Optional[dict] = None,
                 route_prefix: Optional[str] = None,
                 version: int = 0):
        self.name = name
        self.serialized_init = serialized_init
        self.num_replicas = num_replicas
        self.ray_actor_options = dict(ray_actor_options or {})
        self.max_concurrent_queries = max_concurrent_queries
        self.autoscaling_config = autoscaling_config
        self.route_prefix = route_prefix
        self.version = version

    def replica_fingerprint(self) -> tuple:
        """Everything that forces a replica restart when it changes —
        the deployment body and actor options, but NOT user_config
        (which reconfigures in place)."""
        deployment_def, init_args, init_kwargs, _user_config = \
            self.serialized_init
        return (deployment_def, init_args, init_kwargs,
                tuple(sorted(self.ray_actor_options.items())),
                self.max_concurrent_queries)


class _Replica:
    """A live replica actor and the deployment version it was built at."""

    __slots__ = ("handle", "version")

    def __init__(self, handle, version: int):
        self.handle = handle
        self.version = version


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, DeploymentInfo] = {}
        self._replicas: Dict[str, List[_Replica]] = {}
        self._config_version = 0
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        # Serializes whole reconcile passes (deploy handler vs loop):
        # replica startup blocks on health checks, so two concurrent
        # passes would both see the same deficit and double-start.
        self._reconcile_mutex = threading.Lock()
        self._shutdown = False
        self._last_health_check = 0.0
        self._health_fail_counts: Dict[_Replica, int] = {}
        # Autoscaler state: router queue reports (deployment ->
        # router_id -> (queued, ts)), EWMA-smoothed load, and the
        # hysteresis timestamps (when the scale condition FIRST held).
        self._router_queues: Dict[str, Dict[str, Tuple[int, float]]] = {}
        self._load_ewma: Dict[str, float] = {}
        self._scale_up_since: Dict[str, float] = {}
        self._scale_down_since: Dict[str, float] = {}
        self.autoscaler_stats = {"scale_ups": 0, "scale_downs": 0,
                                 "kernel_placements": 0,
                                 "kernel_errors": 0}
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile")
        self._reconcile_thread.start()

    # ---- API (called from serve.api) ----------------------------------
    def deploy(self, name: str, serialized_init, num_replicas: int = 1,
               ray_actor_options: Optional[dict] = None,
               max_concurrent_queries: int = 100,
               autoscaling_config: Optional[dict] = None,
               route_prefix: Optional[str] = None) -> bool:
        with self._lock:
            if route_prefix is not None:
                for other, info in self._deployments.items():
                    if other != name and info.route_prefix == route_prefix:
                        raise ValueError(
                            f"route_prefix {route_prefix!r} is already "
                            f"used by deployment {other!r}")
            prev = self._deployments.get(name)
            version = (prev.version + 1) if prev else 0
            info = DeploymentInfo(
                name, serialized_init, num_replicas, ray_actor_options,
                max_concurrent_queries, autoscaling_config, route_prefix,
                version)
            self._deployments[name] = info
            lightweight = (
                prev is not None
                and prev.replica_fingerprint() == info.replica_fingerprint())
            replicas = list(self._replicas.get(name, ()))
            self._cv.notify_all()
        if lightweight:
            # Only user_config (or replica count / autoscaling / route)
            # changed: reconfigure live replicas in place, no restarts.
            # Under the reconcile mutex so two concurrent deploys can't
            # interleave their reconfigure waves out of order.  A
            # replica is version-bumped only AFTER its reconfigure
            # succeeds — on failure (rejected config, dead actor) it
            # stays old-version and the rolling reconciler replaces it
            # with a fresh replica built from the new serialized_init.
            user_config = serialized_init[3]
            with self._reconcile_mutex:
                # A later deploy may have won the mutex first: applying
                # this (older) wave would regress replicas to a stale
                # config, so skip it entirely.
                with self._lock:
                    cur = self._deployments.get(name)
                    stale = cur is None or cur.version != version
                if not stale:
                    # All reconfigures issued up front, gathered under
                    # one shared deadline — N hung replicas cost one
                    # timeout, not N, and we hold _reconcile_mutex here.
                    waves = [(rep,
                              rep.handle.reconfigure.remote(user_config)
                              if user_config is not None else None)
                             for rep in replicas]
                    deadline = time.monotonic() + 30.0
                    for rep, fut in waves:
                        try:
                            if fut is not None:
                                ray_tpu_torch.get(fut, timeout=max(
                                    0.1, deadline - time.monotonic()))
                            rep.version = version
                        except Exception as e:
                            # Rejected config / hung or dead replica:
                            # stays old-version; the rolling reconciler
                            # replaces it with a fresh replica.
                            noted("serve.controller.reconfigure", e)
            with self._lock:
                self._bump()
        self._reconcile_once()
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            if name not in self._deployments:
                return False
            del self._deployments[name]
            self._stop_replicas(name, len(self._replicas.get(name, [])))
            self._replicas.pop(name, None)
            self._router_queues.pop(name, None)
            self._load_ewma.pop(name, None)
            self._scale_up_since.pop(name, None)
            self._scale_down_since.pop(name, None)
            self._bump()
        return True

    def get_deployment_info(self, name: str) -> Optional[dict]:
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                return None
            reps = self._replicas.get(name, [])
            return {"name": info.name, "num_replicas": info.num_replicas,
                    "version": info.version,
                    "num_running_replicas": len(reps),
                    "num_current_version_replicas":
                        sum(1 for r in reps if r.version == info.version)}

    def list_deployments(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

    def get_deployment_spec(self, name: str):
        """(serialized_init, config dict) for rebuilding a Deployment
        (serve.get_deployment parity)."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                return None
            return (info.serialized_init, {
                "num_replicas": info.num_replicas,
                "ray_actor_options": info.ray_actor_options,
                "max_concurrent_queries": info.max_concurrent_queries,
                "autoscaling_config": info.autoscaling_config,
                "route_prefix": info.route_prefix,
            })

    def get_route_table(self) -> Dict[str, str]:
        """route_prefix -> deployment name (http_proxy route updates)."""
        with self._lock:
            return {info.route_prefix: name
                    for name, info in self._deployments.items()
                    if info.route_prefix}

    def get_replica_handles(self, name: str) -> List:
        # Old-version replicas keep serving until the rolling update
        # retires them, so the router sees all of them.
        with self._lock:
            return [r.handle for r in self._replicas.get(name, [])]

    def get_autoscaler_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.autoscaler_stats)

    def report_router_queue(self, name: str, router_id: str,
                            queued: int) -> bool:
        """Router queue-depth report (callers parked in assign_request)
        — one half of the autoscaler's queue-depth signal."""
        with self._lock:
            self._router_queues.setdefault(name, {})[router_id] = (
                int(queued), time.monotonic())
        return True

    def _router_queue_depth(self, name: str) -> int:
        """Aggregate live router reports for a deployment; stale
        reports (router stopped or wedged) age out after the TTL."""
        now = time.monotonic()
        reports = self._router_queues.get(name)
        if not reports:
            return 0
        total = 0
        for rid, (queued, ts) in list(reports.items()):
            if now - ts > _ROUTER_REPORT_TTL_S:
                del reports[rid]
            else:
                total += queued
        return total

    # ---- long poll (reference long_poll.py) ---------------------------
    def listen_for_change(self, known_version: int, timeout: float = 10.0
                          ) -> int:
        """Blocks until the routing config version advances past
        ``known_version`` (or timeout); returns the current version."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._config_version <= known_version and \
                    not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            return self._config_version

    def _bump(self):
        self._config_version += 1
        self._cv.notify_all()

    # ---- reconciliation ------------------------------------------------
    def _probe_inflight(self) -> Dict[str, Optional[int]]:
        """Queue-depth probes for autoscaled deployments, issued OUTSIDE
        ``self._lock`` — a slow replica must stall only the reconcile
        loop, never deploy/get_deployment_info/long-poll entry points.
        None = probe failed (caller keeps the current replica count)."""
        with self._lock:
            targets = {
                name: [r.handle for r in self._replicas.get(name, [])]
                for name, info in self._deployments.items()
                if info.autoscaling_config}
        # All probes issued up front against ONE shared deadline, so N
        # deployments with hung replicas cost one timeout, not N
        # (same shape as _maybe_health_check).
        futures = {name: [h.get_num_inflight.remote() for h in handles]
                   for name, handles in targets.items() if handles}
        deadline = time.monotonic() + 5.0
        out: Dict[str, Optional[int]] = {}
        for name, futs in futures.items():
            try:
                out[name] = sum(ray_tpu_torch.get(
                    futs, timeout=max(0.1, deadline - time.monotonic())))
            except Exception:
                out[name] = None
        return out

    def _target_replicas(self, info: DeploymentInfo,
                         probed: Optional[int] = None) -> int:
        """Queue-depth autoscaling policy with hysteresis.

        load = replica in-flight (probed) + router queue depth, EWMA
        smoothed; desired = ceil(load / target_per_replica) clamped to
        [min, max].  A scale decision fires only after the desire has
        persisted past upscale_delay_s / downscale_delay_s — pressure
        must hold, not spike."""
        cfg = info.autoscaling_config
        if not cfg:
            return info.num_replicas
        name = info.name
        n_current = len(self._replicas.get(name, []))
        if not n_current:
            return max(1, cfg.get("min_replicas", 1))
        if probed is None:
            return n_current      # probe failed: hold steady
        load = float(probed + self._router_queue_depth(name))
        prev = self._load_ewma.get(name)
        ewma = load if prev is None else (
            _LOAD_EWMA_ALPHA * load + (1 - _LOAD_EWMA_ALPHA) * prev)
        self._load_ewma[name] = ewma
        target_per = cfg.get("target_num_ongoing_requests_per_replica", 1)
        want = math.ceil(ewma / max(target_per, 1e-9)) if ewma > 1e-9 \
            else cfg.get("min_replicas", 1)
        want = max(cfg.get("min_replicas", 1),
                   min(cfg.get("max_replicas", 10), want))
        now = time.monotonic()
        decided = n_current
        if want > n_current:
            self._scale_down_since.pop(name, None)
            since = self._scale_up_since.setdefault(name, now)
            if now - since >= cfg.get("upscale_delay_s",
                                      _UPSCALE_DELAY_S):
                self._scale_up_since.pop(name, None)
                self.autoscaler_stats["scale_ups"] += 1
                decided = want
        elif want < n_current:
            self._scale_up_since.pop(name, None)
            since = self._scale_down_since.setdefault(name, now)
            if now - since >= cfg.get("downscale_delay_s",
                                      _DOWNSCALE_DELAY_S):
                self._scale_down_since.pop(name, None)
                self.autoscaler_stats["scale_downs"] += 1
                decided = want
        else:
            self._scale_up_since.pop(name, None)
            self._scale_down_since.pop(name, None)
        self._observe_autoscaler(name, ewma, want, n_current, decided)
        return decided

    def _observe_autoscaler(self, name: str, load: float, want: int,
                            current: int, decided: int) -> None:
        """Autoscaler decision series at /metrics: smoothed load,
        desired vs running replicas, and a decision counter when a
        scale actually fires."""
        try:
            from ray_tpu_torch._private.metrics_agent import get_metrics_registry
            reg = get_metrics_registry()
            labels = (("deployment", name),)
            reg.register("ray_tpu_serve_autoscaler_load", "gauge")
            reg.set("ray_tpu_serve_autoscaler_load", load, labels)
            reg.register("ray_tpu_serve_autoscaler_desired", "gauge")
            reg.set("ray_tpu_serve_autoscaler_desired", float(want), labels)
            reg.register("ray_tpu_serve_replicas", "gauge")
            reg.set("ray_tpu_serve_replicas", float(current), labels)
            if decided != current:
                reg.register("ray_tpu_serve_autoscaler_decisions", "counter")
                reg.inc("ray_tpu_serve_autoscaler_decisions", 1.0,
                        (("deployment", name),
                         ("direction",
                          "up" if decided > current else "down")))
        except Exception as e:
            noted("serve.controller.autoscaler_metrics", e)

    def _kernel_place(self, opts: dict, count: int) -> List[Optional[Any]]:
        """Place ``count`` identical replicas through the pack-mode
        kernel solve: snapshot the cluster's dense availability view,
        solve replica-demand x nodes on the cluster's device, and
        return one node id per replica (None = no affinity, DEFAULT
        placement).  Gated by ``serve_kernel_placement``.  A failure of
        the solve is counted in ``autoscaler_stats["kernel_errors"]``
        and raised (C.30)."""
        cfg = get_config()
        mode = cfg.serve_kernel_placement
        if mode == "off":
            return [None] * count
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
            _pack_mode_matrices, _pack_mode_solve)
        cluster = worker_mod.global_worker().cluster
        view = cluster.gcs.resource_manager.view
        node_ids, _total, avail, columns = view.snapshot()
        if not node_ids or (mode == "auto"
                            and len(node_ids) < cfg.serve_kernel_min_nodes):
            return [None] * count
        inv = {i: name for name, i in columns.items()}
        node_res = [{inv[j]: float(avail[r, j])
                     for j in range(avail.shape[1]) if avail[r, j] > 0}
                    for r in range(len(node_ids))]
        demand = dict(opts.get("resources") or {})
        demand["CPU"] = float(opts.get("num_cpus", 1) or 0)
        if opts.get("num_gpus"):
            demand["GPU"] = float(opts["num_gpus"])
        demand = {k: v for k, v in demand.items() if v > 0}
        if not demand:
            return [None] * count
        names, runs, dem, counts, avail_m = _pack_mode_matrices(
            node_res, [demand] * count)
        try:
            _unfulfilled, alloc = _pack_mode_solve(
                runs, dem, counts, avail_m, device=cluster.device)
        except Exception:
            self.autoscaler_stats["kernel_errors"] += 1
            raise
        placements: List[Optional[Any]] = []
        for ci in range(alloc.shape[0]):
            for ni in range(alloc.shape[1]):
                placements.extend([node_ids[ni]] * int(alloc[ci, ni]))
        placements = placements[:count]
        self.autoscaler_stats["kernel_placements"] += len(placements)
        # Replicas the solve couldn't fit anywhere fall back to
        # DEFAULT placement (soft affinity would lie about intent).
        placements.extend([None] * (count - len(placements)))
        return placements

    @staticmethod
    def _weight_object_ids(info: DeploymentInfo) -> List:
        """Object ids of ObjectRef init args (deployed model weights)."""
        from ray_tpu_torch._private.object_ref import ObjectRef
        _def, init_args, init_kwargs, _cfg = info.serialized_init
        return [a.object_id()
                for a in list(init_args or ()) +
                list((init_kwargs or {}).values())
                if isinstance(a, ObjectRef)]

    @staticmethod
    def _stagger_weight_pull(oids: List, baselines: Dict,
                             timeout: float = 2.0) -> None:
        """Cold-start relay shaping: before creating the NEXT replica,
        wait until a weight object has grown a new directory row —
        the predecessor's pull is in flight (partial row) or done, so
        the successor's pull chains off it (transfer.relay) instead of
        opening another full origin stream.  Best-effort: on timeout
        (e.g. the predecessor landed on the origin's node and never
        pulled) the start proceeds."""
        try:
            from ray_tpu_torch._private import worker as worker_mod
            directory = worker_mod.global_worker().cluster.object_directory
        except Exception as e:
            noted("serve.controller.stagger_directory", e)
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                for oid in oids:
                    if len(directory.get_candidates(oid)) > \
                            baselines.get(oid, 1):
                        return
            except Exception as e:
                noted("serve.controller.stagger_probe", e)
                return
            time.sleep(0.01)

    def _start_replicas(self, info: DeploymentInfo, count: int
                        ) -> List[_Replica]:
        from ray_tpu_torch.serve.replica import ReplicaActor
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        opts = dict(info.ray_actor_options)
        opts.setdefault("num_cpus", 1)
        # +2 headroom so control calls (get_num_inflight, health) never
        # queue behind saturated request slots — the router, not actor
        # concurrency, enforces max_concurrent_queries.
        opts["max_concurrency"] = max(2, info.max_concurrent_queries) + 2
        weight_oids = self._weight_object_ids(info) if count > 1 else []
        baselines: Dict = {}
        if weight_oids:
            try:
                from ray_tpu_torch._private import worker as worker_mod
                directory = \
                    worker_mod.global_worker().cluster.object_directory
                baselines = {oid: len(directory.get_candidates(oid))
                             for oid in weight_oids}
            except Exception as e:
                noted("serve.controller.stagger_baseline", e)
                weight_oids = []
        placements = self._kernel_place(opts, count)
        new = []
        for i, node_id in enumerate(placements):
            rep_opts = dict(opts)
            if node_id is not None:
                # Soft: the kernel's pick is a preference, not a cage —
                # if the node filled up since the snapshot the scheduler
                # may still place elsewhere.
                rep_opts["scheduling_strategy"] = \
                    NodeAffinitySchedulingStrategy(node_id, soft=True)
            cls = ray_tpu_torch.remote(**rep_opts)(ReplicaActor)
            new.append(_Replica(
                cls.remote(info.serialized_init,
                           deployment_name=info.name), info.version))
            if weight_oids and i == 0:
                # Only the FIRST gap needs the wait: once one transfer
                # is in flight (or one extra copy exists), every later
                # pull has a non-origin source to chain from.
                self._stagger_weight_pull(weight_oids, baselines)
        return new

    def _adopt_or_kill(self, name: str, version: int,
                       new: List[_Replica]) -> bool:
        """Register freshly started replicas iff the deployment still
        wants that version; otherwise kill them.  Returns adopted?"""
        with self._lock:
            info = self._deployments.get(name)
            if info is not None and info.version == version:
                self._replicas.setdefault(name, []).extend(new)
                return True
        for rep in new:
            try:
                ray_tpu_torch.kill(rep.handle)
            except Exception as e:
                noted("serve.controller.kill_unadopted", e)
        return False

    def _wait_healthy(self, reps: List[_Replica], timeout: float = 30.0
                      ) -> List[_Replica]:
        """Block until each replica answers check_health (actor started
        and ctor ran); drop ones that error out.  All probes are issued
        up front so N hung replicas cost one timeout, not N."""
        futs = [(rep, rep.handle.check_health.remote()) for rep in reps]
        healthy = []
        deadline = time.monotonic() + timeout
        for rep, fut in futs:
            try:
                ray_tpu_torch.get(fut, timeout=max(
                    0.1, deadline - time.monotonic()))
                healthy.append(rep)
            except Exception as e:
                noted("serve.controller.unhealthy_start", e)
                try:
                    ray_tpu_torch.kill(rep.handle)
                except Exception as e2:
                    noted("serve.controller.kill_unhealthy", e2)
        return healthy

    def _drain_and_kill(self, victims: List[_Replica],
                        drain_timeout: float = 10.0):
        """Retire replicas gracefully: they are already out of
        _replicas and the config version was bumped, so routers drop
        them on their next long-poll refresh; wait for in-flight
        requests (and the router refresh window) to drain before
        killing (reference replica graceful_shutdown loop)."""
        if not victims:
            return
        # Grace so routers' long-polls (woken by the bump) refetch the
        # replica set before we start judging in-flight counts.
        time.sleep(0.25)
        deadline = time.monotonic() + drain_timeout
        pending = list(victims)
        while pending and time.monotonic() < deadline:
            still = []
            for rep in pending:
                try:
                    if ray_tpu_torch.get(rep.handle.get_num_inflight.remote(),
                                   timeout=2.0) > 0:
                        still.append(rep)
                except exceptions.GetTimeoutError:
                    # Slow to answer != dead: keep draining it until
                    # the overall deadline.
                    still.append(rep)
                except Exception as e:
                    # Dead already — nothing to drain.
                    noted("serve.controller.drain_probe", e)
            pending = still
            if pending:
                time.sleep(0.05)
        # Last service before the kill: let each replica fail its
        # parked @serve.batch requests loudly (callers otherwise hit
        # their 60s event-wait cap).  Fire-and-forget with a short
        # gather — a dead replica just errors the ref.
        shutdown_futs = []
        for rep in victims:
            try:
                shutdown_futs.append(rep.handle.prepare_shutdown.remote())
            except Exception as e:
                noted("serve.controller.prepare_shutdown", e)
        deadline = time.monotonic() + 2.0
        for fut in shutdown_futs:
            try:
                ray_tpu_torch.get(fut, timeout=max(
                    0.1, deadline - time.monotonic()))
            except Exception as e:
                noted("serve.controller.prepare_shutdown", e)
        for rep in victims:
            self._health_fail_counts.pop(rep, None)
            try:
                ray_tpu_torch.kill(rep.handle)
            except Exception as e:
                noted("serve.controller.kill_retired", e)

    def _reconcile_once(self):
        with self._reconcile_mutex:
            self._reconcile_locked()

    def _reconcile_locked(self):
        probes = self._probe_inflight()    # blocking gets, lock NOT held
        with self._lock:
            if self._shutdown:
                return
            scale_up: List[Tuple[str, DeploymentInfo, int]] = []
            rolling: List[Tuple[str, DeploymentInfo, int]] = []
            retire: List[_Replica] = []
            for name, info in self._deployments.items():
                reps = self._replicas.setdefault(name, [])
                want = self._target_replicas(info, probes.get(name))
                old = [r for r in reps if r.version != info.version]
                if len(reps) < want:
                    scale_up.append((name, info, want - len(reps)))
                elif len(reps) > want:
                    # Retire old-version replicas first when shrinking.
                    reps.sort(key=lambda r: r.version == info.version)
                    n_drop = len(reps) - want
                    retire.extend(reps[:n_drop])
                    self._replicas[name] = reps[n_drop:]
                    old = [r for r in self._replicas[name]
                           if r.version != info.version]
                if old:
                    surge = max(1, math.ceil(want * _ROLLING_SURGE_FRACTION))
                    rolling.append((name, info, min(surge, len(old))))
            if retire:
                self._bump()
        self._drain_and_kill(retire)
        for name, info, count in scale_up:
            new = self._wait_healthy(self._start_replicas(info, count))
            if new and self._adopt_or_kill(name, info.version, new):
                with self._lock:
                    self._bump()
        for name, info, count in rolling:
            # Surge `count` new-version replicas in, wait until they are
            # serving, then retire `count` old-version ones.
            new = self._wait_healthy(self._start_replicas(info, count))
            if not new:
                continue
            if not self._adopt_or_kill(name, info.version, new):
                continue
            with self._lock:
                reps = self._replicas.get(name, [])
                old = [r for r in reps if r.version != info.version]
                victims = old[:len(new)]
                self._replicas[name] = [r for r in reps
                                        if r not in victims]
                self._bump()
            self._drain_and_kill(victims)
        self._maybe_health_check()

    def _maybe_health_check(self):
        now = time.monotonic()
        if now - self._last_health_check < _HEALTH_CHECK_PERIOD_S:
            return
        self._last_health_check = now
        with self._lock:
            snapshot = {name: list(reps)
                        for name, reps in self._replicas.items()}
        # All probes issued up front against ONE shared deadline, so N
        # hung replicas cost one timeout — and this runs under the
        # reconcile mutex, where a long stall would block deploys.
        probes = [(name, rep, rep.handle.check_health.remote())
                  for name, reps in snapshot.items() for rep in reps]
        deadline = time.monotonic() + 10.0
        dead: List[Tuple[str, _Replica]] = []
        for name, rep, fut in probes:
            try:
                ray_tpu_torch.get(fut, timeout=max(
                    0.1, deadline - time.monotonic()))
                self._health_fail_counts.pop(rep, None)
            except exceptions.GetTimeoutError:
                # Slow answers only count toward a consecutive-failure
                # threshold (reference health loop): one long GC pause
                # or load spike is not death.
                fails = self._health_fail_counts.get(rep, 0) + 1
                self._health_fail_counts[rep] = fails
                if fails >= _HEALTH_CHECK_FAILURE_THRESHOLD:
                    dead.append((name, rep))
            except Exception:
                # The probe itself failed (actor died, user
                # check_health raised): definitively unhealthy.
                dead.append((name, rep))
        if not dead:
            return
        with self._lock:
            for name, rep in dead:
                reps = self._replicas.get(name)
                if reps and rep in reps:
                    reps.remove(rep)
                self._health_fail_counts.pop(rep, None)
            self._bump()
        # Drain whatever is still answering before the kill; a truly
        # dead replica drains instantly (its probe raises non-timeout).
        self._drain_and_kill([rep for _, rep in dead], drain_timeout=5.0)
        # The next reconcile pass scales the deployment back up.

    def _stop_replicas(self, name: str, count: int):
        # Must hold lock.
        reps = self._replicas.get(name, [])
        victims, self._replicas[name] = reps[:count], reps[count:]
        for rep in victims:
            self._health_fail_counts.pop(rep, None)
            try:
                ray_tpu_torch.kill(rep.handle)
            except Exception as e:
                noted("serve.controller.kill_stopped", e)

    def _reconcile_loop(self):
        while not self._shutdown:
            try:
                self._reconcile_once()
            except Exception as e:
                noted("serve.reconcile", e)
            time.sleep(_RECONCILE_PERIOD_S)

    def shutdown(self) -> bool:
        with self._lock:
            self._shutdown = True
            for name in list(self._deployments):
                self._stop_replicas(name,
                                    len(self._replicas.get(name, [])))
            self._deployments.clear()
            self._cv.notify_all()
        return True
