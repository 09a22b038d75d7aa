"""The in-process cluster: the GCS, the raylets and the object directory.

A port of ``ray_tpu._private.cluster.Cluster`` (reference
``python/ray/cluster_utils.py:100``): several raylets of one process,
each with its own node id, under one ``GcsServer`` (``gcs``).  The GCS
polls and broadcasts the raylets' resources on its loop, watches their
heartbeats (a raylet killed by ``kill_node`` is SUSPECT after
``num_heartbeats_suspect`` missed beats and DEAD after
``num_heartbeats_timeout``), and publishes each death: the placement-group
manager reschedules the node's bundles, then this cluster
(``_on_node_death``) drops the node from its membership, the object
directory forgets its copies and the core worker reconstructs the
objects that lost their last one.  ``remove_node`` stops a raylet
gracefully (it unregisters, and its death is delivered at once);
``restart_gcs`` kills the GCS and starts another over the same file
store, which reconciles against the raylets still running (its actors
re-attached to their workers), and moves the driver's actor queues to
it.  A node's actors restart or die when its death is published.

    cluster = Cluster(device="cpu")          # "cuda" by default
    head = cluster.add_node({"CPU": 4})
    victim = cluster.add_node({"CPU": 8, "memory": 32})
    cluster.kill_node(victim)                # dies by missed heartbeats
    ...
    cluster.shutdown()

The device is where the raylets' batched ticks and the GCS's bundle
solve run.  Raylets reach the GCS only through ``cluster.gcs`` at call
time, so a restart rebinds every one of them.

Divergence (ROADMAP C.9): ``add_node`` and a graceful ``remove_node`` run
one poll-and-broadcast round on the GCS loop before they return, so that
every view holds the change at once; the reference's views wait for the
next period's round.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.object_manager import ObjectDirectory
from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch.gcs.server import GcsServer


class Cluster:
    def __init__(self, device=None, gcs_storage_path: Optional[str] = None):
        self.device = device
        self._gcs_storage_path = gcs_storage_path
        self.gcs = GcsServer(storage_path=gcs_storage_path, device=device)
        self.object_directory = ObjectDirectory()
        self._lock = threading.Lock()
        self._raylets: List[Raylet] = []
        # Every raylet ever started, the dead ones included: shutdown
        # stops their worker threads and stores too.
        self._ever_raylets: List[Raylet] = []
        self.core_worker = None
        self.gcs.subscribe_node_death(self._on_node_death)

    @property
    def head_node(self) -> Optional[Raylet]:
        with self._lock:
            return self._raylets[0] if self._raylets else None

    def raylets(self) -> List[Raylet]:
        with self._lock:
            return list(self._raylets)

    def raylet(self, node_id) -> Optional[Raylet]:
        """The live raylet of ``node_id``, as the GCS knows it."""
        return self.gcs.raylet(node_id)

    # ---- membership -----------------------------------------------------
    def add_node(self, resources: Dict[str, float], node_name: str = "",
                 labels: Optional[Dict] = None,
                 object_store_memory: Optional[int] = None) -> Raylet:
        """Start a raylet on this cluster's device, with a node store of
        ``object_store_memory`` bytes (the config's by default), register
        it with the GCS and broadcast, so that every view holds the new
        node when this returns."""
        raylet = Raylet(self, resources, node_name=node_name, labels=labels,
                        device=self.device,
                        object_store_memory=object_store_memory)
        with self._lock:
            raylet.core_worker = self.core_worker
            self._raylets.append(raylet)
            self._ever_raylets.append(raylet)
        self.gcs.register_raylet(raylet)
        self.broadcast_now()
        return raylet

    def remove_node(self, raylet: Raylet, graceful: bool = True) -> None:
        """Stop ``raylet``: gracefully, it unregisters, its death is
        delivered and its removal broadcast before this returns;
        otherwise as ``kill_node``."""
        with self._lock:
            if raylet in self._raylets:
                self._raylets.remove(raylet)
        if graceful:
            raylet.shutdown()
            self.broadcast_now()
        else:
            self.kill_node(raylet)

    def kill_node(self, raylet: Raylet) -> None:
        """Hard kill: no unregistration and no more heartbeats; the GCS
        declares the node dead after ``num_heartbeats_timeout`` missed
        beats."""
        with self._lock:
            if raylet in self._raylets:
                self._raylets.remove(raylet)
        raylet.kill()

    def wait_for_nodes(self, count: int, timeout: float = 10.0) -> bool:
        """Whether the GCS holds ``count`` live nodes within
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.gcs.node_manager.alive_nodes) >= count:
                return True
            time.sleep(0.01)
        return False

    def broadcast_now(self) -> None:
        """One poll-and-broadcast round on the GCS loop, done when this
        returns."""
        gcs = self.gcs
        sync = gcs.resource_manager._poll_and_broadcast
        done = threading.Event()

        def run():
            try:
                sync()
            finally:
                done.set()
        gcs.loop.post(run, "gcs.broadcast_now")
        if not done.wait(60):
            raise TimeoutError("the GCS loop did not run the broadcast")

    # ---- driver wiring --------------------------------------------------
    def attach_core_worker(self, core_worker) -> None:
        """Make ``core_worker`` the owner every raylet's tasks report to
        and read their object arguments from."""
        with self._lock:
            self.core_worker = core_worker
            for raylet in self._raylets:
                raylet.core_worker = core_worker

    def _on_node_death(self, node_id) -> None:
        """The GCS's death notification: drop the node, forget its
        copies and reconstruct the referenced objects that lost their
        last one."""
        with self._lock:
            self._raylets = [r for r in self._raylets
                             if r.node_id != node_id]
            core = self.core_worker
        lost = self.object_directory.on_node_death(node_id)
        if core is not None:
            core.on_node_death(node_id, lost)

    def restart_gcs(self) -> GcsServer:
        """Kill the GCS and start another over the same file store, then
        reconcile it against the raylets still running (the surface of
        ``tests/test_gcs_fault_tolerance.py``).  Needs
        ``gcs_storage_path``: the memory store dies with its GCS.  The
        three steps' ms are kept in ``restart_ms``, with the actors'
        share of the reconcile (``reconcile_actors``)."""
        if self._gcs_storage_path is None:
            raise ValueError("restart_gcs requires gcs_storage_path "
                             "(the in-memory store dies with the GCS)")
        t0 = time.perf_counter()
        self.gcs.shutdown()
        t1 = time.perf_counter()
        self.gcs = GcsServer(storage_path=self._gcs_storage_path,
                             device=self.device)
        self.gcs.subscribe_node_death(self._on_node_death)
        t2 = time.perf_counter()
        self.gcs.reconcile(self.raylets())
        if self.core_worker is not None:
            self.core_worker.actor_submitter.on_gcs_restart()
        self.restart_ms = {"shutdown": (t1 - t0) * 1e3,
                           "reload": (t2 - t1) * 1e3,
                           "reconcile": (time.perf_counter() - t2) * 1e3,
                           "reconcile_actors":
                               self.gcs.reconcile_ms["actors"]}
        return self.gcs

    def shutdown(self) -> None:
        """Stop every raylet ever started, then the GCS.  The driver is
        detached and the GCS loops stopped first: the raylets' deaths
        reconstruct and reschedule nothing."""
        with self._lock:
            self.core_worker = None
            everyone = list(self._ever_raylets)
        self.gcs.stop_loops()
        for raylet in everyone:          # Raylet.shutdown is idempotent
            raylet.shutdown()
        self.gcs.shutdown()
