"""Per-node worker pool of executor threads.

A port of the thread half of ``ray_tpu._private.worker_pool`` for the
PyTorch port (reference ``src/ray/raylet/worker_pool.{h,cc}``): a
``Worker`` is one executor thread of the node's process that runs the
normal tasks pushed to it (``CoreWorkerService.PushTask`` parity), or,
once ``assign_actor`` ran an actor's creation task on it, is dedicated
to that actor: its methods arrive by ``submit_actor_task``, in order on
the worker's own thread, on ``max_concurrency - 1`` more threads that
share its queue, or on the threads of a named concurrency group
(``concurrency_group_manager.cc``), each group with its queue and
``size`` threads; ``kill_actor`` stops it, and its exit reports the
actor's death to its raylet (``on_actor_worker_exit``).  ``pop_worker``
leases an idle worker or starts one under ``max_workers_per_node``,
``maximum_startup_concurrency`` and the process-wide start slots
(``worker_global_startup_concurrency``); ``push_worker`` returns it,
keeping at most ``num_workers_soft_limit`` idle (the oldest goes first);
``prestart_for_backlog`` warms idle workers ahead of a queued burst;
``promote_to_actor`` moves a worker whose actor started from the leased
set to the actor set, and ``worker_for_actor`` finds an actor's worker
(a restarted GCS reconciles with it).

Divergences: ``prestart_for_backlog`` starts its workers inline, on the
caller's thread (the raylet's loop), where the reference uses a
throwaway thread; an idle worker blocks on its queue where the
reference polls it every second.  A worker whose actor was created is
promoted to the actor set at once (the reference defines
``promote_to_actor`` and calls it nowhere, so its actor workers stay
counted as leased, and the backlog prestart counts them as warm).  A
constructor that raises returns its lease to the raylet (the reference
keeps the worker leased, with any resources the actor would hold, for
ever).  An actor method queued at a worker that stopped, or taken off
its queue after ``kill_actor``, fails with ``WorkerCrashedError``
(the reference leaves it unanswered).

With ``worker_process_mode="process"`` the pool's workers are OS
processes (``ProcessWorker``, reference ``StartWorkerProcess``,
worker_pool.h:428): each child (``python -m
ray_tpu_torch._private.worker_main``, started by ``subprocess.Popen`` of
a fresh interpreter, never by a fork of a process that may hold a CUDA
context) registers with the node's ``WorkerHostService`` over the framed
RPC within 120 s and then takes its tasks on its own RPC server; a pump
thread on the host pushes them and stores the returns with owner
semantics.  Process workers are keyed by the runtime env's hash: a child
is started for an env (its env vars, cwd and import path set at spawn)
and reused only for it.  A child's stdout and stderr go to per-worker
files that the log monitor tails onto the ``worker_logs`` channel.  A
child that dies fails what it was running and queued, and the objects it
put are sealed with ``OwnerDiedError`` for their borrowers; a clean stop
releases them.  ``shutdown`` terminates every child and joins every
thread, pump and reaper included.  Left out until their items: the
host's shared-memory verbs (``shm_*``, ROADMAP A.4b.2b) and the tracing
drain of a reply (A.4b.7a).
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID, WorkerID

logger = logging.getLogger(__name__)

_EXIT = ("exit", None, None)


class WorkerState:
    IDLE = "IDLE"
    LEASED = "LEASED"
    ACTOR = "ACTOR"
    DEAD = "DEAD"


class Worker:
    """One executor thread of a node; may become dedicated to an actor."""

    # Thread workers are universal: a task's runtime env is applied
    # around its body by the executor.
    runtime_env_hash = ""

    def __init__(self, pool: "WorkerPool", node):
        self.worker_id = WorkerID.from_random()
        self.node = node
        self.node_id = node.node_id
        self._pool = pool
        self.state = WorkerState.IDLE
        self._queue: "queue.Queue" = queue.Queue()
        self.actor_id = None
        self.actor_instance = None
        self._actor_threads: List[threading.Thread] = []
        self._group_queues: Dict[str, "queue.Queue"] = {}
        self._killed = threading.Event()
        self._stop_sent = False
        self._exited = False
        self._thread = threading.Thread(
            target=self._main_loop, daemon=True,
            name=f"ray_tpu_torch::worker::{self.worker_id.hex()[:8]}")
        self._thread.start()

    def push_task(self, spec, on_done: Callable):
        """Execute a normal task on this worker
        (CoreWorkerService.PushTask parity); ``on_done(error or None)``
        runs on this worker's thread, or fails with
        ``WorkerCrashedError`` on the caller's when the worker has
        exited."""
        self._put(self._queue, ("task", spec, on_done))

    def assign_actor(self, creation_spec, on_done: Callable):
        """Run the actor's creation task; on success this worker is
        dedicated to the actor until it dies."""
        self._put(self._queue, ("create_actor", creation_spec, on_done))

    def submit_actor_task(self, spec, on_done: Callable):
        """Run an actor method: in order on this worker's thread (or on
        its ``max_concurrency`` threads), or on the threads of the
        method's concurrency group."""
        group = spec.concurrency_group
        gq = self._group_queues.get(group) if group else None
        self._put(gq if gq is not None else self._queue,
                  ("actor_task", spec, on_done))

    def _put(self, q: "queue.Queue", item) -> None:
        q.put(item)
        if self._exited:
            self._fail_queued()

    def kill_actor(self):
        """Stop the actor's threads after their current methods; the
        exit reports the actor's death to the raylet."""
        self.stop()

    def stop(self):
        """Stop the threads after their current task.  The worker is
        marked dead and leaves its pool at once, where the reference
        does both when the thread exits: a stopped worker takes no new
        lease either way."""
        if self._stop_sent:
            return
        self._stop_sent = True
        self._killed.set()
        self._queue.put(_EXIT)
        for gq in list(self._group_queues.values()):
            gq.put(_EXIT)
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)

    def join(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in [self._thread] + list(self._actor_threads):
            if t is threading.current_thread():
                continue
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))

    def is_alive(self) -> bool:
        return any(t.is_alive()
                   for t in [self._thread] + list(self._actor_threads))

    def _main_loop(self):
        worker_context.set_context(
            worker_context.ExecutionContext(worker=self, node=self.node))
        from ray_tpu_torch._private import executor as executor_mod
        while not self._killed.is_set():
            # Blocks without the reference's one-second poll: ``stop``
            # always enqueues "exit", and a cluster's idle workers would
            # otherwise wake thousands of times a second for the GIL.
            kind, spec, on_done = self._queue.get()
            if kind == "exit":
                # Siblings of the default group share this queue.
                self._queue.put(_EXIT)
                break
            try:
                if kind == "create_actor":
                    self._handle_create_actor(spec, on_done, executor_mod)
                elif kind == "actor_task":
                    self._run_actor_task(spec, on_done, executor_mod)
                else:
                    ok, err = executor_mod.execute_task(
                        spec, self.node, self.node.core_worker)
                    on_done(None if ok else err)
            except Exception as e:  # framework error, not user error
                logger.exception("worker %s: task %s failed in the "
                                 "runtime", self.worker_id,
                                 getattr(spec, "task_id", None))
                self._answer(on_done, exceptions.RayTpuError(str(e)))
            # Drop the frame's bindings: an idle worker must not pin the
            # last spec (its inline args hold live ObjectRefs, keeping
            # them would defer the owner's release indefinitely).
            kind = spec = on_done = None
        self._on_exit()

    def _handle_create_actor(self, spec, on_done, executor_mod):
        ok, result = executor_mod.execute_task(
            spec, self.node, self.node.core_worker)
        if not ok:
            on_done(result)
            # The lease goes back with the resources it held.
            self.node.return_worker(self)
            return
        self.actor_id = spec.actor_id
        self.actor_instance = result
        for i in range(max(1, spec.max_concurrency) - 1):
            self._start_actor_thread(self._queue, f"cc{i}")
        # Named concurrency groups: each with its own queue and threads,
        # concurrent with the default group and with each other.
        for gname, gsize in (spec.concurrency_groups or {}).items():
            gq: "queue.Queue" = queue.Queue()
            self._group_queues[gname] = gq
            for i in range(max(1, int(gsize))):
                self._start_actor_thread(gq, f"cg-{gname}-{i}")
        if self._stop_sent:
            # Killed during the construction: the group threads exit too.
            for gq in self._group_queues.values():
                gq.put(_EXIT)
        if self.state != WorkerState.DEAD:
            self.state = WorkerState.ACTOR
            self._pool.promote_to_actor(self)
        on_done(None)

    def _start_actor_thread(self, source: "queue.Queue", tag: str):
        t = threading.Thread(target=self._actor_concurrent_loop,
                             args=(source,), daemon=True,
                             name=f"{self._thread.name}::{tag}")
        self._actor_threads.append(t)
        t.start()

    def _run_actor_task(self, spec, on_done, executor_mod):
        if self._killed.is_set():
            on_done(self._crashed(spec))
            return
        ok, err = executor_mod.execute_task(
            spec, self.node, self.node.core_worker,
            actor_instance=self.actor_instance)
        on_done(None if ok else err)

    def _actor_concurrent_loop(self, source: "queue.Queue"):
        worker_context.set_context(
            worker_context.ExecutionContext(worker=self, node=self.node))
        from ray_tpu_torch._private import executor as executor_mod
        while True:
            kind, spec, on_done = source.get()
            if kind == "exit":
                source.put(_EXIT)     # for the siblings
                return
            try:
                self._run_actor_task(spec, on_done, executor_mod)
            except Exception as e:  # framework error, not user error
                logger.exception("worker %s: actor task %s failed in the "
                                 "runtime", self.worker_id, spec.task_id)
                self._answer(on_done, exceptions.RayTpuError(str(e)))
            kind = spec = on_done = None   # no idle-frame pinning

    def _answer(self, on_done, error) -> None:
        """Report a runtime failure; a reply that raises again (its
        owner, a GCS that was shut down, is gone) is logged, and the
        thread lives on."""
        if on_done is None:
            return
        try:
            on_done(error)
        except Exception:
            logger.exception("worker %s: the failure reply raised",
                             self.worker_id)

    def _crashed(self, spec) -> exceptions.WorkerCrashedError:
        return exceptions.WorkerCrashedError(
            f"worker {self.worker_id.hex()[:8]} stopped before task "
            f"{spec.task_id.hex()[:8]} ran")

    def _on_exit(self):
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)
        self._exited = True
        self._fail_queued()
        if self.actor_id is not None:
            self.node.on_actor_worker_exit(self.actor_id, self.worker_id)

    def _fail_queued(self):
        """A task or method queued here after the stop never runs: fail
        it, so its owner retries it or learns of the death (the
        reference leaves it unanswered)."""
        for q in [self._queue] + list(self._group_queues.values()):
            while True:
                try:
                    kind, spec, on_done = q.get_nowait()
                except queue.Empty:
                    break
                if kind != "exit":
                    on_done(self._crashed(spec))
            q.put(_EXIT)


#: How long a spawned child has to register with its host (the
#: reference's 120 s: N children starting at once on a loaded host
#: serialize their interpreter and torch imports).
REGISTER_TIMEOUT_S = 120.0


class WorkerHostService:
    """The host-side RPC service that a node's process workers talk to:
    the registration handshake, task arguments through the chunk server
    (``fetch_meta``), function blobs from the GCS KV, and the client
    surface (``client_service``) through which their tasks drive the
    public API, big replies in chunk sessions (reference: the raylet
    socket workers register on, plasma's socket and the GCS function
    table, in one surface)."""

    def __init__(self, node):
        from ray_tpu_torch._private.client_service import \
            register_client_surface
        from ray_tpu_torch._private.worker import global_worker_or_none
        from ray_tpu_torch.rpc import RpcServer
        from ray_tpu_torch.rpc.chunked import serve_chunks
        self._node = node
        self._lock = threading.Lock()
        self._ports: Dict[str, int] = {}
        self._registered: Dict[str, threading.Event] = {}
        self._worker_pins: Dict[str, list] = {}
        self.server = RpcServer(name=f"workerhost-{node.node_id.hex()[:6]}")
        self.server.register("register_worker", self._register_worker)
        self.server.register("ping", lambda _p: "pong")
        self._chunk_server = serve_chunks(self.server, self._get_object)

        def namespace():
            w = global_worker_or_none()
            return getattr(w, "namespace", "") if w else ""

        register_client_surface(
            self.server, core=self._core,
            kv=lambda: self._node.cluster.gcs.kv,
            actor_manager=lambda: self._node.cluster.gcs.actor_manager,
            node_id_fn=lambda: self._node.node_id,
            namespace_fn=namespace,
            stopped=lambda: self.server.stopped,
            chunk_server=self._chunk_server,
            pin_cb=self._record_pin)

    @property
    def port(self) -> int:
        return self.server.address[1]

    def _event(self, worker_id_hex: str) -> threading.Event:
        with self._lock:
            return self._registered.setdefault(worker_id_hex,
                                               threading.Event())

    def wait_for_worker(self, worker_id_hex: str,
                        timeout: float) -> Optional[int]:
        """The port the worker registered, or None after ``timeout``."""
        if not self._event(worker_id_hex).wait(timeout=timeout):
            return None
        with self._lock:
            self._registered.pop(worker_id_hex, None)
            return self._ports.pop(worker_id_hex, None)

    def _register_worker(self, payload) -> bool:
        wid = payload["worker_id"]
        with self._lock:
            self._ports[wid] = payload["port"]
        self._event(wid).set()
        return True

    def _get_object(self, oid_bin: bytes) -> Optional[bytes]:
        """A task argument's flat form: the node store's copy (a device
        object's host form), else the owner's sealed small value."""
        from ray_tpu_torch._private.serialization import SerializedObject
        oid = ObjectID(oid_bin)
        serialized = self._node.object_store.get_serialized(oid)
        if serialized is not None:
            return serialized.to_bytes()
        core = self._node.core_worker
        if core is not None:
            e = core.memory_store.get_entry(oid)
            if e is not None and e.sealed and e.error is None and \
                    isinstance(e.data, SerializedObject):
                return e.data.to_bytes()
        return None

    def _core(self):
        core = self._node.core_worker
        if core is None:
            raise RuntimeError("host node has no core worker attached")
        return core

    def _record_pin(self, worker_id_hex: str, object_id):
        with self._lock:
            self._worker_pins.setdefault(worker_id_hex, []).append(
                object_id)

    def _pop_pins(self, worker_id_hex: str):
        with self._lock:
            return self._worker_pins.pop(worker_id_hex, [])

    def release_worker_pins(self, worker_id_hex: str):
        """Drop the pins of a worker that exited cleanly: what it put and
        the results of what it submitted."""
        oids = self._pop_pins(worker_id_hex)
        core = self._node.core_worker
        if core is None:
            return
        for oid in oids:
            core.reference_counter.remove_local_ref(oid)

    def fail_worker_owned_objects(self, worker_id_hex: str):
        """Owner death of a crashed worker: the objects it put are sealed
        with ``OwnerDiedError``, so that borrowers holding the refs see
        the death instead of a loss after a timeout (reference:
        reference_count.cc OWNER_DIED); a clean exit releases them
        (``release_worker_pins``)."""
        oids = self._pop_pins(worker_id_hex)
        core = self._node.core_worker
        if core is None:
            return
        for oid in oids:
            core.fail_owned_object(oid, exceptions.OwnerDiedError(oid))

    def stop(self, timeout: float = 5.0):
        self.server.stop(timeout=timeout)


class ProcessWorker:
    """A worker in its own OS process, with ``Worker``'s interface.

    The host side of the lease lifecycle: it spawns the child, waits for
    its registration on the ``WorkerHostService``, then pushes tasks to
    the child's RPC server from a pump thread and stores the serialized
    returns with owner semantics.  ``spawn_to_registered_s`` is the
    child's start time (spawn to registration)."""

    def __init__(self, pool: "WorkerPool", node, runtime_env=None):
        from ray_tpu_torch._private import log_monitor as log_monitor_mod
        from ray_tpu_torch._private import runtime_env as runtime_env_mod
        self.worker_id = WorkerID.from_random()
        self.node = node
        self.node_id = node.node_id
        self._pool = pool
        self.state = WorkerState.IDLE
        self.actor_id = None
        self._max_concurrency = 1
        self._killed = threading.Event()
        self._died_abnormally = False   # a crash, not a stop
        self._stop_sent = False
        self._exited = False
        self._queue: "queue.Queue" = queue.Queue()
        self._client = None
        self._reaper: Optional[threading.Thread] = None
        self.spawn_to_registered_s: Optional[float] = None
        self.runtime_env_hash = (runtime_env or {}).get("_hash", "")
        wid = self.worker_id.hex()
        host = pool.host_service()
        env = dict(os.environ)
        if runtime_env:
            # Materialize working_dir, py_modules and pip on this node;
            # env vars, import paths and cwd go in at spawn (the child
            # is started for its env and keyed by its hash).
            env = runtime_env_mod.materialize(
                runtime_env, node.cluster.gcs.kv).spawn_env(env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (runtime_env_mod.framework_import_root(),
                        env.get("PYTHONPATH")) if p)
        # Unbuffered: a print reaches the tailed file as it happens.
        env["PYTHONUNBUFFERED"] = "1"
        out_f, err_f = log_monitor_mod.open_worker_log_files(wid)
        pool.ensure_log_monitor()
        self._spawned_at = time.monotonic()
        try:
            # A fresh interpreter, never a fork: the host may hold a
            # CUDA context.
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_main",
                 "--host", "127.0.0.1", "--port", str(host.port),
                 "--worker-id", wid],
                env=env, stdin=subprocess.DEVNULL, stdout=out_f,
                stderr=err_f)
        finally:
            # The child has its own copies of the descriptors.
            out_f.close()
            err_f.close()
        pool.spawned_pids.append(self._proc.pid)
        self._pump = threading.Thread(
            target=self._pump_loop, daemon=True,
            name=f"ray_tpu_torch::pworker::{wid[:8]}")
        self._pump.start()

    # ---- Worker interface ----------------------------------------------
    def push_task(self, spec, on_done: Callable):
        self._put(("task", spec, on_done))

    def assign_actor(self, creation_spec, on_done: Callable):
        self._put(("create_actor", creation_spec, on_done))

    def submit_actor_task(self, spec, on_done: Callable):
        self._put(("actor_task", spec, on_done))

    def _put(self, item) -> None:
        self._queue.put(item)
        if self._exited:
            self._fail_queued("worker process exited")

    def kill_actor(self):
        self.stop()

    def stop(self, grace: float = 5.0):
        """Stop after the current task: the worker is dead and out of
        its pool at once, its child is asked to exit, and terminated
        after ``grace`` seconds if a task still holds it."""
        if self._stop_sent:
            return
        self._stop_sent = True
        self._killed.set()
        self._queue.put(_EXIT)
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)
        self._reaper = threading.Thread(
            target=self._reap, args=(grace,), daemon=True,
            name=f"ray_tpu_torch::reap::{self.worker_id.hex()[:8]}")
        self._reaper.start()

    def _reap(self, grace: float):
        """Wait ``grace`` seconds for the child to exit, then terminate
        it, then kill it."""
        try:
            self._proc.wait(timeout=grace)
            return
        except subprocess.TimeoutExpired:
            pass
        self._proc.terminate()
        try:
            self._proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()

    def join(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in (self._pump, self._reaper):
            if t is None or t is threading.current_thread():
                continue
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))

    def is_alive(self) -> bool:
        """A thread of this worker still runs, or its child does."""
        return self._pump.is_alive() or \
            (self._reaper is not None and self._reaper.is_alive()) or \
            self._proc.poll() is None

    # ---- pump ----------------------------------------------------------
    def _await_registration(self) -> Optional[int]:
        host = self._pool.host_service_or_none()
        wid = self.worker_id.hex()
        deadline = self._spawned_at + REGISTER_TIMEOUT_S
        while host is not None:
            port = host.wait_for_worker(wid, timeout=0.05)
            if port is not None:
                self.spawn_to_registered_s = \
                    time.monotonic() - self._spawned_at
                self._pool.registered_s.append(self.spawn_to_registered_s)
                return port
            if self._killed.is_set() or host.server.stopped or \
                    self._proc.poll() is not None or \
                    time.monotonic() >= deadline:
                return None
        return None

    def _pump_loop(self):
        from ray_tpu_torch.rpc import RpcClient
        port = self._await_registration()
        if port is None:
            if not self._killed.is_set():
                logger.error("worker %s: the process did not register "
                             "(exit code %s)", self.worker_id,
                             self._proc.poll())
                self._died_abnormally = True
            self._on_exit()
            return
        self._client = RpcClient(("127.0.0.1", port))
        while not self._killed.is_set():
            try:
                kind, spec, on_done = self._queue.get(timeout=1.0)
            except queue.Empty:
                # A child that died while idle (a crash, an OOM kill)
                # must fail its owned objects now, not at the next push.
                if self._proc.poll() is not None:
                    self._died_abnormally = True
                    break
                continue
            if kind == "exit":
                break
            if kind == "actor_task" and (self._max_concurrency > 1 or
                                         spec.concurrency_group):
                # Up to max_concurrency calls in flight (a group's calls
                # bounded by its semaphore in the child); the replies
                # land on the client's reader thread.
                self._emit_running(spec)
                t0 = time.monotonic()
                fut = self._client.call_future(
                    "push", self._build_payload(kind, spec))
                fut.add_done_callback(
                    lambda f, s=spec, cb=on_done, k=kind, t=t0:
                    self._on_reply_future(f, s, cb, k, t))
            else:
                self._roundtrip(kind, spec, on_done)
            kind = spec = on_done = None   # no idle-frame pinning
        self._on_exit()

    def _emit_running(self, spec):
        """The host's RUNNING: the push to the child's server is the
        moment the task starts in the worker process (the child has no
        path to the GCS event buffer)."""
        from ray_tpu_torch.gcs import task_events
        task_events.emit(self.node.cluster, spec.task_id,
                         task_events.RUNNING, node_id=self.node_id.hex(),
                         worker_id=self.worker_id.hex())

    def _roundtrip(self, kind, spec, on_done):
        self._emit_running(spec)
        t0 = time.monotonic()
        try:
            reply = self._client.call("push",
                                      self._build_payload(kind, spec),
                                      timeout=None)
        except Exception as e:  # noqa: BLE001 — any failure is a death
            self._crash(on_done, e)
            return
        self._handle_reply(reply, spec, on_done, kind, t0)

    def _on_reply_future(self, fut, spec, on_done, kind, t0):
        err = fut.exception()
        if err is not None:
            self._crash(on_done, err)
            return
        self._handle_reply(fut.result(), spec, on_done, kind, t0)

    def _crash(self, on_done, err):
        self._died_abnormally = True
        self._killed.set()
        self._answer(on_done, exceptions.WorkerCrashedError(
            f"worker process died: {err}"))

    def _handle_reply(self, reply, spec, on_done, kind, t0):
        from ray_tpu_torch._private.serialization import from_received
        core = self.node.core_worker
        if core is not None:
            core.record_task_metric(spec, time.monotonic() - t0)
        err_blob = reply.get("error")
        if err_blob is not None:
            try:
                err = pickle.loads(err_blob)
            except Exception:  # noqa: BLE001 — a class the host lacks
                err = exceptions.RayTpuError("undecodable worker error")
            self._answer(on_done, err)
            if kind == "create_actor":
                # The lease goes back with the resources it held.
                self.node.return_worker(self)
            return
        try:
            for oid_bin, blob in reply["returns"]:
                # Owner-side landing: a small value seals the memory
                # store, a big one goes to this node's store.
                core.put_serialized_return(ObjectID(oid_bin),
                                           from_received(blob), self.node)
        except Exception as e:  # noqa: BLE001 — a host-side failure
            logger.exception("worker %s: storing the returns of %s "
                             "failed", self.worker_id, spec.task_id)
            self._answer(on_done, exceptions.RayTpuError(str(e)))
            return
        if kind == "create_actor":
            self.actor_id = spec.actor_id
            self._max_concurrency = max(1, spec.max_concurrency)
            if self.state != WorkerState.DEAD:
                self.state = WorkerState.ACTOR
                self._pool.promote_to_actor(self)
        self._answer(on_done, None)

    def _answer(self, on_done, error) -> None:
        if on_done is None:
            return
        try:
            on_done(error)
        except Exception:
            logger.exception("worker %s: a task's reply raised",
                             self.worker_id)

    def _build_payload(self, kind, spec) -> dict:
        from ray_tpu_torch._private.function_manager import _KV_PREFIX
        args = [("inline", a.value.to_bytes()) if a.is_inline
                else ("ref", a.object_id.binary()) for a in spec.args]
        return {
            "kind": kind,
            "concurrency_group": spec.concurrency_group,
            "concurrency_groups": spec.concurrency_groups,
            "function_key": None if spec.function_id is None
            else _KV_PREFIX + spec.function_id.binary(),
            "function_name": spec.function_name,
            "actor_method_name": spec.actor_method_name,
            "num_returns": spec.num_returns,
            "return_ids": [oid.binary() for oid in spec.return_ids],
            "max_concurrency": spec.max_concurrency,
            "args": args,
            # The context runtime_context reads inside the child.
            "task_id": spec.task_id,
            "actor_id": spec.actor_id,
            "depth": spec.depth,
            "resources": spec.resources.to_dict(),
            "placement_group_id": spec.placement_group_id,
            "placement_group_bundle_index":
                spec.placement_group_bundle_index,
            "lifetime_resources":
                spec.lifetime_resources.to_dict()
                if spec.lifetime_resources is not None else None,
            "task_type": spec.task_type,
        }

    def _fail_queued(self, reason: str):
        """Fail what is queued here: it never runs, and its owner retries
        it or learns of the death."""
        while True:
            try:
                kind, _spec, on_done = self._queue.get_nowait()
            except queue.Empty:
                break
            if kind != "exit":
                self._answer(on_done, exceptions.WorkerCrashedError(
                    f"worker {self.worker_id.hex()[:8]}: {reason}"))
        self._queue.put(_EXIT)

    def _on_exit(self):
        self.state = WorkerState.DEAD
        self._pool.on_worker_exit(self)
        host = self._pool.host_service_or_none()
        if host is not None:
            if self._died_abnormally:
                # The worker owned what it put: its borrowers see the
                # death (reference OWNER_DIED).
                host.fail_worker_owned_objects(self.worker_id.hex())
            else:
                host.release_worker_pins(self.worker_id.hex())
        if self._client is not None:
            if self._proc.poll() is None:
                try:
                    self._client.call("stop", None, timeout=2.0)
                except Exception:  # noqa: BLE001 — it may be gone
                    pass
            self._client.close()
        self._reap(5.0)
        self._exited = True
        self._fail_queued("worker process exited")
        if self.actor_id is not None:
            self.node.on_actor_worker_exit(self.actor_id, self.worker_id)


# ---- process-wide startup gate (startup-storm throttle) -----------------
# Per-node caps (``maximum_startup_concurrency``) bound ONE pool; a
# 64-node cluster in one process is 64 pools starting workers at once.
# This gate caps workers in startup across every pool in the process
# (``worker_global_startup_concurrency``); a pop over the cap returns
# None and the dispatch tick retries.  Lock order: WorkerPool._lock may
# be held when the gate is taken, never the reverse.
_global_start_lock = threading.Lock()
_global_starting = 0


def _acquire_global_start_slots(n: int) -> int:
    """Claim up to ``n`` startup slots; returns how many were granted
    (0 when the gate is saturated)."""
    global _global_starting
    if n <= 0:
        return 0
    cap = get_config().worker_global_startup_concurrency
    with _global_start_lock:
        granted = n if cap <= 0 else \
            max(0, min(n, cap - _global_starting))
        _global_starting += granted
    return granted


def _release_global_start_slots(n: int):
    global _global_starting
    if n <= 0:
        return
    with _global_start_lock:
        _global_starting = max(0, _global_starting - n)


class WorkerPool:
    def __init__(self, node):
        self._node = node
        self._lock = threading.RLock()
        self._idle: List[Worker] = []
        self._leased: Dict[WorkerID, Worker] = {}
        # Workers dedicated to an actor: their lease is never returned.
        self._actors: Dict[WorkerID, Worker] = {}
        self._all: Dict[WorkerID, Worker] = {}
        cfg = get_config()
        # Total cap is the runaway backstop; maximum_startup_concurrency
        # throttles concurrent starts, it is not a total cap.
        self._max_workers = cfg.max_workers_per_node
        self._max_starting = cfg.maximum_startup_concurrency
        self._starting = 0
        self._soft_limit = cfg.num_workers_soft_limit
        self._process_mode = cfg.worker_process_mode == "process"
        self._host_service: Optional[WorkerHostService] = None
        self._log_monitor = False
        # Set by shutdown: a worker started after it (a tick still
        # dispatching on the raylet's loop) is stopped, not pooled.
        self._closed = False
        self._stopped: List[Worker] = []
        #: Most workers alive at once (threads or processes of this pool).
        self.peak_workers = 0
        #: The pids of the worker processes this pool started, and each
        #: registered child's seconds from spawn to registration.
        self.spawned_pids: List[int] = []
        self.registered_s: List[float] = []

    def ensure_log_monitor(self):
        """Hold a reference on this process's log-file tailer, which
        publishes process workers' log lines on the ``worker_logs``
        channel."""
        with self._lock:
            if self._log_monitor:
                return
            from ray_tpu_torch._private import log_monitor as log_monitor_mod
            log_monitor_mod.acquire_local_monitor(
                self._node.cluster.gcs.publisher)
            self._log_monitor = True

    def host_service(self) -> WorkerHostService:
        """The node's host service, started with its first process
        worker."""
        with self._lock:
            if self._host_service is None:
                self._host_service = WorkerHostService(self._node)
            return self._host_service

    def host_service_or_none(self) -> Optional[WorkerHostService]:
        return self._host_service

    def _new_worker(self, runtime_env=None):
        if self._process_mode:
            return ProcessWorker(self, self._node, runtime_env=runtime_env)
        return Worker(self, self._node)

    def process_workers(self) -> List["ProcessWorker"]:
        """The live process workers of this pool."""
        with self._lock:
            return [w for w in self._all.values()
                    if isinstance(w, ProcessWorker)]

    def _note_peak(self):
        # Callers hold self._lock.
        if len(self._all) > self.peak_workers:
            self.peak_workers = len(self._all)

    def prestart_workers(self, n: int) -> int:
        """Start up to ``n`` idle workers under the caps; returns how
        many."""
        with self._lock:
            capacity = self._max_workers - len(self._all) - self._starting
            count = max(0, min(n, capacity,
                               self._max_starting - self._starting))
            if self._closed:
                count = 0
            count = _acquire_global_start_slots(count)
            self._starting += count
        stagger = get_config().worker_startup_stagger_ms / 1000.0
        created = []
        try:
            for i in range(count):
                if i and stagger > 0:
                    time.sleep(stagger)   # ramp a start storm
                created.append(self._new_worker())
        finally:
            _release_global_start_slots(count)
            with self._lock:
                self._starting -= count
                for w in created:
                    if self._closed:
                        w.stop()
                        continue
                    self._all[w.worker_id] = w
                    self._idle.append(w)
                self._note_peak()
        return len(created)

    def prestart_for_backlog(self, depth: int, bound: int) -> int:
        """Bring idle + starting + leased workers up to
        ``min(depth, bound)`` (the reference's predictive prestart,
        ``PrestartWorkers``, worker_pool.h:350), started inline (module
        docstring).  Returns the shortfall this call saw."""
        with self._lock:
            warm = len(self._idle) + self._starting + len(self._leased)
            room = self._max_workers - len(self._all) - self._starting
            want = min(min(depth, bound) - warm, room)
        if want <= 0:
            return 0
        self.prestart_workers(want)
        return want

    def pop_worker(self, runtime_env=None) -> Optional[Worker]:
        """Lease an idle worker, starting one if under the caps
        (WorkerPool::PopWorker, worker_pool.h:338); None at a cap (the
        dispatch loop retries when a worker returns).  Process workers
        are keyed by the runtime env's hash (worker_pool.h:428); thread
        workers are universal."""
        want_hash = (runtime_env or {}).get("_hash", "") \
            if self._process_mode else ""
        with self._lock:
            if self._closed:
                return None
            kept = []
            found = None
            while self._idle:
                w = self._idle.pop()
                if w.state != WorkerState.IDLE:
                    continue
                if w.runtime_env_hash != want_hash:
                    kept.append(w)
                    continue
                found = w
                break
            self._idle.extend(reversed(kept))
            if found is not None:
                found.state = WorkerState.LEASED
                self._leased[found.worker_id] = found
                return found
            total = len(self._all) + self._starting
            if total >= self._max_workers and kept:
                # At the cap with only other envs' idle workers: stop
                # one to make room (the reference kills an idle worker
                # rather than starve the new env).
                victim = kept[0]
                self._idle.remove(victim)
                self._all.pop(victim.worker_id, None)
                victim.stop()
                total -= 1
            if total >= self._max_workers or \
                    self._starting >= self._max_starting:
                return None      # caller retries on the dispatch tick
            if _acquire_global_start_slots(1) < 1:
                return None      # process-wide storm throttle; retried
            self._starting += 1
        # Start the thread outside the lock: concurrent leases and
        # returns must not wait on it.
        try:
            w = self._new_worker(runtime_env=runtime_env)
        except BaseException:
            with self._lock:
                self._starting -= 1
            _release_global_start_slots(1)
            raise
        _release_global_start_slots(1)
        with self._lock:
            self._starting -= 1
            if self._closed:
                w.stop()
                return None
            self._all[w.worker_id] = w
            w.state = WorkerState.LEASED
            self._leased[w.worker_id] = w
            self._note_peak()
            return w

    def push_worker(self, worker: Worker):
        """Return a leased worker to the idle pool; past the soft limit
        the oldest idle worker stops (LRU, ray_config_def.h:129)."""
        with self._lock:
            self._leased.pop(worker.worker_id, None)
            if worker.state == WorkerState.DEAD:
                return
            if worker.state == WorkerState.ACTOR:
                self._actors[worker.worker_id] = worker
                return
            worker.state = WorkerState.IDLE
            if len(self._idle) >= self._soft_limit:
                if not self._idle:
                    # soft_limit == 0: keep no idle workers at all.
                    self._all.pop(worker.worker_id, None)
                    worker.stop()
                    return
                victim = self._idle.pop(0)
                self._all.pop(victim.worker_id, None)
                victim.stop()
            self._idle.append(worker)

    def promote_to_actor(self, worker: Worker):
        """The worker's actor started: it leaves the leased set for
        good."""
        with self._lock:
            if self._leased.pop(worker.worker_id, None) is not None:
                self._actors[worker.worker_id] = worker

    def on_worker_exit(self, worker: Worker):
        with self._lock:
            self._all.pop(worker.worker_id, None)
            self._leased.pop(worker.worker_id, None)
            if self._actors.pop(worker.worker_id, None) is not None or \
                    isinstance(worker, ProcessWorker):
                # Joined at shutdown: a killed actor's threads may still
                # be finishing its methods, and a process worker's pump
                # and reaper are finishing its child.
                self._stopped = [w for w in self._stopped
                                 if w is not worker and w.is_alive()]
                self._stopped.append(worker)
            if worker in self._idle:
                self._idle.remove(worker)

    def worker_for_actor(self, actor_id) -> Optional[Worker]:
        """The live worker dedicated to ``actor_id`` (a restarted GCS
        reconciles with it), or None."""
        with self._lock:
            for w in self._all.values():
                if w.actor_id == actor_id and w.state == WorkerState.ACTOR:
                    return w
            return None

    def num_idle(self) -> int:
        with self._lock:
            return len(self._idle)

    def num_total(self) -> int:
        with self._lock:
            return len(self._all)

    def shutdown(self, timeout: float = 5.0):
        """Stop every worker and wait up to ``timeout`` seconds in all
        for their threads (a task still running holds its thread until
        it returns); a process worker's child is terminated at once.
        Then the host service stops and the log tailer is released."""
        with self._lock:
            self._closed = True
            workers = list(self._all.values())
            # A second call (after a kill that waited for nothing) joins
            # the threads the first one stopped.
            self._stopped += workers
            workers = list(self._stopped)
            host = self._host_service
            monitor, self._log_monitor = self._log_monitor, False
        for w in workers:
            if isinstance(w, ProcessWorker):
                w.stop(grace=0.0)
            else:
                w.stop()
        deadline = time.monotonic() + timeout
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
        if host is not None:
            host.stop(timeout=max(0.0, deadline - time.monotonic()))
        if monitor:
            from ray_tpu_torch._private import log_monitor as log_monitor_mod
            log_monitor_mod.release_local_monitor()
