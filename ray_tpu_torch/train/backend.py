"""Backends + BackendExecutor: how a worker gang becomes a process group.

A copy of ``ray_tpu.train.backend`` for the PyTorch port (reference
``python/ray/train/backend.py``: ``BackendExecutor`` orchestrating
start/setup/run over a ``WorkerGroup``; ``python/ray/train/torch.py``:
the backend config that wires the framework's process group).

``TorchConfig`` is the port's backend and the default of ``Trainer``
(ROADMAP C.25): with thread workers it takes the reference's collective
route (a ``ray_tpu_torch.util.collective`` group over the workers, the
gradient allreduce plane); with process workers, a real
``torch.distributed`` process group over them.  The port has no ``JaxConfig``.  Sessions are kept per
``(run_id, rank)``, so concurrent executors in one process never
cross-wire.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.session import Session, TrainingResult
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    """Base backend config; subclasses pick the Backend implementation."""

    def backend_name(self) -> str:
        return "base"

    def on_start(self, worker_group: WorkerGroup):
        pass

    def on_shutdown(self, worker_group: WorkerGroup):
        pass


@dataclass
class TorchConfig(BackendConfig):
    """The port's default backend (reference ``train/torch.py``
    ``setup_torch_process_group``: MASTER_ADDR/PORT + init_process_group
    over TCP).

    When the workers are OS processes (``worker_process_mode=
    "process"``) this initializes a process group of ``backend``
    (gloo by default) across them: ``torch.distributed.all_reduce`` and
    the rest work natively inside the train function, DDP included.
    Its rendezvous is a TCP store on rank 0's loopback, as process
    workers run on their host's node (node hosts, whose workers live on
    other machines, are ROADMAP A.4b.9b; the reference binds rank 0's
    host name).  When workers are in-process threads one torch runtime
    cannot host several ranks, so the workers join a collective group
    of ``ray_tpu_torch.util.collective`` under ``group_name`` and
    average gradients with its ``allreduce``, whose reduction runs on
    the cluster's device.
    """

    backend: str = "gloo"
    init_method: str = "tcp"
    group_name: str = "train"
    timeout_s: float = 60.0

    def backend_name(self) -> str:
        return "torch"

    def on_start(self, worker_group: WorkerGroup):
        import os

        import ray_tpu_torch
        n = len(worker_group)
        pids = worker_group.execute(os.getpid)
        if len(set(pids)) == n and os.getpid() not in pids:
            self._real_pg = True
            self._setup_process_group(worker_group, n)
            return
        self._real_pg = False
        from ray_tpu_torch.util.collective import collective
        name = self.group_name

        def setup(rank):
            collective.init_collective_group(n, rank, group_name=name)
            base = name.split("~", 1)[0]
            if base != name:
                collective.set_group_alias(base, name)
            return True
        ray_tpu_torch.get([
            worker_group.execute_single_async(i, setup, i)
            for i in range(n)])

    def _setup_process_group(self, worker_group: WorkerGroup, n: int):
        import ray_tpu_torch

        def master_endpoint():
            import socket
            # Rank 0's process serves the TCP rendezvous on a port free
            # on its machine.
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            return "127.0.0.1", port

        host, port = worker_group.execute_single(0, master_endpoint)
        backend, timeout_s = self.backend, self.timeout_s

        def setup(rank):
            import datetime
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
            dist.init_process_group(
                backend, init_method=f"tcp://{host}:{port}",
                rank=rank, world_size=n,
                timeout=datetime.timedelta(seconds=timeout_s))
            return True

        ray_tpu_torch.get([
            worker_group.execute_single_async(i, setup, i)
            for i in range(n)])

    def on_shutdown(self, worker_group: WorkerGroup):
        if getattr(self, "_real_pg", False):
            def teardown():
                import torch.distributed as dist
                if dist.is_initialized():
                    dist.destroy_process_group()
                return True
            try:
                worker_group.execute(teardown)
            except Exception:  # noqa: BLE001 — already gone
                pass
            return
        from ray_tpu_torch.util.collective import collective
        name = self.group_name

        def teardown():
            try:
                collective.destroy_collective_group(name)
            except Exception:  # noqa: BLE001 — already gone
                pass
        try:
            worker_group.execute(teardown)
        except Exception:  # noqa: BLE001 — best effort at teardown
            pass


def _start_session_on_worker(run_id: str, fn: Callable, config: Dict,
                             rank: int, world_size: int,
                             checkpoint: Optional[Dict]):
    """Runs inside the worker actor: create + start the session."""
    import functools
    fn_bound = functools.partial(fn, dict(config)) if _fn_takes_config(fn) \
        else fn
    session = Session(fn_bound, world_rank=rank, local_rank=rank,
                      world_size=world_size, checkpoint=checkpoint)
    _WORKER_SESSIONS[(run_id, rank)] = session
    session.start()
    return True


def _fn_takes_config(fn: Callable) -> bool:
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


# In-process actors share module globals; key by (run_id, rank) so two
# concurrent BackendExecutors (e.g. parallel tune trials over
# to_tune_trainable) never cross-wire each other's sessions (see verify
# skill gotcha: module-level state is shared across "workers").
_WORKER_SESSIONS: Dict[Any, Session] = {}


def _get_next_on_worker(run_id: str, rank: int,
                        timeout: float = 300.0) -> TrainingResult:
    session = _WORKER_SESSIONS.get((run_id, rank))
    if session is None:
        return TrainingResult("error",
                              RuntimeError(f"no session for rank {rank}"))
    return session.get_next(timeout=timeout)


def _drop_session_on_worker(run_id: str, rank: int) -> bool:
    return _WORKER_SESSIONS.pop((run_id, rank), None) is not None


class TrainBackendError(RuntimeError):
    pass


class BackendExecutor:
    """Drives the worker gang through a training run (reference
    backend.py BackendExecutor.start/start_training/get_next_results)."""

    def __init__(self, backend_config: BackendConfig,
                 num_workers: int = 1,
                 num_cpus_per_worker: float = 1,
                 num_gpus_per_worker: float = 0,
                 additional_resources_per_worker: Optional[Dict] = None):
        import uuid
        self._config = backend_config
        self._num_workers = num_workers
        self._run_id = uuid.uuid4().hex[:12]
        self._worker_args = dict(
            num_workers=num_workers,
            num_cpus_per_worker=num_cpus_per_worker,
            num_gpus_per_worker=num_gpus_per_worker,
            additional_resources_per_worker=additional_resources_per_worker)
        self.worker_group: Optional[WorkerGroup] = None

    def start(self):
        import copy
        import uuid
        # Fresh per run: executors are pickled into tune trainables, so
        # ids minted at __init__ would be shared by every unpickled copy.
        self._run_id = uuid.uuid4().hex[:12]
        self.worker_group = WorkerGroup(**self._worker_args)
        # Run a copy of the config with a run-scoped collective group so
        # concurrent executors sharing one config object never collide;
        # workers alias the user-facing base name to the scoped one.
        cfg = copy.copy(self._config)
        base = getattr(cfg, "group_name", None)
        if base:
            cfg.group_name = f"{base}~{self._run_id}"
        self._started_config = cfg
        cfg.on_start(self.worker_group)

    def start_training(self, train_func: Callable, config: Optional[Dict],
                       checkpoint: Optional[Dict] = None):
        import ray_tpu_torch
        refs = [
            self.worker_group.execute_single_async(
                rank, _start_session_on_worker, self._run_id, train_func,
                config or {}, rank, self._num_workers, checkpoint)
            for rank in range(self._num_workers)]
        ray_tpu_torch.get(refs)

    def get_next_results(self, checkpoint_handler=None
                         ) -> List[TrainingResult]:
        """One report/done per worker, in rank order. Checkpoint events
        are consumed eagerly via ``checkpoint_handler(rank, data)`` so
        report rounds stay aligned across workers even when some ranks
        interleave save_checkpoint with report (reference:
        get_next_results pairs results by type). Raises on the first
        worker error. Once every worker is "done" the same final results
        are returned on every poll."""
        import time
        import ray_tpu_torch
        results: List[TrainingResult] = []
        for r in range(self._num_workers):
            deadline = time.monotonic() + 600.0
            while True:
                res = ray_tpu_torch.get(self.worker_group.execute_single_async(
                    r, _get_next_on_worker, self._run_id, r))
                if res.type == "error":
                    raise TrainBackendError(str(res.data)) from res.data
                if res.type == "timeout":
                    # A hung worker must surface, not spin silently.
                    if time.monotonic() > deadline:
                        raise TrainBackendError(
                            f"worker rank {r} produced no result within "
                            "600s (hung train function?)")
                    continue
                if res.type == "checkpoint":
                    if checkpoint_handler is not None:
                        checkpoint_handler(r, res.data)
                    continue
                results.append(res)
                break
        return results

    def shutdown(self):
        if self.worker_group is not None:
            import ray_tpu_torch
            self._started_config.on_shutdown(self.worker_group)
            try:
                ray_tpu_torch.get([
                    self.worker_group.execute_single_async(
                        r, _drop_session_on_worker, self._run_id, r)
                    for r in range(self._num_workers)])
            except Exception:  # noqa: BLE001 — already gone
                pass
            self.worker_group.shutdown()
            self.worker_group = None
