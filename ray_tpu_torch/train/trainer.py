"""Trainer: the user-facing distributed training entry point.

A copy of ``ray_tpu.train.trainer`` for the PyTorch port (reference
``python/ray/train/trainer.py``): ``Trainer(backend, num_workers,
use_gpu, resources_per_worker)``; ``start()`` brings up the worker gang,
``run(train_func, config, callbacks, checkpoint, checkpoint_strategy)``
drives the report loop and returns one result per worker;
``run_iterator`` yields intermediate results; ``latest_checkpoint`` /
``best_checkpoint_path`` expose checkpoints; ``to_tune_trainable``
bridges into Tune.

The device is a GPU: ``use_gpu`` and ``resources_per_worker["GPU"]``
where the reference takes ``use_tpu`` and ``"TPU"`` (ROADMAP C.24), and
the default backend is ``"torch"`` (C.25).
"""

from __future__ import annotations

import tempfile
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.backend import (BackendConfig, BackendExecutor,
                                         TorchConfig)
from ray_tpu_torch.train.callbacks import TrainingCallback
from ray_tpu_torch.train.checkpoint import (CheckpointManager,
                                            CheckpointStrategy)

_BACKENDS = {"torch": TorchConfig, "base": BackendConfig}


class Trainer:
    def __init__(self, backend: Union[str, BackendConfig] = "torch",
                 num_workers: int = 1,
                 use_gpu: bool = False,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 logdir: Optional[str] = None):
        if isinstance(backend, str):
            if backend not in _BACKENDS:
                raise ValueError(
                    f"unknown backend {backend!r}; one of {list(_BACKENDS)}")
            backend = _BACKENDS[backend]()
        resources = dict(resources_per_worker or {})
        num_cpus = resources.pop("CPU", 1)
        num_gpus = resources.pop("GPU", 1 if use_gpu else 0)
        self._executor = BackendExecutor(
            backend, num_workers=num_workers,
            num_cpus_per_worker=num_cpus, num_gpus_per_worker=num_gpus,
            additional_resources_per_worker=resources or None)
        self._num_workers = num_workers
        self.logdir = logdir or tempfile.mkdtemp(
            prefix="ray_tpu_torch_train_")
        self._checkpoint_manager: Optional[CheckpointManager] = None
        self._started = False

    # ------------------------------------------------------------------
    def start(self):
        if not self._started:
            self._executor.start()
            self._started = True

    def shutdown(self):
        if self._started:
            self._executor.shutdown()
            self._started = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.shutdown()

    # ------------------------------------------------------------------
    def run(self, train_func: Callable, config: Optional[Dict] = None,
            callbacks: Optional[List[TrainingCallback]] = None,
            checkpoint: Optional[Dict] = None,
            checkpoint_strategy: Optional[CheckpointStrategy] = None
            ) -> List[Any]:
        """Run to completion; returns the train_func return values,
        one per worker in rank order."""
        for _ in self.run_iterator(train_func, config, callbacks,
                                   checkpoint, checkpoint_strategy):
            pass
        return self._finals

    def run_iterator(self, train_func: Callable,
                     config: Optional[Dict] = None,
                     callbacks: Optional[List[TrainingCallback]] = None,
                     checkpoint: Optional[Dict] = None,
                     checkpoint_strategy: Optional[CheckpointStrategy] = None):
        """Yields one list of per-worker report dicts per report round
        (reference TrainingIterator)."""
        self.start()
        callbacks = callbacks or []
        self._checkpoint_manager = CheckpointManager(
            run_dir=self.logdir, strategy=checkpoint_strategy)
        for cb in callbacks:
            cb.start_training(self.logdir, config or {})
        error = False
        self._finals = [None] * self._num_workers

        def on_checkpoint(rank, data):
            if rank == 0:
                self._checkpoint_manager.process_checkpoint(data)

        try:
            self._executor.start_training(train_func, config, checkpoint)
            while True:
                results = self._executor.get_next_results(on_checkpoint)
                if all(r.type == "done" for r in results):
                    self._finals = [r.data for r in results]
                    break
                reports = [r.data if r.type == "report" else {}
                           for r in results]
                if any(r.type == "report" for r in results):
                    for cb in callbacks:
                        cb.handle_result(reports)
                    yield reports
        except BaseException:
            error = True
            raise
        finally:
            for cb in callbacks:
                cb.finish_training(error=error)

    # ------------------------------------------------------------------
    @property
    def latest_checkpoint(self) -> Optional[Dict]:
        cm = self._checkpoint_manager
        return cm.latest_checkpoint if cm else None

    @property
    def best_checkpoint_path(self) -> Optional[str]:
        cm = self._checkpoint_manager
        return cm.best_checkpoint_path if cm else None

    def load_checkpoint_from_path(self, path: str) -> Dict:
        return CheckpointManager.load(path)

    # ------------------------------------------------------------------
    def to_tune_trainable(self, train_func: Callable) -> Callable:
        """A Tune-compatible function trainable that runs this trainer's
        gang inside the trial (reference trainer.py to_tune_trainable):
        rank 0's reports reach ``tune.report``."""
        executor_args = self._executor._worker_args
        backend = self._executor._config

        def trainable(config):
            from ray_tpu_torch import tune
            executor = BackendExecutor(backend, **executor_args)
            executor.start()
            try:
                executor.start_training(train_func, config)
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    reports = [r.data for r in results
                               if r.type == "report"]
                    if reports:
                        tune.report(**reports[0])
                    if all(r.type == "done" for r in results):
                        break
            finally:
                executor.shutdown()
        return trainable
