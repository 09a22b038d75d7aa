"""DataParallelTrainer + Result: the AIR training entry.

A copy of ``ray_tpu.ml.trainer`` for the PyTorch port (reference
``python/ray/ml/train/data_parallel_trainer.py``): ``fit()`` runs a
per-worker train loop (via ray_tpu_torch.train's Trainer/
BackendExecutor) over preprocessed Datasets and returns a ``Result``
carrying final metrics + the last Checkpoint.  Its scaling config takes
``use_gpu`` where the reference takes ``use_tpu`` (ROADMAP C.24), and
its backend is ``"torch"`` where the reference names ``"jax"`` (C.25).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.ml.checkpoint import Checkpoint
from ray_tpu_torch.ml.preprocessor import Preprocessor


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


class DataParallelTrainer:
    """``fit()`` = preprocess datasets -> run train_loop_per_worker on a
    worker group -> collect metrics + final checkpoint."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 preprocessor: Optional[Preprocessor] = None,
                 scaling_config: Optional[Dict] = None):
        self._train_loop = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self._datasets = dict(datasets or {})
        self._preprocessor = preprocessor
        scaling = dict(scaling_config or {})
        self._num_workers = int(scaling.get("num_workers", 1))
        self._use_gpu = bool(scaling.get("use_gpu", False))
        self._resources = scaling.get("resources_per_worker")

    def fit(self) -> Result:
        from ray_tpu_torch import train as train_mod

        datasets = dict(self._datasets)
        if self._preprocessor is not None and "train" in datasets:
            self._preprocessor.fit(datasets["train"])
            datasets = {k: self._preprocessor.transform(v)
                        for k, v in datasets.items()}

        # Per-worker shards ride the object store as materialized batch
        # lists (Datasets are driver-side handles).
        shard_batches = {
            name: list(ds.iter_batches(batch_format="numpy"))
            for name, ds in datasets.items()}
        config = dict(self._config)
        config["_ml_dataset_batches"] = shard_batches
        user_loop = self._train_loop

        def loop(cfg):
            return user_loop(cfg)

        trainer = train_mod.Trainer(
            backend="torch", num_workers=self._num_workers,
            use_gpu=self._use_gpu,
            resources_per_worker=self._resources)
        history: List[Dict[str, Any]] = []
        trainer.start()
        try:
            for reports in trainer.run_iterator(loop, config):
                if reports and reports[0]:
                    history.append(reports[0])
            last_ckpt = trainer.latest_checkpoint
        finally:
            trainer.shutdown()
        checkpoint = Checkpoint.from_dict(last_ckpt) \
            if isinstance(last_ckpt, dict) else None
        if self._preprocessor is not None and checkpoint is not None:
            data = checkpoint.to_dict()
            data["_preprocessor"] = self._preprocessor
            checkpoint = Checkpoint.from_dict(data)
        metrics = history[-1] if history else {}
        return Result(metrics=metrics, checkpoint=checkpoint,
                      metrics_history=history)


def get_dataset_batches(config: Dict, name: str = "train"):
    """Inside train_loop_per_worker: this worker's batches of the named
    dataset (rank-strided shard, session.get_dataset_shard parity)."""
    from ray_tpu_torch.train import session
    batches = config.get("_ml_dataset_batches", {}).get(name, [])
    rank = session.world_rank()
    world = session.world_size()
    return batches[rank::world] if world > 1 else batches
