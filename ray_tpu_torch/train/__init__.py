"""ray_tpu_torch.train: distributed training orchestration.

The port of ``ray_tpu.train`` (reference ``python/ray/train/``):
``Trainer`` (trainer.py) -> ``BackendExecutor`` (backend.py) ->
``WorkerGroup`` of actors (worker_group.py); a per-worker ``session``
with ``report``/``checkpoint`` (session.py); callbacks (callbacks.py).
The backend is ``TorchConfig`` (ROADMAP C.25): with the port's thread
workers a collective group over the workers, whose allreduce averages
gradients with its reduction on the cluster's device; workers ask for
the ``"GPU"`` resource (C.24).
"""

from ray_tpu_torch.train.backend import (  # noqa: F401
    BackendConfig, TorchConfig)
from ray_tpu_torch.train.callbacks import (  # noqa: F401
    JsonLoggerCallback, PrintCallback, TrainingCallback)
from ray_tpu_torch.train.checkpoint import CheckpointStrategy  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    local_rank, load_checkpoint, report, save_checkpoint, world_rank,
    world_size)
from ray_tpu_torch.train.trainer import Trainer  # noqa: F401
from ray_tpu_torch.train.worker_group import WorkerGroup  # noqa: F401

__all__ = [
    "BackendConfig", "CheckpointStrategy", "JsonLoggerCallback",
    "PrintCallback", "TorchConfig", "Trainer", "TrainingCallback",
    "WorkerGroup", "load_checkpoint", "local_rank", "report",
    "save_checkpoint", "world_rank", "world_size",
]
