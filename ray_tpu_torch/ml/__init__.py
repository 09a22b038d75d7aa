"""ray_tpu_torch.ml — the AIR v0 unification layer.

The port of ``ray_tpu.ml`` (reference ``python/ray/ml/``):
``Preprocessor`` fit/transform over Datasets, ``Checkpoint`` as the
interchange object (host forms, ROADMAP C.27),
``DataParallelTrainer.fit() -> Result``, ``Predictor``/``BatchPredictor``
for inference over Datasets, and ``Tuner`` (a sweep of a trainer's
config through ``ray_tpu_torch.tune``), built on ``ray_tpu_torch.train``
and ``ray_tpu_torch.data``.
"""

from ray_tpu_torch.ml.checkpoint import Checkpoint
from ray_tpu_torch.ml.predictor import BatchPredictor, Predictor
from ray_tpu_torch.ml.preprocessor import (
    BatchMapper, Chain, MinMaxScaler, Preprocessor, StandardScaler)
from ray_tpu_torch.ml.trainer import DataParallelTrainer, Result
from ray_tpu_torch.ml.tuner import Tuner

__all__ = [
    "Checkpoint", "Predictor", "BatchPredictor", "Preprocessor",
    "StandardScaler", "MinMaxScaler", "BatchMapper", "Chain",
    "DataParallelTrainer", "Result", "Tuner",
]
