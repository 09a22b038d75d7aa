"""Predictor + BatchPredictor: inference from a Checkpoint.

A copy of ``ray_tpu.ml.predictor`` for the PyTorch port (reference
``python/ray/ml/predictor.py`` + ``batch_predictor.py``): a Predictor
reconstructs a model (and its preprocessor) from a Checkpoint and serves
``predict(batch)``; BatchPredictor maps it over a Dataset
(``map_batches``, one task a block).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

from ray_tpu_torch.ml.checkpoint import Checkpoint


class Predictor:
    """Subclass with ``from_checkpoint`` + ``_predict`` — or use the
    generic function flavor via ``Predictor.from_fn``."""

    def __init__(self, predict_fn: Callable, preprocessor=None):
        self._predict_fn = predict_fn
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        model_from_checkpoint: Callable) -> "Predictor":
        """``model_from_checkpoint(checkpoint) -> predict_fn``; the
        checkpoint's stored preprocessor (if any) is applied first."""
        return cls(model_from_checkpoint(checkpoint),
                   preprocessor=checkpoint.get("_preprocessor"))

    def predict(self, batch: Dict):
        if self._preprocessor is not None:
            batch = self._preprocessor.transform_batch(batch)
        return self._predict_fn(batch)


class BatchPredictor:
    """Parallel inference over a Dataset (batch_predictor.py parity)."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor],
                 model_from_checkpoint: Callable):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._model_from_checkpoint = model_from_checkpoint

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        model_from_checkpoint: Callable,
                        predictor_cls: Type[Predictor] = Predictor
                        ) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, model_from_checkpoint)

    def predict(self, dataset, *, batch_size: Optional[int] = None):
        checkpoint = self._checkpoint
        predictor_cls = self._predictor_cls
        model_from_checkpoint = self._model_from_checkpoint
        state: Dict = {}

        def infer(batch):
            # One predictor per executing worker, built lazily from the
            # shipped checkpoint.
            predictor = state.get("p")
            if predictor is None:
                predictor = predictor_cls.from_checkpoint(
                    checkpoint, model_from_checkpoint)
                state["p"] = predictor
            return predictor.predict(batch)

        return dataset.map_batches(infer, batch_size=batch_size)
