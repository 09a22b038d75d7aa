"""Tuner: sweep a trainer's config through Tune — a stand-in.

The reference's ``ray_tpu.ml.tuner`` (``python/ray/ml``'s Tune bridge:
the param_space overlays the trainer's train_loop_config per trial) runs
on ``ray_tpu.tune``, which the port does not have yet.  ``Tuner`` keeps
the reference's constructor; ``fit`` raises ``NotImplementedError``
naming ROADMAP A.6.5, where Tune is queued.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.ml.trainer import DataParallelTrainer, Result


class Tuner:
    def __init__(self, trainer: DataParallelTrainer, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 metric: str = "loss", mode: str = "min",
                 num_samples: int = 1, scheduler=None):
        self._trainer = trainer
        self._param_space = dict(param_space or {})
        self._metric = metric
        self._mode = mode
        self._num_samples = num_samples
        self._scheduler = scheduler

    def fit(self):
        raise NotImplementedError(
            "ml.Tuner.fit: Tune is not ported yet (ROADMAP A.6.5)")


__all__ = ["Tuner", "Result"]
