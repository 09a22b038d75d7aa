"""Tuner: sweep a trainer's config through Tune.

A copy of ``ray_tpu.ml.tuner`` for the PyTorch port (reference
``python/ray/ml``'s Tune bridge, ``Tuner.fit() -> ResultGrid``-lite):
the param_space overlays the trainer's train_loop_config per trial;
each trial runs a ``DataParallelTrainer`` with the base trainer's
scaling config (``use_gpu``, ROADMAP C.24) and reports its final
metrics through the Tune session.
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
        from ray_tpu_torch import tune

        base = self._trainer

        def trial(config):
            trainer = DataParallelTrainer(
                base._train_loop,
                train_loop_config={**base._config, **config},
                datasets=base._datasets,
                preprocessor=base._preprocessor,
                scaling_config={"num_workers": base._num_workers,
                                "use_gpu": base._use_gpu,
                                "resources_per_worker": base._resources})
            result = trainer.fit()
            metrics = dict(result.metrics)
            metrics.setdefault(self._metric, float("nan"))
            tune.report(**metrics)

        analysis = tune.run(trial, config=self._param_space,
                            metric=self._metric, mode=self._mode,
                            num_samples=self._num_samples,
                            scheduler=self._scheduler)
        return analysis


__all__ = ["Tuner", "Result"]
