"""tune.run: the experiment entry point.

A copy of ``ray_tpu.tune.tune`` for the PyTorch port.

Parity: reference ``python/ray/tune/tune.py:88`` (``run``) — builds the
variant stream (grid/random or a Searcher), a TrialScheduler, and drives
``TrialRunner`` to completion; returns an ``ExperimentAnalysis``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch.tune.analysis import ExperimentAnalysis
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.suggest import (BasicVariantGenerator, Searcher,
                                  SearcherVariantGenerator)
from ray_tpu_torch.tune.trial_runner import TrialRunner


def run(trainable: Union[Callable, type],
        config: Optional[Dict[str, Any]] = None,
        *,
        num_samples: int = 1,
        metric: Optional[str] = None,
        mode: str = "max",
        scheduler: Optional[TrialScheduler] = None,
        search_alg: Optional[Searcher] = None,
        stop=None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_concurrent_trials: Optional[int] = None,
        seed: Optional[int] = None,
        raise_on_failed_trial: bool = True,
        verbose: int = 0) -> ExperimentAnalysis:
    import ray_tpu_torch
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    if search_alg is not None:
        search_alg.metric = search_alg.metric or metric
        search_alg.mode = search_alg.mode or mode
        source = SearcherVariantGenerator(search_alg, num_samples)
    else:
        source = BasicVariantGenerator(config or {}, num_samples, seed=seed)
    runner = TrialRunner(
        trainable, source, scheduler=scheduler, searcher=search_alg,
        stop=stop, resources_per_trial=resources_per_trial,
        max_concurrent_trials=max_concurrent_trials,
        raise_on_failed_trial=raise_on_failed_trial)
    runner.run()
    if verbose:
        for t in runner.trials:
            print(t.trial_id, t.status, t.last_result)
    return ExperimentAnalysis(runner.trials, default_metric=metric,
                              default_mode=mode)
