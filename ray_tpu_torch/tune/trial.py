"""Trial: one hyperparameter configuration's lifecycle.

A copy of ``ray_tpu.tune.trial`` for the PyTorch port.

Parity: reference ``python/ray/tune/trial.py`` — status machine
(PENDING/RUNNING/PAUSED/TERMINATED/ERROR), config, latest + history
results, checkpoints, resource request.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

_trial_ids = itertools.count()


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(self, config: Dict[str, Any],
                 resources: Optional[Dict[str, float]] = None,
                 experiment_tag: str = "",
                 trial_id: Optional[str] = None):
        # A searcher-proposed trial keeps the id it was suggested under so
        # on_trial_result/on_trial_complete reach the searcher with an id
        # it knows (reference SearchGenerator threads one trial_id).
        self.trial_id = trial_id or f"trial_{next(_trial_ids):05d}"
        self.config = dict(config)
        self.resources = dict(resources or {"cpu": 1})
        self.experiment_tag = experiment_tag
        self.status = Trial.PENDING
        self.last_result: Dict[str, Any] = {}
        self.results: List[Dict[str, Any]] = []
        self.checkpoint: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self.runner = None  # actor handle while RUNNING
        self.iteration = 0

    def update_result(self, result: Dict[str, Any]):
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("trial_id", self.trial_id)
        self.last_result = result
        self.results.append(result)

    def metric(self, name: str):
        return self.last_result.get(name)

    def is_finished(self) -> bool:
        return self.status in (Trial.TERMINATED, Trial.ERROR)

    def __repr__(self):
        return (f"Trial({self.trial_id}, {self.status}, "
                f"cfg={self.experiment_tag or self.config})")
