"""Training callbacks.

A copy of ``ray_tpu.train.callbacks`` for the PyTorch port (reference
``python/ray/train/callbacks/``): ``TrainingCallback`` hooks
(start_training / handle_result / finish_training),
``JsonLoggerCallback`` (results.json lines), ``PrintCallback``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class TrainingCallback:
    def start_training(self, logdir: str, config: Dict[str, Any]):
        pass

    def handle_result(self, results: List[Dict[str, Any]]):
        """Called once per report round with one dict per worker."""

    def finish_training(self, error: bool = False):
        pass


class PrintCallback(TrainingCallback):
    def handle_result(self, results):
        print(results)


class JsonLoggerCallback(TrainingCallback):
    def __init__(self, logdir: Optional[str] = None,
                 filename: str = "results.json"):
        self._logdir = logdir
        self._filename = filename
        self._file = None

    def start_training(self, logdir: str, config):
        path = self._logdir or logdir
        os.makedirs(path, exist_ok=True)
        self.log_path = os.path.join(path, self._filename)
        self._file = open(self.log_path, "w")

    def handle_result(self, results):
        if self._file is not None:
            self._file.write(json.dumps(results, default=str) + "\n")
            self._file.flush()

    def finish_training(self, error: bool = False):
        if self._file is not None:
            self._file.close()
            self._file = None
