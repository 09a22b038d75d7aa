"""ExperimentAnalysis: results inspection.

A copy of ``ray_tpu.tune.analysis`` for the PyTorch port.

Parity: reference ``python/ray/tune/analysis/experiment_analysis.py`` —
``best_trial``/``best_config``/``best_result``, ``results_df``
(dataframe of last results), ``dataframe()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial


class ExperimentAnalysis:
    def __init__(self, trials: List[Trial],
                 default_metric: Optional[str] = None,
                 default_mode: str = "max"):
        self.trials = list(trials)
        self.default_metric = default_metric
        self.default_mode = default_mode

    def _metric_mode(self, metric, mode):
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        if metric is None:
            raise ValueError("pass metric= or set a default metric")
        return metric, mode

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None) -> Optional[Trial]:
        metric, mode = self._metric_mode(metric, mode)
        best, best_v = None, None
        for t in self.trials:
            v = t.metric(metric)
            if v is None:
                continue
            key = v if mode == "max" else -v
            if best_v is None or key > best_v:
                best, best_v = t, key
        return best

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    @property
    def best_config(self) -> Optional[Dict]:
        t = self.get_best_trial()
        return t.config if t else None

    @property
    def best_result(self) -> Optional[Dict]:
        t = self.get_best_trial()
        return t.last_result if t else None

    @property
    def best_checkpoint(self) -> Optional[Dict]:
        t = self.get_best_trial()
        return t.checkpoint if t else None

    def dataframe(self):
        import pandas as pd
        from ray_tpu_torch.data.block import _PANDAS_LOCK
        rows = []
        for t in self.trials:
            row = dict(t.last_result)
            row["trial_id"] = t.trial_id
            row["status"] = t.status
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        with _PANDAS_LOCK:
            return pd.DataFrame(rows)

    @property
    def results_df(self):
        return self.dataframe()
