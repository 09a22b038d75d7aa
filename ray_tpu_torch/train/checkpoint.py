"""Checkpoint management for Train.

A copy of ``ray_tpu.train.checkpoint`` for the PyTorch port (reference
``python/ray/train/checkpoint.py``): ``CheckpointStrategy`` (num_to_keep,
score attribute/order) and the ``CheckpointManager`` that persists
rank-0 checkpoints to disk and tracks the best one.  A checkpoint holds
host forms, never a CUDA tensor (:func:`host_forms`, ROADMAP C.27).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


def host_forms(value):
    """``value`` with every tensor in its dicts, lists and tuples replaced
    by its host form (``serialization.host_form``: a CUDA tensor copied
    to the CPU, its dtype kept) and detached, so that a pickled
    checkpoint loads on a machine without a card (ROADMAP C.27)."""
    import torch
    if isinstance(value, torch.Tensor):
        from ray_tpu_torch._private.serialization import host_form
        return host_form(value.detach())
    if isinstance(value, dict):
        return {k: host_forms(v) for k, v in value.items()}
    if type(value) in (list, tuple):
        return type(value)(host_forms(v) for v in value)
    return value


@dataclass
class CheckpointStrategy:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"


class CheckpointManager:
    def __init__(self, run_dir: Optional[str] = None,
                 strategy: Optional[CheckpointStrategy] = None):
        self.run_dir = run_dir or tempfile.mkdtemp(
            prefix="ray_tpu_torch_train_")
        self.strategy = strategy or CheckpointStrategy()
        self._checkpoints: List[Dict[str, Any]] = []  # {path, score, id}
        self._next_id = 0
        self.latest_checkpoint: Optional[Dict] = None

    def process_checkpoint(self, checkpoint: Dict) -> str:
        """Persist a (rank-0) checkpoint dict as host forms; returns its
        path."""
        checkpoint = host_forms(checkpoint)
        os.makedirs(self.run_dir, exist_ok=True)
        cid = self._next_id
        self._next_id += 1
        path = os.path.join(self.run_dir, f"checkpoint_{cid:06d}.pkl")
        with open(path, "wb") as f:
            pickle.dump(checkpoint, f)
        self.latest_checkpoint = checkpoint
        score = None
        attr = self.strategy.checkpoint_score_attribute
        if attr is not None and attr in checkpoint:
            score = checkpoint[attr]
        self._checkpoints.append({"path": path, "score": score, "id": cid})
        self._evict()
        return path

    def _evict(self):
        keep = self.strategy.num_to_keep
        if keep is None or len(self._checkpoints) <= keep:
            return
        attr = self.strategy.checkpoint_score_attribute
        if attr is None:
            victims = self._checkpoints[:-keep]
            self._checkpoints = self._checkpoints[-keep:]
        else:
            reverse = self.strategy.checkpoint_score_order == "max"
            ranked = sorted(
                self._checkpoints,
                key=lambda c: (c["score"] is not None, c["score"]),
                reverse=reverse)
            self._checkpoints = ranked[:keep]
            victims = ranked[keep:]
        for v in victims:
            try:
                os.remove(v["path"])
            except OSError:
                pass

    @property
    def best_checkpoint_path(self) -> Optional[str]:
        attr = self.strategy.checkpoint_score_attribute
        scored = [c for c in self._checkpoints if c["score"] is not None]
        if attr is None or not scored:
            return self._checkpoints[-1]["path"] if self._checkpoints \
                else None
        reverse = self.strategy.checkpoint_score_order == "max"
        return sorted(scored, key=lambda c: c["score"],
                      reverse=reverse)[0]["path"]

    @staticmethod
    def load(path: str) -> Dict:
        with open(path, "rb") as f:
            return pickle.load(f)
