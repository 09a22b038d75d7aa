"""Checkpoint — the interchange object between trainers, tuners and
predictors.

A copy of ``ray_tpu.ml.checkpoint`` for the PyTorch port (reference
``python/ray/ml/checkpoint.py``): one object convertible between dict /
directory / bytes representations, passed across process boundaries by
value.  Its tensors are host forms (``train.checkpoint.host_forms``: a
CUDA tensor is copied to the CPU when the checkpoint is made), so its
bytes load on a machine without a card (ROADMAP C.27).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional


class Checkpoint:
    def __init__(self, data: Dict[str, Any]):
        from ray_tpu_torch.train.checkpoint import host_forms
        self._data = host_forms(dict(data))

    # ---- constructors ---------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls(pickle.loads(blob))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        with open(os.path.join(path, "checkpoint.pkl"), "rb") as f:
            return cls.from_bytes(f.read())

    # ---- conversions ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def to_bytes(self) -> bytes:
        return pickle.dumps(self._data, protocol=5)

    def to_directory(self, path: Optional[str] = None) -> str:
        import tempfile
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
            f.write(self.to_bytes())
        return path

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __repr__(self):
        return f"Checkpoint(keys={sorted(self._data)})"
