"""Replay buffers for off-policy learners: a copy of
``ray_tpu.rllib.replay_buffer`` for the PyTorch port (numpy with a seeded
``default_rng``, so both packages draw the same indices).

Parity: reference ``rllib/execution/replay_buffer.py`` —
``ReplayBuffer`` (uniform ring buffer) and
``PrioritizedReplayBuffer`` (proportional prioritization with
importance-sampling weights, Schaul et al. 2015) — numpy-columnar so a
sampled minibatch ships to the learner as one contiguous batch per field (no
per-transition Python objects).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over columnar transition storage."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        """Append a batch of transitions (same-length arrays per key)."""
        n = len(next(iter(batch.values())))
        if self._cols is None:
            self._cols = {
                k: np.zeros((self.capacity, *v.shape[1:]), dtype=v.dtype)
                for k, v in batch.items()}
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._cols.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ~ p_i^alpha, IS weights
    w_i = (N * P(i))^-beta normalized by max (Schaul et al.;
    reference replay_buffer.py PrioritizedReplayBuffer)."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = alpha
        self.beta = beta
        self._prios = np.zeros(capacity, dtype=np.float64)
        self._max_prio = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        idx = super().add_batch(batch)
        self._prios[idx] = self._max_prio ** self.alpha
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        prios = self._prios[:self._size]
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        # Normalize by the buffer-GLOBAL max weight (the min-priority
        # item's), so the bias correction is consistent across batches
        # (Schaul et al. 3.4; reference replay_buffer.py).
        max_weight = (self._size * probs.min()) ** (-self.beta)
        weights /= max_weight
        out = {k: v[idx] for k, v in self._cols.items()}
        out["weights"] = weights.astype(np.float32)
        out["indices"] = idx
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray):
        prios = np.abs(td_errors) + 1e-6
        self._prios[indices] = prios ** self.alpha
        self._max_prio = max(self._max_prio, float(prios.max()))
