"""Environments for the RL library: a copy of ``ray_tpu.rllib.env`` for
the PyTorch port (numpy only, so ``CartPole(seed)`` gives the same
episodes in both packages).

Parity: reference ``rllib/env/`` — the env API rollout workers consume.
No gym dependency: the protocol is ``reset() -> obs`` /
``step(action) -> (obs, reward, done, info)`` with numpy observations,
plus a built-in CartPole (the reference's canonical smoke-test env,
re-implemented from the classic dynamics) so tests and examples run
hermetically.
"""

from __future__ import annotations

import numpy as np


class CartPole:
    """Classic cart-pole balancing, discrete actions {0, 1}.

    Physics per Barto, Sutton & Anderson (1983) — the same dynamics the
    reference's smoke tests exercise through gym."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180
    MAX_STEPS = 200

    observation_size = 4
    num_actions = 2

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._steps = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN *
            (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        done = bool(abs(x) > self.X_LIMIT or
                    abs(theta) > self.THETA_LIMIT or
                    self._steps >= self.MAX_STEPS)
        return self._state.astype(np.float32), 1.0, done, {}
