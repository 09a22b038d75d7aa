"""RolloutWorker + WorkerSet: the sampling fleet.

A port of ``ray_tpu.rllib.rollout_worker`` (reference
``rllib/evaluation/rollout_worker.py``, an actor holding env + policy and
producing sample batches, and ``rllib/evaluation/worker_set.py``, the
fleet with weight broadcast and parallel sampling) on the port's actors.
``policy_config`` carries the policy's ``device`` (the card unless it
says ``"cpu"``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.policy import ActorCritic, compute_gae


class EnvLoop:
    """Shared env-stepping scaffold for every sampler (PPO rollout, DQN
    transition, IMPALA trajectory workers): reset-on-done, episode
    reward bookkeeping persisting across sample calls, and the
    final-observation hand-off for bootstrapping.  Samplers differ only
    in what they record per step."""

    def __init__(self, env):
        self.env = env
        self.obs = env.reset()
        self._episode_reward = 0.0
        self._completed: List[float] = []

    def run(self, num_steps: int, policy_step, on_transition):
        """``policy_step(obs) -> (action:int, extras)``;
        ``on_transition(t, obs, action, reward, next_obs, done,
        extras)`` records the step."""
        for t in range(num_steps):
            action, extras = policy_step(self.obs)
            nxt, reward, done, _info = self.env.step(int(action))
            on_transition(t, self.obs, action, reward, nxt, done,
                          extras)
            self._episode_reward += reward
            if done:
                self._completed.append(self._episode_reward)
                self._episode_reward = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = nxt

    def drain_episode_rewards(self) -> np.ndarray:
        out, self._completed = self._completed, []
        return np.asarray(out, dtype=np.float32)


class _RolloutWorker:
    """One sampler: steps its env with the current policy and returns
    GAE-processed batches."""

    def __init__(self, env_fn: Callable, policy_config: Dict,
                 gamma: float = 0.99, lam: float = 0.95, seed: int = 0):
        self.loop = EnvLoop(env_fn())
        self.policy = ActorCritic(seed=seed, **policy_config)
        self.gamma = gamma
        self.lam = lam

    def set_weights(self, weights: Dict):
        self.policy.set_weights(weights)
        return True

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        obs_dim = len(self.loop.obs)
        obs_buf = np.zeros((num_steps, obs_dim), dtype=np.float32)
        act_buf = np.zeros(num_steps, dtype=np.int32)
        rew_buf = np.zeros(num_steps, dtype=np.float32)
        done_buf = np.zeros(num_steps, dtype=np.float32)
        logp_buf = np.zeros(num_steps, dtype=np.float32)
        val_buf = np.zeros(num_steps, dtype=np.float32)

        def policy_step(obs):
            action, logp, value = self.policy.compute_actions(
                obs[None, :])
            return int(action[0]), (float(logp[0]), float(value[0]))

        def record(t, obs, action, reward, _nxt, done, extras):
            obs_buf[t] = obs
            act_buf[t] = action
            logp_buf[t], val_buf[t] = extras
            rew_buf[t] = reward
            done_buf[t] = float(done)

        self.loop.run(num_steps, policy_step, record)
        _, _, last_value = self.policy.compute_actions(
            self.loop.obs[None, :])
        advantages, returns = compute_gae(
            rew_buf, val_buf, done_buf, float(last_value[0]),
            self.gamma, self.lam)
        return {
            "obs": obs_buf, "actions": act_buf, "logp_old": logp_buf,
            "advantages": advantages, "returns": returns,
            "episode_rewards": self.loop.drain_episode_rewards(),
        }


RolloutWorker = ray_tpu_torch.remote(_RolloutWorker)


class WorkerSet:
    """The rollout fleet (worker_set.py parity): parallel sampling and
    weight broadcast over plain actor calls."""

    def __init__(self, env_fn: Callable, policy_config: Dict,
                 num_workers: int, gamma: float, lam: float):
        self.workers = [
            RolloutWorker.remote(env_fn, policy_config, gamma=gamma,
                                 lam=lam, seed=1000 + i)
            for i in range(num_workers)]

    def broadcast_weights(self, weights: Dict):
        ray_tpu_torch.get([w.set_weights.remote(weights)
                           for w in self.workers])

    def sample(self, steps_per_worker: int) -> List[Dict[str, np.ndarray]]:
        return ray_tpu_torch.get(
            [w.sample.remote(steps_per_worker) for w in self.workers])

    def stop(self):
        for w in self.workers:
            ray_tpu_torch.kill(w)
        self.workers = []
