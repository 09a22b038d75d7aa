"""DQNTrainer: double DQN with (prioritized) replay over the fleet.

A port of ``ray_tpu.rllib.dqn`` (reference ``rllib/agents/dqn/dqn.py``:
the epsilon-greedy schedule, the replay buffer, target network syncs,
the store -> replay -> train execution plan).  The TD update (double-DQN
targets, Huber loss, importance weights) runs under autograd on the
policy's device with the port's ``Adam``; the target is computed without
gradients, as the reference's ``stop_gradient``.  Transitions are
columnar numpy, and the replay draws are the reference's.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.optim import Adam, leaves
from ray_tpu_torch.rllib.policy import (_Learner, batch_tensors,
                                        init_mlp_params, mlp_apply,
                                        to_tensors)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)

DEFAULT_CONFIG: Dict = {
    "num_workers": 2,
    "rollout_fragment_length": 64,     # steps per worker per round
    "buffer_size": 50_000,
    "prioritized_replay": True,
    "learning_starts": 500,            # min transitions before SGD
    "train_batch_size": 64,
    "sgd_rounds_per_iter": 32,         # minibatches per train()
    "target_network_update_freq": 300,  # SGD steps between target syncs
    "gamma": 0.99,
    "lr": 1e-3,
    "hidden": (64, 64),
    "epsilon_initial": 1.0,
    "epsilon_final": 0.05,
    "epsilon_timesteps": 4_000,        # linear decay horizon
    "double_q": True,
    "seed": 0,
    "device": None,                    # the learner's and workers': the card
}


class QPolicy(_Learner):
    """Q-network with epsilon-greedy action selection and the
    double-DQN TD update (dqn_tf_policy.py / dqn_torch_policy.py
    parity) on the policy's device (the card unless ``device="cpu"``)."""

    def __init__(self, obs_size: int, num_actions: int,
                 hidden=(64, 64), lr: float = 1e-3, gamma: float = 0.99,
                 double_q: bool = True, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.num_actions = num_actions
        self.gamma = gamma
        self.double_q = double_q
        self.params = init_mlp_params(seed, [obs_size, *hidden,
                                             num_actions], self.device)
        for t in leaves(self.params):
            t.requires_grad_(True)
        self.sync_target()
        self._opt = Adam(lr)
        self.opt_state = self._opt.init(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray,
                        epsilon: float = 0.0) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        greedy = torch.argmax(mlp_apply(self.params, x), dim=-1)
        random_a = torch.randint(0, self.num_actions, greedy.shape,
                                 generator=self._gen, device=self.device)
        explore = torch.rand(greedy.shape, generator=self._gen,
                             device=self.device) < epsilon
        return torch.where(explore, random_a, greedy).to(
            torch.int32).cpu().numpy()

    def td_loss(self, params: Dict, b: Dict):
        """The reference's ``loss_fn`` (``dqn.py:71-88``): (loss, td)."""
        q = mlp_apply(params, b["obs"])
        rows = torch.arange(q.shape[0], device=self.device)
        q_sa = q[rows, b["actions"]]
        with torch.no_grad():
            q_next_t = mlp_apply(self.target_params, b["next_obs"])
            if self.double_q:
                # Online net selects, target net evaluates.
                a_star = torch.argmax(mlp_apply(params, b["next_obs"]),
                                      dim=-1)
                q_next = q_next_t[rows, a_star]
            else:
                q_next = torch.max(q_next_t, dim=-1).values
            target = b["rewards"] + self.gamma * \
                (1.0 - b["dones"]) * q_next
        td = q_sa - target
        huber = torch.where(torch.abs(td) < 1.0, 0.5 * td ** 2,
                            torch.abs(td) - 0.5)
        w = b.get("weights", torch.ones_like(huber))
        return torch.mean(w * huber), td

    def sgd_step(self, batch: Dict[str, np.ndarray]):
        loss, td = self.td_loss(self.params,
                                batch_tensors(batch, self.device))
        self._grad_step(loss)
        return float(loss.detach()), td.detach().cpu().numpy()

    def sync_target(self):
        self.target_params = {k: v.detach().clone()
                              for k, v in self.params.items()}

    def set_target_weights(self, weights: Dict):
        self.target_params = to_tensors(weights, self.device)


class _TransitionWorker:
    """Sampler for off-policy learners: steps its env epsilon-greedily
    and returns raw transition batches (obs, action, reward, next_obs,
    done) — the store->replay half of the DQN execution plan."""

    def __init__(self, env_fn: Callable, policy_config: Dict,
                 seed: int = 0):
        from ray_tpu_torch.rllib.rollout_worker import EnvLoop
        self.loop = EnvLoop(env_fn())
        self.policy = QPolicy(seed=seed, **policy_config)

    def set_weights(self, weights: Dict):
        self.policy.set_weights(weights)
        return True

    def sample(self, num_steps: int, epsilon: float
               ) -> Dict[str, np.ndarray]:
        obs_dim = len(self.loop.obs)
        cols = {
            "obs": np.zeros((num_steps, obs_dim), np.float32),
            "actions": np.zeros(num_steps, np.int32),
            "rewards": np.zeros(num_steps, np.float32),
            "next_obs": np.zeros((num_steps, obs_dim), np.float32),
            "dones": np.zeros(num_steps, np.float32),
        }

        def policy_step(obs):
            return int(self.policy.compute_actions(
                obs[None, :], epsilon)[0]), None

        def record(t, obs, action, reward, nxt, done, _extras):
            cols["obs"][t] = obs
            cols["actions"][t] = action
            cols["rewards"][t] = reward
            cols["next_obs"][t] = nxt
            cols["dones"][t] = float(done)

        self.loop.run(num_steps, policy_step, record)
        cols["episode_rewards"] = self.loop.drain_episode_rewards()
        return cols


TransitionWorker = ray_tpu_torch.remote(_TransitionWorker)


class DQNTrainer:
    """The collect -> replay -> train loop (dqn.py execution plan)."""

    def __init__(self, env_fn: Callable, config: Optional[Dict] = None):
        self.config = dict(DEFAULT_CONFIG)
        self.config.update(config or {})
        cfg = self.config
        probe = env_fn()
        self._policy_config = {
            "obs_size": probe.observation_size,
            "num_actions": probe.num_actions,
            "hidden": tuple(cfg["hidden"]),
            "lr": cfg["lr"],
            "gamma": cfg["gamma"],
            "double_q": cfg["double_q"],
            "device": cfg["device"],
        }
        self.policy = QPolicy(seed=cfg["seed"], **self._policy_config)
        self.workers = [
            TransitionWorker.remote(env_fn, self._policy_config,
                                    seed=2000 + i)
            for i in range(cfg["num_workers"])]
        if cfg["prioritized_replay"]:
            self.buffer = PrioritizedReplayBuffer(
                cfg["buffer_size"], seed=cfg["seed"])
        else:
            self.buffer = ReplayBuffer(cfg["buffer_size"],
                                       seed=cfg["seed"])
        self.iteration = 0
        self.timesteps_total = 0
        self._sgd_steps = 0

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.timesteps_total / cfg["epsilon_timesteps"])
        return cfg["epsilon_initial"] + frac * (
            cfg["epsilon_final"] - cfg["epsilon_initial"])

    def train(self) -> Dict:
        cfg = self.config
        eps = self._epsilon()
        weights = self.policy.get_weights()
        ray_tpu_torch.get([w.set_weights.remote(weights)
                           for w in self.workers])
        batches = ray_tpu_torch.get([
            w.sample.remote(cfg["rollout_fragment_length"], eps)
            for w in self.workers])
        episode_rewards = np.concatenate(
            [b.pop("episode_rewards") for b in batches])
        for b in batches:
            n = len(b["obs"])
            self.buffer.add_batch(b)
            self.timesteps_total += n

        loss = float("nan")
        if len(self.buffer) >= cfg["learning_starts"]:
            for _ in range(cfg["sgd_rounds_per_iter"]):
                batch = self.buffer.sample(cfg["train_batch_size"])
                loss, td = self.policy.sgd_step(batch)
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(batch["indices"], td)
                self._sgd_steps += 1
                if self._sgd_steps % \
                        cfg["target_network_update_freq"] == 0:
                    self.policy.sync_target()
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "buffer_size": len(self.buffer),
            "epsilon": eps,
            "loss": loss,
            "episodes_this_iter": len(episode_rewards),
            "episode_reward_mean": float(episode_rewards.mean())
            if len(episode_rewards) else float("nan"),
        }

    def compute_action(self, obs: np.ndarray) -> int:
        return int(self.policy.compute_actions(
            np.asarray(obs, np.float32)[None, :], epsilon=0.0)[0])

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            pickle.dump({"weights": self.policy.get_weights(),
                         "iteration": self.iteration,
                         "timesteps_total": self.timesteps_total,
                         "config": self.config}, f)
        return path

    def restore(self, path: str):
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.policy.set_weights(state["weights"])
        self.policy.sync_target()
        self.iteration = state["iteration"]
        self.timesteps_total = state["timesteps_total"]

    def stop(self):
        for w in self.workers:
            ray_tpu_torch.kill(w)
        self.workers = []
