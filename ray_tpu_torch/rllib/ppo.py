"""PPOTrainer: clipped-surrogate PPO over the rollout fleet.

A port of ``ray_tpu.rllib.ppo`` (reference ``rllib/agents/ppo/ppo.py``:
config, the collect -> shuffle -> minibatch-SGD -> broadcast loop,
``train()`` returning a metrics dict, ``save``/``restore``).  The learner
runs on its device (``config["device"]``, the card unless ``"cpu"``),
and so do the workers' policies; the minibatch order comes from
``np.random.default_rng(seed)`` as in the reference, so it is the same.
A checkpoint keeps the reference's format (pickled numpy weights, the
iteration and the config), so either package restores the other's.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.policy import ActorCritic
from ray_tpu_torch.rllib.rollout_worker import WorkerSet

DEFAULT_CONFIG: Dict = {
    "num_workers": 2,
    "rollout_fragment_length": 256,   # steps per worker per iteration
    "num_sgd_epochs": 6,
    "sgd_minibatch_size": 128,
    "lr": 3e-4,
    "gamma": 0.99,
    "lambda": 0.95,
    "clip_eps": 0.2,
    "vf_coeff": 0.5,
    "ent_coeff": 0.01,
    "hidden": (64, 64),
    "seed": 0,
    "device": None,                   # the learner's and workers': the card
}


def policy_config(env_fn: Callable, cfg: Dict) -> Dict:
    """The actor-critic's arguments, as the reference's trainers build
    them, with the device."""
    probe_env = env_fn()
    return {"obs_size": probe_env.observation_size,
            "num_actions": probe_env.num_actions,
            "hidden": tuple(cfg["hidden"]), "lr": cfg["lr"],
            "device": cfg["device"]}


class PPOTrainer:
    def __init__(self, env_fn: Callable, config: Optional[Dict] = None):
        self.config = dict(DEFAULT_CONFIG)
        self.config.update(config or {})
        cfg = self.config
        pc = policy_config(env_fn, cfg)
        self.policy = ActorCritic(seed=cfg["seed"], **pc)
        self.workers = WorkerSet(env_fn, pc,
                                 num_workers=cfg["num_workers"],
                                 gamma=cfg["gamma"], lam=cfg["lambda"])
        self.iteration = 0
        self._rng = np.random.default_rng(cfg["seed"])

    # ---- one training iteration (ppo.py execution plan parity) ---------
    def train(self) -> Dict:
        cfg = self.config
        self.workers.broadcast_weights(self.policy.get_weights())
        batches = self.workers.sample(cfg["rollout_fragment_length"])
        episode_rewards = np.concatenate(
            [b.pop("episode_rewards") for b in batches])
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)

        n = len(batch["obs"])
        stats = {}
        for _epoch in range(cfg["num_sgd_epochs"]):
            order = self._rng.permutation(n)
            for start in range(0, n, cfg["sgd_minibatch_size"]):
                idx = order[start:start + cfg["sgd_minibatch_size"]]
                if len(idx) < 2:
                    continue
                minibatch = {k: v[idx] for k, v in batch.items()}
                stats = self.policy.sgd_step(
                    minibatch, cfg["clip_eps"], cfg["vf_coeff"],
                    cfg["ent_coeff"])
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_this_iter": n,
            "episodes_this_iter": len(episode_rewards),
            "episode_reward_mean": float(episode_rewards.mean())
            if len(episode_rewards) else float("nan"),
            "episode_reward_max": float(episode_rewards.max())
            if len(episode_rewards) else float("nan"),
            **stats,
        }

    # ---- checkpointing (Trainer.save/restore parity) --------------------
    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            pickle.dump({"weights": self.policy.get_weights(),
                         "iteration": self.iteration,
                         "config": self.config}, f)
        return path

    def restore(self, path: str):
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.policy.set_weights(state["weights"])
        self.iteration = state["iteration"]

    def compute_action(self, obs: np.ndarray) -> int:
        action, _logp, _value = self.policy.compute_actions(
            np.asarray(obs, dtype=np.float32)[None, :])
        return int(action[0])

    def stop(self):
        self.workers.stop()
