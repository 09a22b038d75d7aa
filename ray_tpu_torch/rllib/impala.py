"""IMPALATrainer: async actor sampling + V-trace off-policy correction.

A port of ``ray_tpu.rllib.impala`` (reference
``rllib/agents/impala/impala.py`` and ``vtrace.py``: samplers run ahead
of the learner, batches stream in as they finish, importance-weighted
V-trace targets correct the policy lag; Espeholt et al. 2018).  The
reference's backward ``lax.scan`` is a reverse loop over time on
tensors here, each step in the reference's float32 order; the update
runs under autograd on the policy's device with the port's ``Adam``.
The async pipeline is ``ray_tpu_torch.wait`` over in-flight sample
futures.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.policy import (ActorCritic, _entropy,
                                        batch_tensors, mlp_apply)
from ray_tpu_torch.rllib.ppo import policy_config

DEFAULT_CONFIG: Dict = {
    "num_workers": 2,
    "rollout_fragment_length": 128,   # T per trajectory fragment
    "train_batches_per_iter": 8,      # fragments consumed per train()
    "max_inflight_per_worker": 2,     # sampling runs ahead of learning
    "lr": 5e-4,
    "gamma": 0.99,
    "vf_coeff": 0.5,
    "ent_coeff": 0.01,
    "rho_bar": 1.0,                   # V-trace clipping
    "c_bar": 1.0,
    "hidden": (64, 64),
    "seed": 0,
    "device": None,                   # the learner's and workers': the card
}


def compute_vtrace(target_logp, behavior_logp, rewards, dones, values,
                   bootstrap_value, gamma: float, rho_bar: float,
                   c_bar: float):
    """Pure V-trace (Espeholt et al. 2018; reference vtrace.py) on
    tensors of one device: returns (vs targets [T], pg advantages [T]).
    A reverse loop over time:
        delta_t = rho_t (r_t + gamma_t V_{t+1} - V_t)
        vs_t - V_t = delta_t + gamma_t c_t (vs_{t+1} - V_{t+1})
    Inputs are treated as constants (callers pass them detached)."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    discount = gamma * (1.0 - dones)
    boot = torch.as_tensor(bootstrap_value, dtype=values.dtype,
                           device=values.device).reshape(1)
    v_tp1 = torch.cat([values[1:], boot])
    deltas = rho * (rewards + discount * v_tp1 - values)
    dvs = torch.empty_like(deltas)
    acc = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discount[t] * c[t] * acc
        dvs[t] = acc
    vs = values + dvs
    vs_tp1 = torch.cat([vs[1:], boot])
    pg_adv = rho * (rewards + discount * vs_tp1 - values)
    return vs, pg_adv


def make_vtrace_update(policy: ActorCritic, gamma: float,
                       vf_coeff: float, ent_coeff: float,
                       rho_bar: float, c_bar: float):
    """V-trace targets + policy gradient + value + entropy losses over
    one trajectory fragment, then one ``Adam`` step on ``policy``.
    ``update(params, opt_state, batch)`` updates them in place and
    returns ``(params, opt_state, loss, vf_loss, entropy)``, the
    reference's tuple."""

    def loss_fn(p, b):
        obs = b["obs"]                                   # [T, obs]
        logits = mlp_apply(p["pi"], obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        T = obs.shape[0]
        logp = logp_all[torch.arange(T, device=obs.device), b["actions"]]
        values = mlp_apply(p["vf"], obs)[:, 0]           # [T]
        vs, pg_adv = compute_vtrace(
            logp.detach(), b["behavior_logp"], b["rewards"], b["dones"],
            values.detach(), b["bootstrap_value"], gamma, rho_bar, c_bar)
        pg_loss = -torch.mean(logp * pg_adv)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        entropy = _entropy(logp_all)
        loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return loss, vf_loss, entropy

    def update(params, opt_state, batch):
        if params is not policy.params or opt_state is not policy.opt_state:
            raise ValueError("make_vtrace_update steps its policy's own "
                             "params and opt_state")
        loss, vf_loss, entropy = loss_fn(
            params, batch_tensors(batch, policy.device))
        policy._grad_step(loss)
        return (policy.params, policy.opt_state, loss.detach(),
                vf_loss.detach(), entropy.detach())

    return update


class _TrajectoryWorker:
    """Sampler emitting RAW trajectory fragments with behavior log-probs
    and a bootstrap value — what V-trace needs (the reference's
    RolloutWorker in IMPALA's execution plan)."""

    def __init__(self, env_fn: Callable, policy_config: Dict,
                 seed: int = 0):
        from ray_tpu_torch.rllib.rollout_worker import EnvLoop
        self.loop = EnvLoop(env_fn())
        self.policy = ActorCritic(seed=seed, **policy_config)

    def set_weights(self, weights: Dict):
        self.policy.set_weights(weights)
        return True

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        obs_dim = len(self.loop.obs)
        cols = {
            "obs": np.zeros((num_steps, obs_dim), np.float32),
            "actions": np.zeros(num_steps, np.int32),
            "rewards": np.zeros(num_steps, np.float32),
            "dones": np.zeros(num_steps, np.float32),
            "behavior_logp": np.zeros(num_steps, np.float32),
        }

        def policy_step(obs):
            action, logp, _v = self.policy.compute_actions(obs[None, :])
            return int(action[0]), float(logp[0])

        def record(t, obs, action, reward, _nxt, done, logp):
            cols["obs"][t] = obs
            cols["actions"][t] = action
            cols["behavior_logp"][t] = logp
            cols["rewards"][t] = reward
            cols["dones"][t] = float(done)

        self.loop.run(num_steps, policy_step, record)
        _, _, last_v = self.policy.compute_actions(
            self.loop.obs[None, :])
        cols["bootstrap_value"] = np.float32(last_v[0])
        cols["episode_rewards"] = self.loop.drain_episode_rewards()
        return cols


TrajectoryWorker = ray_tpu_torch.remote(_TrajectoryWorker)


class IMPALATrainer:
    """Decoupled actor-learner loop: keep N sample futures in flight per
    worker, consume whichever finishes first (ray_tpu_torch.wait), train
    on each fragment with V-trace, refresh that worker's weights,
    resubmit — samplers never block on the learner and vice versa."""

    def __init__(self, env_fn: Callable, config: Optional[Dict] = None):
        self.config = dict(DEFAULT_CONFIG)
        self.config.update(config or {})
        cfg = self.config
        pc = policy_config(env_fn, cfg)
        self.policy = ActorCritic(seed=cfg["seed"], **pc)
        self._update = make_vtrace_update(
            self.policy, cfg["gamma"], cfg["vf_coeff"],
            cfg["ent_coeff"], cfg["rho_bar"], cfg["c_bar"])
        self.workers = [
            TrajectoryWorker.remote(env_fn, pc, seed=3000 + i)
            for i in range(cfg["num_workers"])]
        ray_tpu_torch.get([w.set_weights.remote(self.policy.get_weights())
                           for w in self.workers])
        # Prime the pipeline: futures owned per worker.
        self._inflight: Dict = {}
        for w in self.workers:
            for _ in range(cfg["max_inflight_per_worker"]):
                ref = w.sample.remote(cfg["rollout_fragment_length"])
                self._inflight[ref] = w
        self.iteration = 0
        self.timesteps_total = 0

    def train(self) -> Dict:
        cfg = self.config
        stats = {}
        episode_rewards = []
        consumed = 0
        while consumed < cfg["train_batches_per_iter"]:
            ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()),
                                          num_returns=1, timeout=60.0)
            if not ready:
                break
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref)
            episode_rewards.extend(batch.pop("episode_rewards"))
            self.policy.params, self.policy.opt_state, loss, vf, ent = \
                self._update(self.policy.params, self.policy.opt_state,
                             batch)
            stats = {"loss": float(loss), "vf_loss": float(vf),
                     "entropy": float(ent)}
            self.timesteps_total += len(batch["obs"])
            consumed += 1
            # Refresh the worker's policy, then keep it sampling.
            worker.set_weights.remote(self.policy.get_weights())
            new_ref = worker.sample.remote(
                cfg["rollout_fragment_length"])
            self._inflight[new_ref] = worker
        self.iteration += 1
        rewards = np.asarray(episode_rewards, np.float32)
        return {
            "training_iteration": self.iteration,
            "timesteps_total": self.timesteps_total,
            "batches_this_iter": consumed,
            "episodes_this_iter": len(rewards),
            "episode_reward_mean": float(rewards.mean())
            if len(rewards) else float("nan"),
            **stats,
        }

    def compute_action(self, obs: np.ndarray) -> int:
        action, _l, _v = self.policy.compute_actions(
            np.asarray(obs, np.float32)[None, :])
        return int(action[0])

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

    def stop(self):
        self._inflight.clear()
        for w in self.workers:
            ray_tpu_torch.kill(w)
        self.workers = []
