"""Actor-critic policy and PPO loss for the PyTorch port.

A port of ``ray_tpu.rllib.policy`` (reference ``rllib/policy/`` and
``rllib/agents/ppo/ppo_*_policy.py``: clipped-surrogate PPO loss, GAE
advantages).  The JAX package keeps its nets as pytrees of plain
matrices and runs the update under ``jax.jit`` with ``optax.adam``; here
the same trees are dicts of tensors on the policy's device (``w{i}``,
``b{i}``, as there), the loss runs under autograd and the step is the
port's :class:`~ray_tpu_torch.models.optim.Adam` (optax's arithmetic).
Weights travel between the trainer and its workers as numpy trees of
the reference's format (``get_weights``/``set_weights``).

The products are small float32 matrices (hidden (64, 64)) and stay
``@``: the reference computes them with plain ``@`` outside any Pallas
kernel (``ray_tpu/rllib/policy.py:38-45``).

Draws differ by design: the reference's threefry streams
(``jax.random.normal`` at init, ``categorical`` when acting) are not
reproduced.  ``init_mlp_params`` draws from a CPU ``torch.Generator``
seeded by ``rng_seed`` (the same weights on every device), and
``compute_actions`` samples from a generator on the policy's device
seeded by ``seed + 2``.  Tests carry weights across with
:func:`from_jax_params` and feed the same actions instead.

Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.optim import Adam, leaves, tree_like


def init_mlp_params(rng_seed: int, sizes, device=None) -> Dict:
    """He-initialized MLP tree: sizes = [in, hidden..., out]."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(rng_seed)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn(fan_in, fan_out, generator=gen) * np.sqrt(
            2.0 / fan_in)
        params[f"w{i}"] = w.to(dev)
        params[f"b{i}"] = torch.zeros(fan_out, device=dev)
    return params


def mlp_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params) // 2
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def to_numpy(tree):
    """A tree of tensors as a tree of numpy arrays (the weights' format),
    copies: a later step does not change them."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def to_tensors(tree, device, requires_grad: bool = False):
    """A tree of arrays (numpy, or anything ``np.asarray`` reads) as
    float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device, requires_grad)
                for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree, dtype=np.float32), device=device)
    return t.requires_grad_(requires_grad)


def from_jax_params(params, opt_state=None) -> Tuple[Dict, Optional[Dict]]:
    """The JAX package's trees as numpy: ``params`` (an actor-critic's
    ``{"pi", "vf"}``, a Q or target tree), and, if given, optax's adam
    state (a ``ScaleByAdamState``, alone or first in ``optax.adam``'s
    chain state) as ``{"count", "mu", "nu"}``.  Pass the first to
    ``set_weights``, the second to ``set_opt_state``."""
    weights = _numpy_tree(params)
    if opt_state is None:
        return weights, None
    states = (opt_state,) if hasattr(opt_state, "mu") else opt_state
    adam = next(s for s in states if hasattr(s, "mu"))
    return weights, {"count": np.asarray(adam.count, dtype=np.int32),
                     "mu": _numpy_tree(adam.mu), "nu": _numpy_tree(adam.nu)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def batch_tensors(batch: Dict[str, np.ndarray], device) -> Dict:
    """A numpy batch as tensors on ``device`` (integer columns as int64,
    for indexing; ``indices`` is the replay buffer's and stays out)."""
    out = {}
    for k, v in batch.items():
        if k == "indices":
            continue
        a = np.asarray(v)
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        out[k] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return out


class _Learner:
    """What the policies share: the parameter tree (leaves that take
    gradients), the Adam state, weights in and out as numpy, and one
    optimiser step from a loss."""

    device: torch.device
    params: Dict
    opt_state: Dict
    _opt: Adam

    def _grad_step(self, loss: torch.Tensor) -> None:
        grads = torch.autograd.grad(loss, leaves(self.params))
        self._opt.update_(self.params, tree_like(self.params, grads),
                          self.opt_state)

    def get_weights(self) -> Dict:
        return to_numpy(self.params)

    def set_weights(self, weights: Dict):
        self.params = to_tensors(weights, self.device, requires_grad=True)

    def get_opt_state(self) -> Dict:
        return {"count": np.asarray(int(self.opt_state["count"]), np.int32),
                "mu": to_numpy(self.opt_state["mu"]),
                "nu": to_numpy(self.opt_state["nu"])}

    def set_opt_state(self, state: Dict):
        self.opt_state = {
            "count": torch.tensor(int(state["count"]), dtype=torch.int32),
            "mu": to_tensors(state["mu"], self.device),
            "nu": to_tensors(state["nu"], self.device)}


def _entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def _clip(x, lo, hi):
    """``jnp.clip``: a maximum then a minimum (their gradients split at
    ties, as JAX's do)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


class ActorCritic(_Learner):
    """Shared-nothing actor and critic MLPs: action sampling and the PPO
    update on the policy's device (the card unless ``device="cpu"``)."""

    def __init__(self, obs_size: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64), lr: float = 3e-4,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.num_actions = num_actions
        self.params = {
            "pi": init_mlp_params(seed, [obs_size, *hidden, num_actions],
                                  self.device),
            "vf": init_mlp_params(seed + 1, [obs_size, *hidden, 1],
                                  self.device),
        }
        for t in leaves(self.params):
            t.requires_grad_(True)
        self._opt = Adam(lr)
        self.opt_state = self._opt.init(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)

    # ---- rollout-side ---------------------------------------------------
    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray):
        x = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        logits = mlp_apply(self.params["pi"], x)
        # Gumbel-max, as jax.random.categorical samples.
        u = torch.rand(logits.shape, generator=self._gen,
                       device=self.device).clamp_min(1e-20)
        action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        logp = torch.log_softmax(logits, dim=-1)[
            torch.arange(x.shape[0], device=self.device), action]
        value = mlp_apply(self.params["vf"], x)[:, 0]
        return (action.to(torch.int32).cpu().numpy(), logp.cpu().numpy(),
                value.cpu().numpy())

    # ---- trainer-side ---------------------------------------------------
    def ppo_loss(self, params: Dict, b: Dict, clip_eps: float,
                 vf_coeff: float, ent_coeff: float):
        """``policy.py:75-97``'s loss on a batch of tensors: (loss,
        vf_loss, entropy)."""
        logits = mlp_apply(params["pi"], b["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all[torch.arange(b["obs"].shape[0], device=self.device),
                        b["actions"]]
        ratio = torch.exp(logp - b["logp_old"])
        adv = b["advantages"]
        surrogate = torch.minimum(
            ratio * adv, _clip(ratio, 1 - clip_eps, 1 + clip_eps) * adv)
        value = mlp_apply(params["vf"], b["obs"])[:, 0]
        vf_loss = torch.mean((value - b["returns"]) ** 2)
        entropy = _entropy(logp_all)
        loss = (-torch.mean(surrogate) + vf_coeff * vf_loss -
                ent_coeff * entropy)
        return loss, vf_loss, entropy

    def sgd_step(self, batch: Dict[str, np.ndarray], clip_eps: float,
                 vf_coeff: float, ent_coeff: float) -> Dict[str, float]:
        b = batch_tensors(batch, self.device)
        loss, vf_loss, entropy = self.ppo_loss(self.params, b, clip_eps,
                                               vf_coeff, ent_coeff)
        self._grad_step(loss)
        return {"loss": float(loss.detach()),
                "vf_loss": float(vf_loss.detach()),
                "entropy": float(entropy.detach())}


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, last_value: float,
                gamma: float, lam: float):
    """Generalized advantage estimation (reference: ppo utils)."""
    n = len(rewards)
    advantages = np.zeros(n, dtype=np.float32)
    gae = 0.0
    next_value = last_value
    for t in reversed(range(n)):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        advantages[t] = gae
        next_value = values[t]
    returns = advantages + values
    return advantages, returns
