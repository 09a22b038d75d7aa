"""JAX parameter tree and train state -> the port's tensors.

The JAX package's ``init_params`` tree, handed over as nested dicts of
numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``), becomes the
port's tree of tensors, nested as it is (``layers["moe"]`` of an MoE
model too): norm weights (``ln*``) in float32, every other leaf in
``cfg.dtype``.  JAX's bfloat16 leaves pass through
``np.asarray(x, np.float32)``, which needs no ``ml_dtypes`` import here;
bf16 -> f32 -> bf16 is lossless, so both packages compute on the same
weights.  ``train_state_from_numpy`` carries a whole train state
(parameters, optax's Adam moments and count, the step) the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, train_state


def params_from_numpy(tree: Dict, cfg: TransformerConfig,
                      device=None) -> Dict:
    dev = resolve_device(device)

    def convert(name, x):
        if isinstance(x, dict):
            return {k: convert(k, v) for k, v in x.items()}
        dtype = torch.float32 if name.startswith("ln") else cfg.dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    return {k: convert(k, v) for k, v in tree.items()}


def train_state_from_numpy(state: Dict, cfg: TransformerConfig,
                           device=None) -> Dict:
    """JAX's ``make_train_state`` state ``{"params", "opt", "step"}``,
    with numpy leaves (``jax.tree.map(np.asarray, state)``), as the
    port's train state (for the port's ``AdamW``).  ``opt`` is optax's
    state tuple: its entry with ``count``, ``mu`` and ``nu`` (the Adam
    moments, in each parameter's dtype as the parameters are) is carried;
    the others (optax's empty states) hold nothing."""
    adam = next(e for e in state["opt"] if hasattr(e, "mu"))
    opt = {"count": torch.tensor(int(np.asarray(adam.count)),
                                 dtype=torch.int32),
           "mu": params_from_numpy(adam.mu, cfg, device),
           "nu": params_from_numpy(adam.nu, cfg, device)}
    return train_state(params_from_numpy(state["params"], cfg, device), opt,
                       int(np.asarray(state["step"])))
