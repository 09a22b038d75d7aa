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

Given a mesh, both return the calling rank's shards of JAX's global tree
(``transformer.param_specs``, or ``specs`` for another layout), on the
mesh's device unless ``device`` says otherwise; ``gather_params``
returns the global tree from every rank's shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, param_specs,
                                              train_state)
from ray_tpu_torch.parallel.collectives import all_gather
from ray_tpu_torch.parallel.mesh import shard_tree


def params_from_numpy(tree: Dict, cfg: TransformerConfig, device=None,
                      mesh=None, specs: Optional[Dict] = None) -> Dict:
    if mesh is not None and device is None:
        device = mesh.device_type
    dev = resolve_device(device)

    def convert(name, x):
        if isinstance(x, dict):
            return {k: convert(k, v) for k, v in x.items()}
        dtype = torch.float32 if name.startswith("ln") else cfg.dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    params = {k: convert(k, v) for k, v in tree.items()}
    if mesh is None:
        return params
    return shard_tree(params, specs or param_specs(cfg), mesh)


def gather_params(tree: Dict, mesh, specs: Dict) -> Dict:
    """The global tree of this rank's shards ``tree`` under ``specs``
    (every rank of the mesh calls it and gets the whole tree)."""
    if isinstance(tree, dict):
        return {k: gather_params(v, mesh, specs[k]) for k, v in tree.items()}
    t = tree.detach()
    for dim, name in enumerate(specs):
        if name is not None:
            t = all_gather(t, dim, mesh, name)
    return t


def train_state_from_numpy(state: Dict, cfg: TransformerConfig,
                           device=None, mesh=None,
                           specs: Optional[Dict] = None) -> Dict:
    """JAX's ``make_train_state`` state ``{"params", "opt", "step"}``,
    with numpy leaves (``jax.tree.map(np.asarray, state)``), as the
    port's train state (for the port's ``AdamW``).  ``opt`` is optax's
    state tuple: its entry with ``count``, ``mu`` and ``nu`` (the Adam
    moments, in each parameter's dtype as the parameters are) is carried;
    the others (optax's empty states) hold nothing.  On a mesh the
    moments are sharded like the parameters."""
    adam = next(e for e in state["opt"] if hasattr(e, "mu"))

    def carry(tree):
        return params_from_numpy(tree, cfg, device, mesh, specs)
    opt = {"count": torch.tensor(int(np.asarray(adam.count)),
                                 dtype=torch.int32),
           "mu": carry(adam.mu), "nu": carry(adam.nu)}
    return train_state(carry(state["params"]), opt,
                       int(np.asarray(state["step"])))
