"""AdamW with optax's arithmetic, for the train step.

The JAX package trains with ``optax.adamw(lr, b1=0.9, b2=0.95,
weight_decay=0.1)`` (``ray_tpu/models/transformer.py:252``) and adds the
update to each parameter in float32 (``:294-297``).  This is the port's
counterpart, as plain functions over the state tree (the counterpart of
optax's ``init``/``update``):

  * the moments ``mu`` and ``nu`` are kept in each parameter's dtype
    (optax's ``init`` on bf16 parameters gives bf16 moments);
  * every step runs optax's operations in that dtype, each rounded once,
    with its scalars rounded to that dtype as JAX's weak types are:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, the bias
    corrections ``1 - b^t`` in float32 then cast, ``u = mu_hat /
    (sqrt(nu_hat) + eps)``, ``u = u + wd p``, ``u = -lr u``;
  * the parameter becomes ``p + u``, added in float32 and rounded once.

Why not ``torch.optim.AdamW``: it multiplies the parameter by
``1 - lr wd`` in place before the Adam step.  At the default lr of 3e-4
and wd of 0.1 that factor is 1 - 3e-5, below half a bf16 ulp of 1, so on
bf16 parameters ``p.mul_(1 - 3e-5)`` leaves p unchanged and the decay is
silently dropped; optax folds the decay into the update, which is added
in float32.  It also keeps its moments in float32 where optax keeps them
in the parameter's dtype.

The step count lives on the host (a CPU int32 tensor, as the train
state's ``step``), so the bias corrections need no device sync.  Each
operation is one ``torch._foreach_*`` call over the parameters of one
dtype (one kernel launch for many tensors on the card).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ray_tpu_torch.parallel.collectives import all_reduce


def leaves(tree) -> List[torch.Tensor]:
    """A tree's tensors in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    return [tree]


def tree_like(tree, values) -> Dict:
    """``values`` (in :func:`leaves` order) in ``tree``'s structure."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _const(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a JAX weak-typed scalar is."""
    return torch.tensor(x, dtype=torch.float64).to(dtype).item()


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """optax's global norm, as ``optax_global_norm``
    (``ray_tpu/models/transformer.py:308-311``): the square root of the
    sum of squares of every leaf, in float32.  On a mesh ``tree`` holds
    this rank's shards per ``specs`` and the norm is the global tree's:
    each sharded leaf's sum of squares is summed over its shard axes, a
    replicated leaf counted once."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in leaves(tree)))
    sums: Dict = {}
    for t, spec in zip(leaves(tree), leaves(specs)):
        axes = tuple(a for a in spec if a is not None)
        sums[axes] = sums.get(axes, 0) + torch.sum(torch.square(t.float()))
    return torch.sqrt(sum(all_reduce(s, mesh, axes)
                          for axes, s in sums.items()))


class AdamW:
    """``optax.adamw(learning_rate, b1=0.9, b2=0.95, eps=1e-8,
    weight_decay=0.1)``'s arithmetic on a tree of tensors, with the JAX
    package's constants (``ray_tpu/models/transformer.py:252``); see the
    module docstring.

    ``init(params)`` gives the state ``{"count", "mu", "nu"}``;
    ``update_(params, grads, state)`` applies one step in place to the
    parameters and the state."""

    b1, b2, eps, weight_decay = 0.9, 0.95, 1e-8, 0.1

    def __init__(self, learning_rate: float = 3e-4):
        self.learning_rate = learning_rate

    def init(self, params: Dict) -> Dict:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, requires_grad=False)
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update_(self, params: Dict, grads: Dict, state: Dict) -> None:
        count = int(state["count"]) + 1
        state["count"].fill_(count)
        p_all, g_all = leaves(params), leaves(grads)
        m_all, v_all = leaves(state["mu"]), leaves(state["nu"])
        # optax: 1 - decay**count with count an int32 array: float32.
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** count)
        for dtype in sorted({p.dtype for p in p_all}, key=str):
            pick = [i for i, p in enumerate(p_all) if p.dtype == dtype]
            p = [p_all[i] for i in pick]
            g = [g_all[i] for i in pick]
            mu = [m_all[i] for i in pick]
            nu = [v_all[i] for i in pick]

            def c(x):
                return _const(x, dtype)
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu.
            t = torch._foreach_mul(g, c(1 - self.b1))
            torch._foreach_mul_(mu, c(self.b1))
            torch._foreach_add_(mu, t)
            t = torch._foreach_mul(g, g)
            torch._foreach_mul_(t, c(1 - self.b2))
            torch._foreach_mul_(nu, c(self.b2))
            torch._foreach_add_(nu, t)
            # u = mu_hat / (sqrt(nu_hat) + eps) + wd p, times -lr.
            u = torch._foreach_div(mu, c(bc1))
            den = torch._foreach_div(nu, c(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c(self.eps))
            torch._foreach_div_(u, den)
            del den
            t = torch._foreach_mul(p, c(self.weight_decay))
            torch._foreach_add_(u, t)
            del t
            torch._foreach_mul_(u, c(-self.learning_rate))
            # p + u in float32 (bf16 + bf16 is summed in float32 and
            # rounded once).
            torch._foreach_add_(p, u)
