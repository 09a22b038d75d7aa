"""Pipeline parallelism: the transformer trained on a GPipe schedule over
a mesh's ``pp`` axis, the counterpart of ``ray_tpu/parallel/pipeline.py``.

Stages are contiguous layer groups: the stacked layer tensors are split
over ``pp`` on their leading (layer) axis, and ``embed``, ``ln_f`` and
``lm_head`` are held whole by every stage.  The schedule is the
reference's: ``n_micro + pp - 1`` steps; at step t stage 0 takes in
microbatch t during the fill phase, every stage runs its layers on what
it holds, the last stage finishes microbatch ``t - (pp - 1)`` and adds
its loss, and the activations move one stage on
(``parallel.collectives.ppermute_next``).  The loss is summed over pp
and averaged over dp.  The backward is autograd through the schedule:
each rotation's backward sends the gradient one stage back, as JAX's AD
transposes ``ppermute`` to the reverse rotation.

Every stage builds the same graph: the stage and the step select with
``torch.where`` on the stage index, as the reference's ``jnp.where``
does, never with a Python branch on the rank, so every rotation (and its
backward) is reached by every stage.

The gradients of ``embed``, ``ln_f`` and ``lm_head`` are nonzero on the
first or the last stage only and are summed over pp, those of the
layers over dp (``make_pp_train_step``): the pp loss's data axes are
("dp", "pp").  The schedule runs unsharded layer math, so pp composes
with dp only: not with tp, ep or MoE (the reference's asserts, kept as
``ValueError``s).
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.models.transformer import (TransformerConfig, _rms_norm,
                                              make_train_state,
                                              make_train_step, param_specs,
                                              run_layers)
from ray_tpu_torch.parallel.collectives import ppermute_next, reduce_from
from ray_tpu_torch.parallel.mesh import axis_index, axis_size, check_mesh

#: The mesh axes over which the stages' and replicas' losses differ.
PP_DATA_AXES = ("dp", "pp")


def pp_param_specs(cfg: TransformerConfig) -> Dict:
    """Layer stacks shard over "pp" on the layer axis; embed/head/ln_f
    keep ``param_specs``' (first/last stages read them)."""
    specs = param_specs(cfg)

    def shard_leading(spec):
        if isinstance(spec, dict):
            return {k: shard_leading(v) for k, v in spec.items()}
        return ("pp", *spec[1:]) if len(spec) else spec

    specs["layers"] = shard_leading(specs["layers"])
    return specs


def make_pp_loss_fn(cfg: TransformerConfig, mesh, n_micro: int):
    """Returns ``loss(params, batch)`` running the GPipe schedule over
    the mesh's "pp" axis (with a "dp" axis on the batch): ``params``
    this rank's shards per :func:`pp_param_specs`, ``batch`` the global
    ``{"tokens": [B, S+1]}``.  Requires n_layers % pp == 0 and
    (B/dp) % n_micro == 0."""
    check_mesh(mesh)
    pp = axis_size(mesh, "pp")
    dp = axis_size(mesh, "dp")
    if cfg.n_layers % pp:
        raise ValueError("n_layers must divide over pp stages")
    # Composition limits of this schedule: the stage body runs unsharded
    # layer math, so head/FFN tensor parallelism and MoE expert
    # parallelism cannot ride it.
    if axis_size(mesh, "tp") != 1:
        raise ValueError("pp does not compose with tp")
    if axis_size(mesh, "ep") != 1:
        raise ValueError("pp does not compose with ep")
    if cfg.moe_experts != 0:
        raise ValueError("MoE composes with ep, not pp (aux loss is not "
                         "plumbed here)")

    def ce(h, tgt, lnf, head):
        logits = torch.einsum("bsd,dv->bsv", _rms_norm(h, lnf),
                              head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tgt[..., None].long()).squeeze(-1)
        return torch.mean(logz - gold)

    def loss_fn(params: Dict, batch: Dict) -> torch.Tensor:
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        tokens = tokens.chunk(dp, 0)[axis_index(mesh, "dp")]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, S = inputs.shape
        if b % n_micro:
            raise ValueError("microbatches must divide the batch")
        mb = b // n_micro
        micro_in = inputs.reshape(n_micro, mb, S)
        micro_tgt = targets.reshape(n_micro, mb, S)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=embed.device)[None].expand(mb, S)
        p = axis_index(mesh, "pp")
        first = torch.tensor(p == 0, device=embed.device)
        last = torch.tensor(p == pp - 1, device=embed.device)
        state = torch.zeros((mb, S, cfg.d_model), dtype=cfg.dtype,
                            device=embed.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=embed.device)
        steps = n_micro + pp - 1
        for t in range(steps):
            # Stage 0 injects microbatch t during the fill phase; other
            # stages consume what rotated in.
            inject = embed.index_select(
                0, micro_in[min(t, n_micro - 1)].reshape(-1)).view(
                    mb, S, -1).to(cfg.dtype)
            x = torch.where(first & (t < n_micro), inject, state)
            y, _aux = run_layers(x, params["layers"], positions, cfg)
            # The last stage finishes microbatch t - (pp - 1).
            m = t - (pp - 1)
            if 0 <= m < n_micro:
                loss_m = ce(y, micro_tgt[m], params["ln_f"],
                            params["lm_head"])
                loss_sum = loss_sum + torch.where(last, loss_m, 0.0)
            if t + 1 < steps:
                (state,) = ppermute_next(mesh, "pp", y)
        # The loss lives on the last stage; the sum over pp shares it out.
        loss = reduce_from(loss_sum, mesh, "pp") / n_micro
        return reduce_from(loss, mesh, "dp") / dp

    return loss_fn


def make_pp_train_step(cfg: TransformerConfig, tx, mesh, n_micro: int = 4):
    """The pipeline-parallel train step: the GPipe loss and autograd
    through the schedule, then ``make_train_step``'s shared update and
    metrics, the gradients summed over :data:`PP_DATA_AXES` where the
    leaf is not split."""
    return make_train_step(cfg, tx, mesh=mesh,
                           loss_override=make_pp_loss_fn(cfg, mesh, n_micro),
                           specs_override=pp_param_specs(cfg),
                           data_axes=PP_DATA_AXES)


def make_pp_train_state(generator: torch.Generator, cfg: TransformerConfig,
                        mesh, learning_rate: float = 3e-4, device=None):
    """The train state with pp-sharded layer stacks (``make_train_state``
    with :func:`pp_param_specs`)."""
    return make_train_state(generator, cfg, mesh=mesh,
                            learning_rate=learning_rate,
                            specs_override=pp_param_specs(cfg),
                            device=device)
