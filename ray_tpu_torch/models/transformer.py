"""The flagship decoder-only transformer on one device: forward pass and
train step.

The counterpart of ``ray_tpu/models/transformer.py``: the same config,
parameter tree (layer tensors stacked ``[n_layers, ...]``), RMSNorm,
half-split RoPE, attention through ``ops.flash_attention.attention`` (the
Hopper kernels on the card, forward and backward) and dense SwiGLU FFN.
``lax.scan`` over the layer axis becomes a Python loop; with ``remat``
and grad enabled each layer runs under
``torch.utils.checkpoint.checkpoint``, as ``jax.checkpoint`` wraps the
scan body.  With ``moe_experts > 0`` the FFN is the switch-MoE of
``models/moe.py`` (``layers["moe"]``, a nested subtree) and ``loss_fn``
adds its load-balance auxiliary.  Plain matrix products stay
``torch.einsum``, as the JAX package leaves them to XLA.
``make_train_state``/``make_train_step`` train with the port's ``AdamW``
(``models/optim.py``: optax's arithmetic).

On a mesh (``parallel.mesh.build_mesh``) every function runs SPMD: each
rank holds its shards of the parameters per :func:`param_specs` and
takes the global batch, of which it computes its block (rows over
``dp``, positions over ``sp``).  The collectives GSPMD inserts for JAX
are issued here (``parallel/collectives.py``):

  * tp splits the heads of ``wq``/``wk``/``wv``/``wo`` and the hidden
    axis of ``w1``/``w3``/``w2``: f before, g after (an all-reduce after
    ``wo`` and ``w2``);
  * ``embed`` is split on d_model and gathered after the lookup;
    ``lm_head`` on the vocabulary, so the loss is a vocabulary-parallel
    cross entropy;
  * sp: RoPE on global positions and ring attention over ``sp`` when
    ``context_parallel`` is set (else q, k and v are gathered over sp);
  * ep: ``models/moe.py``'s expert-parallel FFN;
  * the loss is summed over dp and sp (g), so each rank's gradients are
    its data's share; ``make_train_step`` sums them over the axes where
    the ranks' data differ (:data:`DATA_AXES`) and updates each shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.optim import (AdamW, global_norm, leaves,
                                        tree_like)
from ray_tpu_torch.ops.flash_attention import \
    attention as flash_or_ref_attention
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.collectives import (all_reduce, copy_to, gather,
                                                reduce_from)
from ray_tpu_torch.parallel.mesh import (axis_index, axis_size, check_mesh,
                                         shard_tree)

#: The mesh axes over which the ranks of ``loss_fn`` hold different
#: data: its gradients are summed over them.
DATA_AXES = ("dp", "sp")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    #: Use ring attention over the "sp" mesh axis when its size > 1.
    context_parallel: bool = True
    #: >0 replaces the dense FFN with a switch-MoE of this many experts
    #: (models/moe.py).
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    #: Switch load-balance auxiliary loss weight.
    moe_aux_coeff: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None) -> Dict:
    """The reference's tree and shapes: normal(0.02) weights drawn in
    float32 from ``generator`` (on its own device) and cast to
    ``cfg.dtype``; the norms' weights ones in float32.  With
    ``moe_experts > 0``, ``layers["moe"]`` (``moe.init_moe_params``)
    takes the place of ``w1``/``w3``/``w2``."""
    dev = resolve_device(device)
    d, h, dh, f, nl = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                       cfg.n_layers)

    def normal(shape):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * 0.02
        return x.to(device=dev, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers = {
        "ln1": ones((nl, d)),
        "ln2": ones((nl, d)),
        "wq": normal((nl, d, h, dh)),
        "wk": normal((nl, d, h, dh)),
        "wv": normal((nl, d, h, dh)),
        "wo": normal((nl, h, dh, d)),
    }
    if cfg.moe_experts > 0:
        layers["moe"] = moe.init_moe_params(generator, nl, d, f,
                                            cfg.moe_experts, cfg.dtype, dev)
    else:
        layers.update({
            "w1": normal((nl, d, f)),
            "w3": normal((nl, d, f)),
            "w2": normal((nl, f, d)),
        })
    return {
        "embed": normal((cfg.vocab_size, d)),
        "layers": layers,
        "ln_f": ones((d,)),
        "lm_head": normal((d, cfg.vocab_size)),
    }


def param_specs(cfg: TransformerConfig) -> Dict:
    """The reference's sharding specs, leaf by leaf, as tuples (one axis
    name or ``None`` per dimension): Megatron TP on heads and FFN hidden,
    vocabulary on ``lm_head``, d_model on ``embed``; MoE expert weights
    over ``ep`` (``moe.moe_param_specs``)."""
    layers: Dict = {
        "ln1": (None, None),
        "ln2": (None, None),
        "wq": (None, None, "tp", None),
        "wk": (None, None, "tp", None),
        "wv": (None, None, "tp", None),
        "wo": (None, "tp", None, None),
    }
    if cfg.moe_experts > 0:
        layers["moe"] = moe.moe_param_specs()
    else:
        layers.update({
            "w1": (None, None, "tp"),
            "w3": (None, None, "tp"),
            "w2": (None, "tp", None),
        })
    return {
        "embed": (None, "tp"),
        "layers": layers,
        "ln_f": (None,),
        "lm_head": (None, "tp"),
    }


def batch_spec() -> tuple:
    return ("dp", "sp")


def _local_block(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of global tokens [B, S]: rows over dp,
    positions over sp."""
    for dim, name in enumerate(batch_spec()):
        n = axis_size(mesh, name)
        if tokens.shape[dim] % n:
            raise ValueError(f"tokens' dimension {dim} of size "
                             f"{tokens.shape[dim]} does not divide over "
                             f"{name} = {n}")
        tokens = tokens.chunk(n, dim)[axis_index(mesh, name)]
    return tokens


def _rms_norm(x, w, eps=1e-5):
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * w).to(x.dtype)


def _rope(x, positions, theta):
    # x: [B, S, H, D].  The reference's comment says "rotate pairs"; its
    # code rotates the two halves, x[..., :half] against x[..., half:].
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs      # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention_core(q, k, v, mesh, cfg: TransformerConfig):
    """Causal attention of this rank's heads and positions: ring
    attention over ``sp`` under context parallelism, else the flash
    route on the whole sequence (gathered over sp when it is split)."""
    sp = axis_size(mesh, "sp")
    if sp > 1 and cfg.context_parallel:
        return ring_attention(q, k, v, axis_name="sp", causal=True,
                              mesh=mesh)
    if sp > 1:
        q, k, v = (gather(t, 1, mesh, "sp", sum_grad=True)
                   for t in (q, k, v))
        o = flash_or_ref_attention(q, k, v, causal=True)
        return o.chunk(sp, 1)[axis_index(mesh, "sp")]
    return flash_or_ref_attention(q, k, v, causal=True)


def apply_layer(x, lp, positions, cfg: TransformerConfig, mesh=None):
    """One transformer block on [B, S, D] activations with this layer's
    params ``lp``; returns (x, moe_aux).  On a mesh, ``x`` is this rank's
    block (whole over tp and ep), ``lp`` its shards and ``positions`` the
    global positions of its tokens."""
    h = _rms_norm(x, lp["ln1"])
    h = copy_to(h, mesh, "tp")
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = _attention_core(q, k, v, mesh, cfg)
    x = x + reduce_from(torch.einsum("bshk,hkd->bsd", o, lp["wo"]), mesh,
                        "tp")
    h = _rms_norm(x, lp["ln2"])
    if cfg.moe_experts > 0:
        x = x + moe.moe_ffn(h, lp["moe"], cfg.moe_experts,
                            cfg.moe_capacity_factor, mesh)
        aux = moe.aux_load_balance_loss(h, lp["moe"]["wr"], cfg.moe_experts,
                                        mesh)
        return x, aux
    h = copy_to(h, mesh, "tp")
    gate = torch.nn.functional.silu(torch.einsum("bsd,df->bsf", h, lp["w1"]))
    up = torch.einsum("bsd,df->bsf", h, lp["w3"])
    x = x + reduce_from(torch.einsum("bsf,fd->bsd", gate * up, lp["w2"]),
                        mesh, "tp")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] in ``cfg.dtype``; on a mesh,
    the global tokens -> this rank's block [B/dp, S/sp, V/tp]."""
    logits, _aux = forward_with_aux(params, tokens, cfg, mesh)
    return logits


def forward_with_aux(params: Dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh=None):
    """Like :func:`forward` but also returns the mean per-layer MoE
    load-balance auxiliary (0 for dense models).  With ``cfg.remat`` and
    grad enabled each layer is rematerialised in the backward pass
    (``checkpoint``, non-reentrant): only its input is kept.  The layer's
    slices of the ``layers`` tree (the ``moe`` subtree too) enter the
    checkpoint as flat tensor arguments, in ``optim.leaves`` order.  On a
    mesh the global tokens give this rank's block of logits (see
    :func:`forward`); the auxiliary is global."""
    if mesh is not None:
        check_mesh(mesh)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    if mesh is not None:
        tokens = _local_block(tokens, mesh)
    B, S = tokens.shape
    x = embed.index_select(0, tokens.reshape(-1)).view(B, S, -1)
    x = gather(x, -1, mesh, "tp")
    start = axis_index(mesh, "sp") * S
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=embed.device)[None].expand(B, S)
    x, aux = run_layers(x, params["layers"], positions, cfg, mesh)
    x = _rms_norm(x, params["ln_f"])
    logits = torch.einsum("bsd,dv->bsv", copy_to(x, mesh, "tp"),
                          params["lm_head"])
    return logits, aux / max(1, cfg.n_layers)


def run_layers(x, layers: Dict, positions, cfg: TransformerConfig,
               mesh=None):
    """The stacked ``layers`` over x, each under ``checkpoint`` with
    ``cfg.remat`` and grad enabled: (x, the sum of the layers' MoE
    auxiliaries)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # One unbind per stacked tensor: its backward stacks the layers'
    # gradients once, where indexing each layer would materialise a
    # zero-filled full-size gradient per layer and sum them.
    stacked = [t.unbind(0) for t in leaves(layers)]

    def layer(x, *weights):
        return apply_layer(x, tree_like(layers, weights), positions, cfg,
                           mesh)

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(layers["ln1"].shape[0]):
        weights = [t[i] for t in stacked]
        if remat:
            x, layer_aux = checkpoint(layer, x, *weights, use_reentrant=False)
        else:
            x, layer_aux = layer(x, *weights)
        aux = aux + layer_aux
    return x, aux


def loss_fn(params: Dict, batch: Dict, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy in float32 (+ ``moe_aux_coeff`` times the
    MoE load-balance auxiliary when experts are on), the training loss:
    under autograd its gradient flows through the flash kernel's backward
    on the card (``full_attention`` on the CPU).
    batch = {"tokens": [B, S+1] int}, the global batch on a mesh too: the
    rank's share of the mean is summed over :data:`DATA_AXES` (g), so
    every rank returns the global loss and, under autograd, the gradient
    of its own data's share."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward_with_aux(params, inputs, cfg, mesh)
    if mesh is not None:
        targets = _local_block(targets, mesh)
    loss = reduce_from(vocab_parallel_ce(logits.float(), targets, mesh).sum(),
                       mesh, DATA_AXES) / (
        targets.numel() * axis_size(mesh, DATA_AXES))
    if cfg.moe_experts > 0 and cfg.moe_aux_coeff > 0:
        loss = loss + cfg.moe_aux_coeff * aux
    return loss


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor,
                      mesh) -> torch.Tensor:
    """Per-token cross entropy of float32 ``logits`` [..., V/tp], this
    rank's slice of the vocabulary, against global ``targets`` [...]: the
    log-sum-exp of the ranks' slices' log-sum-exps (their max taken
    outside autograd, so only the sum's all-reduce carries a gradient)
    minus the gold logit, which the rank owning its slice contributes.
    Over one rank (or off a mesh) it is ``torch.logsumexp`` minus the
    gold logit."""
    v_loc = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    if axis_size(mesh, "tp") == 1:
        return lse - logits.gather(-1, targets[..., None].long()).squeeze(-1)
    m = all_reduce(lse.detach(), mesh, "tp", op=torch.distributed.ReduceOp.MAX)
    logz = m + torch.log(reduce_from(torch.exp(lse - m), mesh, "tp"))
    local = targets.long() - axis_index(mesh, "tp") * v_loc
    inside = (local >= 0) & (local < v_loc)
    gold = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])
    gold = reduce_from(torch.where(inside, gold.squeeze(-1), 0.0), mesh,
                       "tp")
    return logz - gold


def make_train_state(generator: torch.Generator, cfg: TransformerConfig,
                     mesh=None, learning_rate: float = 3e-4,
                     specs_override: Optional[Dict] = None, device=None):
    """``(state, tx)``: ``state = {"params", "opt", "step"}`` as in the
    JAX package (``:248-272``), with ``init_params`` weights from
    ``generator`` on ``device`` (``None``: the card), requiring grad, and
    ``tx`` the port's ``AdamW(learning_rate)`` (optax's ``adamw`` with
    b1 0.9, b2 0.95, weight decay 0.1) with its state
    ``opt = {"count", "mu", "nu"}``.
    ``step`` and ``count`` are int32 CPU tensors.  On a mesh every rank
    draws the global weights (seed ``generator`` alike on every rank) on
    the mesh's device (unless ``device`` says otherwise) and keeps its
    shards per :func:`param_specs` (``specs_override`` replaces them, as
    in JAX); the Adam moments are made like the shards, as JAX's
    ``_opt_specs`` places them."""
    if mesh is not None:
        check_mesh(mesh)
        device = mesh.device_type if device is None else device
    tx = AdamW(learning_rate)
    params = init_params(generator, cfg, device)
    if mesh is not None:
        params = shard_tree(params, specs_override or param_specs(cfg), mesh)
    return train_state(params, tx.init(params)), tx


def train_state(params: Dict, opt: Dict, step: int = 0) -> Dict:
    """The train state ``{"params", "opt", "step"}``: ``params``'
    tensors, detached and made to require grad, the optimizer state
    ``opt`` (``AdamW.init``'s) and ``step`` as an int32 CPU tensor."""
    def leaf(t):
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        return t.detach().requires_grad_(True)
    return {"params": leaf(params), "opt": opt,
            "step": torch.tensor(step, dtype=torch.int32)}


def loss_and_grads(params: Dict, batch: Dict, cfg: TransformerConfig,
                   mesh=None, loss_override: Optional[Callable] = None,
                   specs_override: Optional[Dict] = None,
                   data_axes=DATA_AXES):
    """``(loss, grads)`` of ``loss_fn`` (or ``loss_override(params,
    batch)``) by autograd.  On a mesh each leaf's gradient is summed
    over the axes of ``data_axes`` that its spec (``param_specs``, or
    ``specs_override``) does not shard it over: there the ranks' data
    differ, and each holds its data's share.  Then every rank holds the
    gradient of the global loss for its shards."""
    with torch.enable_grad():
        loss = (loss_override or (lambda p, b: loss_fn(p, b, cfg, mesh)))(
            params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
    if mesh is not None:
        specs = leaves(specs_override or param_specs(cfg))
        sums: Dict = {}
        for i, spec in enumerate(specs):
            axes = tuple(a for a in data_axes if a not in spec)
            if axis_size(mesh, axes) > 1:
                sums.setdefault((axes, grads[i].dtype), []).append(i)
        grads = list(grads)
        for (axes, _), idx in sums.items():
            flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                              mesh, axes)
            for i, g in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
                grads[i] = g.view_as(grads[i])
    return loss, tree_like(params, grads)


def make_train_step(cfg: TransformerConfig, tx: AdamW, mesh=None,
                    loss_override: Optional[Callable] = None,
                    specs_override: Optional[Dict] = None,
                    data_axes=DATA_AXES):
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``, the
    counterpart of the JAX package's jitted step (``:285-305``): the loss
    and its gradients by autograd (:func:`loss_and_grads`), then ``tx``'s
    update.  The state's tensors are updated in place (the port's
    counterpart of ``donate_argnums``) and returned.  ``loss`` is taken
    before the update; ``grad_norm`` is the float32 global norm of the
    gradients.  Both stay on the device (no sync).
    ``loss_override(params, batch)`` replaces ``loss_fn``.  On a mesh
    each rank updates its shards (AdamW is elementwise) and
    ``grad_norm`` is the global tree's; ``specs_override`` and
    ``data_axes`` are the layout the pipeline's loss needs."""
    if mesh is not None:
        check_mesh(mesh)
    specs = (specs_override or param_specs(cfg)) if mesh is not None \
        else None

    def step(state: Dict, batch: Dict):
        params = state["params"]
        loss, grads = loss_and_grads(params, batch, cfg, mesh, loss_override,
                                     specs, data_axes)
        grad_norm = global_norm(grads, mesh, specs)
        tx.update_(params, grads, state["opt"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


class Transformer(nn.Module):
    """The model as a module, the port's entry point for the forward path.

    Holds the parameter tree of :func:`init_params` under the reference's
    names (``embed``, ``layers.wq`` ..., ``layers.moe.w1`` ..., ``ln_f``,
    ``lm_head``; nested ``ParameterDict``s) on
    ``device`` (``None``: the card, raising without one).  ``params``
    (e.g. from ``convert.params_from_numpy``) replaces the random init.
    The parameters do not require grad: the module serves the forward
    pass, and training goes through :func:`make_train_state` and
    :func:`make_train_step`.  On the card, a config whose ``head_dim``
    is above 256 raises in ``forward`` at any sequence length that is a
    multiple of 128: the flash kernel takes head widths up to 256
    (``ops.flash_attention.attention``)."""

    def __init__(self, cfg: TransformerConfig, params: Optional[Dict] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_params(generator, cfg, dev)

        def hold(t):
            if isinstance(t, dict):
                return nn.ParameterDict({k: hold(v) for k, v in t.items()})
            return nn.Parameter(t.to(dev), requires_grad=False)

        self.embed = hold(params["embed"])
        self.layers = hold(params["layers"])
        self.ln_f = hold(params["ln_f"])
        self.lm_head = hold(params["lm_head"])

    def params(self) -> Dict:
        """The parameter tree the functions of this module take."""
        def tree(d):
            return {k: tree(v) if isinstance(v, nn.ParameterDict) else v
                    for k, v in d.items()}
        return {"embed": self.embed, "layers": tree(self.layers),
                "ln_f": self.ln_f, "lm_head": self.lm_head}

    def forward(self, tokens) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V]."""
        return forward(self.params(), tokens, self.cfg)

    def loss(self, batch: Dict) -> torch.Tensor:
        """The evaluation loss of :func:`loss_fn`."""
        return loss_fn(self.params(), batch, self.cfg)
