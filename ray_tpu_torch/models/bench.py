"""``bench_model.py``'s single-chip model, defined once for the card's
measurements (``chip_smoke.py``'s M2/T2 and M3/T3,
``tools/profile_forward.py`` and ``tools/profile_train.py``): its
configuration (``bench_model.py:59-62``, the "realistic single-chip
size", with ``remat=True``), its batch, the seeds of the random weights
and tokens, the training batch and repetitions
(``bench_model.py:62, 71-77``) and its FLOP accounting (``:94-96``).

``MOE_CONFIG`` is the same model with the switch-MoE FFN of 8 experts at
the config's default capacity factor 1.25 and auxiliary weight 0.01: the
JAX package has no MoE bench config, and 8 experts at 1.25 is the size
the port's plan reckons with.  It runs at the same batch;
``moe_train_flops`` counts its step."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.moe import capacity
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              make_train_state,
                                              make_train_step)

CONFIG = TransformerConfig(vocab_size=32_000, d_model=1024, n_layers=8,
                           n_heads=16, d_ff=4096, max_seq_len=1024,
                           dtype=torch.bfloat16, remat=True)
MOE_CONFIG = dataclasses.replace(CONFIG, moe_experts=8)
BATCH, SEQ = 8, 1024
PARAM_SEED, TOKEN_SEED = 0, 4
# bench_model.py's training batch (np.random.default_rng(0)) and timed
# steps.
TRAIN_TOKEN_SEED, TRAIN_REPS = 0, 10


def make(device=None, cfg=None):
    """The model at ``cfg`` (``None``: ``CONFIG``) with weights drawn from
    ``PARAM_SEED`` on ``device``, and uniform tokens [BATCH, SEQ + 1]
    from ``TOKEN_SEED`` (``loss`` takes them whole, the forward
    ``tokens[:, :-1]``)."""
    cfg = cfg or CONFIG
    dev = resolve_device(device)
    model = Transformer(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(PARAM_SEED))
    tokens = torch.from_numpy(np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int64)).to(dev)
    return model, tokens


def train_tokens(device=None, cfg=None) -> torch.Tensor:
    """``bench_model.py``'s training batch: tokens [BATCH, SEQ + 1] below
    ``cfg``'s vocabulary (``None``: ``CONFIG``) from
    ``np.random.default_rng(TRAIN_TOKEN_SEED)`` (``:71-77``)."""
    tokens = np.random.default_rng(TRAIN_TOKEN_SEED).integers(
        0, (cfg or CONFIG).vocab_size, (BATCH, SEQ + 1))
    return torch.from_numpy(tokens.astype(np.int64)).to(
        resolve_device(device))


def make_train(device=None, cfg=None, mesh=None):
    """The train state at ``cfg`` (``None``: ``CONFIG``) with weights
    drawn from ``PARAM_SEED`` on ``device``, its step function, and the
    training batch: ``(state, step, batch)``.  With ``mesh`` the state
    holds this rank's shards and the step runs on the mesh (the same
    weights and batch)."""
    cfg = cfg or CONFIG
    dev = resolve_device(device)
    state, tx = make_train_state(
        torch.Generator(device=dev).manual_seed(PARAM_SEED), cfg,
        mesh=mesh, device=dev)
    return state, make_train_step(cfg, tx, mesh=mesh), {
        "tokens": train_tokens(device=dev, cfg=cfg)}


def make_pp_train(mesh, n_micro: int, device=None, cfg=None):
    """:func:`make_train` on the GPipe schedule of ``parallel.pipeline``
    over ``mesh``'s pp axis with ``n_micro`` microbatches: the same
    weights and batch; ``(state, step, batch, loss)`` with ``loss(params,
    batch)`` the schedule's loss."""
    from ray_tpu_torch.parallel import pipeline
    cfg = cfg or CONFIG
    dev = resolve_device(device)
    state, tx = pipeline.make_pp_train_state(
        torch.Generator(device=dev).manual_seed(PARAM_SEED), cfg, mesh,
        device=dev)
    return (state, pipeline.make_pp_train_step(cfg, tx, mesh, n_micro),
            {"tokens": train_tokens(device=dev, cfg=cfg)},
            pipeline.make_pp_loss_fn(cfg, mesh, n_micro))


def n_params(params) -> int:
    """Parameters in a tree of tensors."""
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return params.numel()


def train_flops(n_params: int) -> float:
    """``bench_model.py``'s FLOPs of one train step at ``CONFIG``,
    ``BATCH`` and ``SEQ`` (``:94-96``, PaLM's appendix B):
    ``6 n_params tokens`` for the matrix products forward and backward,
    plus ``12 n_layers B S^2 d / 2`` for the causal attention's scores and
    values; about 10.2 TFLOP."""
    return (6.0 * n_params * BATCH * SEQ +
            12.0 * CONFIG.n_layers * BATCH * SEQ ** 2 * CONFIG.d_model / 2)


def moe_train_flops(cfg=None) -> float:
    """FLOPs of one train step at ``cfg`` (``None``: ``MOE_CONFIG``),
    ``BATCH`` and ``SEQ``, counting the products the step runs, forward
    and backward (3 times the forward's), with T = BATCH * SEQ tokens and
    E * C expert slots (C = ``moe.capacity``):

        6 * [ n_layers * (E C * 3 d f          the experts, every slot
                          + T * (4 d^2 + d E))  q/k/v/o and the router
              + T * d * vocab ]                 lm_head
        + 12 n_layers B S^2 d / 2               causal scores and values

    About 9.9 TFLOP at ``MOE_CONFIG``.  ``train_flops``'s
    ``6 n_params tokens`` would count all E experts for every token
    (about 44.5 TFLOP), while each token runs one and the step runs
    E * C = 1.25 T slots."""
    cfg = cfg or MOE_CONFIG
    d, f, e, nl = cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.n_layers
    tokens = BATCH * SEQ
    slots = e * capacity(tokens, e, cfg.moe_capacity_factor)
    per_layer = slots * 3 * d * f + tokens * (4 * d * d + d * e)
    return (6.0 * (nl * per_layer + tokens * d * cfg.vocab_size) +
            12.0 * nl * BATCH * SEQ ** 2 * d / 2)
