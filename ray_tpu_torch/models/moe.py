"""Switch mixture-of-experts FFN, on one device or with its experts over
a mesh's ``ep`` axis.

The counterpart of ``ray_tpu/models/moe.py``: a top-1 router, experts of
capacity C = ``max(1, int(capacity_factor * T / n_experts))`` for T =
B * S tokens, tokens past their expert's capacity dropped (the residual
passes them through), and the Switch load-balance auxiliary loss.

Per layer, as the reference (``:12-19`` there):

    probs   = softmax(x @ wr) in float32           [T, E]
    choice  = argmax_E probs                       (first maximum)
    pos     = rank of each token within its expert (exclusive cumsum)
    ex_in   = the kept tokens in their (expert, slot)      [E, C, D]
    ex_out  = silu(ex_in @ w1_e) * (ex_in @ w3_e) @ w2_e   per expert
    y       = gate * ex_out at each token's (expert, slot), 0 if dropped

The reference moves tokens with a one-hot ``dispatch [T, E, C]`` and two
float32 einsums over it (``:65-99``).  Each (expert, slot) holds at most
one token and each token at most one slot, so every element of ``ex_in``
and ``y`` is a sum with one nonzero term: the port computes the same
values by index, a gather into the slots and a gather back, without the
[T, E, C] tensor (335 MB and two 172 GFLOP products a layer at 8,192
tokens, 8 experts and capacity 1.25).  ``gate`` is
``probs.gather(choice)``, so its gradient reaches the chosen expert only;
``jnp.max`` would split it among exact ties.  The expert products are
plain batched products, as the JAX package leaves them to XLA.

On a mesh (``parallel.mesh.build_mesh``) the tokens are split over dp
and sp and replicated over ep, and the experts split over ep
(:func:`moe_param_specs`).  Routing stays global: the capacity counts
the global T, and a token's place in its expert's queue is its rank in
the global row-major [B * S] order, which a rank's tokens do not cover
in one run under sp, so each token's offset comes from the per-row
counts of every (dp, sp) rank (one all-gather of [E, B/dp] counts).
Each ep rank runs its own experts on its (dp, sp) block's tokens, each
in its global slot, and the partial outputs are summed over ep (g)
before the gate multiplies them, so the router's gradient is whole on
every ep rank (the auxiliary's too) and is not summed over ep.  The
auxiliary's f and p are means over the global tokens.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.parallel.collectives import (all_gather, copy_to,
                                                reduce_from)
from ray_tpu_torch.parallel.mesh import axis_index, axis_size, check_mesh

#: The axes that split a layer's tokens.
TOKEN_AXES = ("dp", "sp")


def init_moe_params(generator: torch.Generator, n_layers: int, d_model: int,
                    d_ff: int, n_experts: int, dtype, device) -> Dict:
    """The reference's stacked expert weights: router ``wr [L, D, E]``,
    ``w1``/``w3 [L, E, D, F]`` and ``w2 [L, E, F, D]``, normal(0.02)
    drawn in float32 from ``generator`` (on its own device) and cast to
    ``dtype`` on ``device``."""
    def stacked(shape):
        x = torch.randn((n_layers, *shape), generator=generator,
                        device=generator.device, dtype=torch.float32) * 0.02
        return x.to(device=device, dtype=dtype)

    return {
        "wr": stacked((d_model, n_experts)),
        "w1": stacked((n_experts, d_model, d_ff)),
        "w3": stacked((n_experts, d_model, d_ff)),
        "w2": stacked((n_experts, d_ff, d_model)),
    }


def moe_param_specs() -> Dict:
    """Experts sharded over ``ep``; router replicated."""
    return {
        "wr": (None, None),
        "w1": (None, "ep", None, None),
        "w3": (None, "ep", None, None),
        "w2": (None, "ep", None, None),
    }


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert, computed as the reference computes it."""
    return max(1, int(capacity_factor * n_tokens / n_experts))


def route(xt: torch.Tensor, wr: torch.Tensor, cap: int, mesh=None,
          rows: int = 1):
    """The router on tokens ``xt [T, D]``: ``(probs [T, E] float32,
    choice [T], slot [T])``, where ``slot`` is ``choice * cap + pos`` for
    a token kept at position ``pos < cap`` of its expert's queue and
    ``E * cap`` for a dropped one.  On a mesh ``xt`` is this rank's
    block of ``rows`` rows and ``pos`` the rank in the global order."""
    n_experts = wr.shape[-1]
    probs = torch.softmax(xt.float() @ wr.float(), dim=-1)
    choice = torch.argmax(probs, dim=-1)
    # Exclusive rank within the chosen expert, in token order: a running
    # count along the token axis of the one-hot, laid out [E, T] so that
    # the scan runs along the innermost axis (along the outer axis of a
    # [T, E] tensor PyTorch's CUDA scan gives each of the E columns one
    # thread: 1.45 ms a call at T = 8,192 on the H100).
    onehot = (choice[None, :] == torch.arange(
        n_experts, device=choice.device)[:, None]).to(torch.int32)
    if mesh is None:
        pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
            0, choice[None, :])[0] - 1
    else:
        pos = _global_rank_in_queue(onehot, choice, mesh, rows)
    slot = torch.where(pos < cap, choice * cap + pos,
                       torch.full_like(choice, n_experts * cap))
    return probs, choice, slot


def _global_rank_in_queue(onehot: torch.Tensor, choice: torch.Tensor,
                          mesh, rows: int) -> torch.Tensor:
    """Each token's exclusive rank in its expert's queue in the global
    row-major [B * S] order, from this rank's one-hot [E, T] of ``rows``
    rows: the tokens of earlier rows on every (dp, sp) rank, of this
    row in earlier sp chunks, then of this chunk before it."""
    E = onehot.shape[0]
    per_row = onehot.view(E, rows, -1)
    within = torch.cumsum(per_row, dim=2, dtype=torch.int32) - per_row
    counts = per_row.sum(dim=2, dtype=torch.int32)               # [E, b]
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    # [E, dp * sp * b] in (dp, sp) order -> [E, dp, b, sp] -> rows x chunks.
    every = all_gather(counts, 1, mesh, TOKEN_AXES).view(E, dp, sp, rows)
    every = every.permute(0, 1, 3, 2).reshape(E, -1)
    before = torch.cumsum(every, dim=1, dtype=torch.int32) - every
    d, s = axis_index(mesh, "dp"), axis_index(mesh, "sp")
    mine = before.view(E, dp, rows, sp)[:, d, :, s]              # [E, b]
    pos = (within + mine[:, :, None]).view(E, -1)
    return pos.gather(0, choice[None, :])[0]


def moe_ffn(x: torch.Tensor, lp: Dict, n_experts: int,
            capacity_factor: float, mesh=None) -> torch.Tensor:
    """One MoE FFN block: x [B, S, D] -> [B, S, D] (residual not
    included).  ``lp`` holds this layer's wr/w1/w3/w2.  On a mesh ``x``
    is this rank's block of the layer's tokens and ``lp``'s experts its
    shard over ep."""
    if mesh is not None:
        check_mesh(mesh)
    B, S, D = x.shape
    T = B * S
    cap = capacity(T * axis_size(mesh, TOKEN_AXES), n_experts,
                   capacity_factor)
    xt = x.reshape(T, D)
    probs, choice, slot = route(xt, lp["wr"], cap, mesh, B)
    gate = probs.gather(-1, choice[:, None])                 # [T, 1]
    # This rank's experts (all of them off a mesh) and their slots; a
    # slot of another ep rank, like a dropped token, maps to the zero row
    # at the end.
    n_local = lp["w1"].shape[0]
    if axis_size(mesh, "ep") > 1:
        slot = slot - axis_index(mesh, "ep") * n_local * cap
        slot = torch.where((slot >= 0) & (slot < n_local * cap), slot,
                           torch.full_like(slot, n_local * cap))
    # The token in each (expert, slot), T (a zero row) where none is.
    owner = torch.full((n_local * cap + 1,), T, dtype=slot.dtype,
                       device=x.device)
    owner.scatter_(0, slot, torch.arange(T, device=x.device))
    xe = copy_to(xt, mesh, "ep")
    xt0 = torch.cat([xe, xe.new_zeros(1, D)])
    ex_in = xt0.index_select(0, owner[:-1]).view(n_local, cap, D)
    h = torch.nn.functional.silu(torch.bmm(ex_in, lp["w1"])) * \
        torch.bmm(ex_in, lp["w3"])
    ex_out = torch.bmm(h, lp["w2"]).view(n_local * cap, D)
    ex_out0 = torch.cat([ex_out, ex_out.new_zeros(1, D)])
    # One nonzero term per token over ep: the sum is exact.
    y = reduce_from(ex_out0.index_select(0, slot), mesh, "ep")
    return (gate * y.float()).to(x.dtype).view(B, S, D)


def aux_load_balance_loss(x: torch.Tensor, wr: torch.Tensor,
                          n_experts: int, mesh=None) -> torch.Tensor:
    """Switch load-balance auxiliary loss: E * sum_e f_e * p_e, where
    f_e = fraction of tokens routed to e, p_e = mean router prob.  On a
    mesh both are means over the global tokens: their sums are summed
    over dp and sp before the product."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1).float() @ wr.float(), dim=-1)
    choice = torch.nn.functional.one_hot(torch.argmax(probs, dim=-1),
                                         n_experts).float()
    n = T * axis_size(mesh, TOKEN_AXES)
    f = reduce_from(choice.sum(dim=0), mesh, TOKEN_AXES) / n
    p = reduce_from(probs.sum(dim=0), mesh, TOKEN_AXES) / n
    return n_experts * torch.sum(f * p)
