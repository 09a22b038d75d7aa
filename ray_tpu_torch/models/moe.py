"""Switch mixture-of-experts FFN on one device.

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
"""

from __future__ import annotations

from typing import Dict

import torch

_MESH_SLICE = ("is not ported to ray_tpu_torch yet; it belongs to the "
               "slice that ports the device mesh, ring attention and the "
               "pipeline over torch.distributed")


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


def moe_param_specs():
    raise NotImplementedError(f"moe_param_specs {_MESH_SLICE}")


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert, computed as the reference computes it."""
    return max(1, int(capacity_factor * n_tokens / n_experts))


def route(xt: torch.Tensor, wr: torch.Tensor, cap: int):
    """The router on tokens ``xt [T, D]``: ``(probs [T, E] float32,
    choice [T], slot [T])``, where ``slot`` is ``choice * cap + pos`` for
    a token kept at position ``pos < cap`` of its expert's queue and
    ``E * cap`` for a dropped one."""
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
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        0, choice[None, :])[0] - 1
    slot = torch.where(pos < cap, choice * cap + pos,
                       torch.full_like(choice, n_experts * cap))
    return probs, choice, slot


def moe_ffn(x: torch.Tensor, lp: Dict, n_experts: int,
            capacity_factor: float, mesh=None) -> torch.Tensor:
    """One MoE FFN block: x [B, S, D] -> [B, S, D] (residual not
    included).  ``lp`` holds this layer's wr/w1/w3/w2."""
    if mesh is not None:
        raise NotImplementedError(f"an expert-parallel mesh {_MESH_SLICE}")
    B, S, D = x.shape
    T = B * S
    cap = capacity(T, n_experts, capacity_factor)
    xt = x.reshape(T, D)
    probs, choice, slot = route(xt, lp["wr"], cap)
    gate = probs.gather(-1, choice[:, None])                 # [T, 1]
    # The token in each (expert, slot), T (a zero row) where none is.
    owner = torch.full((n_experts * cap + 1,), T, dtype=slot.dtype,
                       device=x.device)
    owner.scatter_(0, slot, torch.arange(T, device=x.device))
    xt0 = torch.cat([xt, xt.new_zeros(1, D)])
    ex_in = xt0.index_select(0, owner[:-1]).view(n_experts, cap, D)
    h = torch.nn.functional.silu(torch.bmm(ex_in, lp["w1"])) * \
        torch.bmm(ex_in, lp["w3"])
    ex_out = torch.bmm(h, lp["w2"]).view(n_experts * cap, D)
    ex_out0 = torch.cat([ex_out, ex_out.new_zeros(1, D)])
    y = gate * ex_out0.index_select(0, slot).float()
    return y.to(x.dtype).view(B, S, D)


def aux_load_balance_loss(x: torch.Tensor, wr: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch load-balance auxiliary loss: E * sum_e f_e * p_e, where
    f_e = fraction of tokens routed to e, p_e = mean router prob."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1).float() @ wr.float(), dim=-1)
    choice = torch.nn.functional.one_hot(torch.argmax(probs, dim=-1),
                                         n_experts).float()
    f = choice.mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)
