"""Ring attention and the reference attention, the counterpart of
``ray_tpu/ops/ring_attention.py``.

``ring_attention`` is exact attention with the sequence sharded over a
mesh axis (context parallelism, ``sp``): each rank holds a chunk of the
queries, keys and values; at step s it attends its queries to the
key/value chunk ``(my_idx - s) mod n`` it holds then, and passes that
chunk on to the next rank (``parallel.collectives.ppermute_next``, K and
V in one batch of sends and receives).  The softmax is accumulated
flash-style, with the reference's ``-inf`` causal mask on global
positions, ``m_safe``, the ``isfinite`` guards on both correction
factors and the ``1e-20`` floor of the denominator (``:26-97`` there),
so fully masked blocks (a causal ring has them) give zeros, not NaN.
Its backward is autograd through the rotations, as JAX's is AD through
``ppermute``.  It stays plain PyTorch: the JAX function reaches no
Pallas kernel.  The last rotation, which JAX performs and discards, is
not made.

``full_attention`` is the single-device reference (``:100-115`` there):
logits in float32, a ``-inf`` causal mask, softmax, then the
probabilities cast to ``v.dtype`` before the product with ``v``, output
in ``q.dtype``.  It is what ``ops.flash_attention.attention`` runs on
the CPU and for shapes outside the kernel's gate.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel.collectives import ppermute_next
from ray_tpu_torch.parallel.mesh import axis_index, axis_size

_NEG_INF = float("-inf")


def _block_attn(q, k, v, q_idx, kv_idx, chunk, causal, scale):
    """One q-chunk x kv-chunk block: (out_unnorm, row_max, row_sum),
    out [B, Lq, H, D] and the row statistics [B, H, Lq] in float32.

    q: [B, Lq, H, D], k/v: [B, Lk, H, D]; ``q_idx`` and ``kv_idx`` are
    the chunks' global indices (Python ints or 0-d tensors)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        q_pos = q_idx * chunk + torch.arange(
            lq, device=logits.device)[:, None]
        k_pos = kv_idx * chunk + torch.arange(
            lk, device=logits.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, _NEG_INF)
    m = logits.amax(dim=-1)                                  # [B, H, Lq]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, 0.0)
    l = p.sum(dim=-1)                                        # [B, H, Lq]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, *,
                   mesh) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``mesh``'s axis
    ``axis_name``: q, k, v are this rank's chunks [B, L_local, H, D] of a
    global sequence that is the concatenation of the ranks' chunks in
    axis order.  Returns this rank's chunk of the output, in q's dtype."""
    n = axis_size(mesh, axis_name)
    my_idx = axis_index(mesh, axis_name)
    chunk = q.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, L, H = q.shape[:3]
    acc = q.new_zeros((B, L, H, v.shape[-1]), dtype=torch.float32)
    run_max = torch.full((B, H, L), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    run_sum = torch.zeros_like(run_max)
    kk, vv = k, v
    for s in range(n):
        kv_idx = (my_idx - s) % n
        o, m, l = _block_attn(q, kk, vv, my_idx, kv_idx, chunk, causal,
                              scale)
        new_max = torch.maximum(run_max, m)
        # Correction factors; guard fully-masked (-inf) rows.
        corr_old = torch.exp(torch.where(torch.isfinite(run_max),
                                         run_max - new_max, _NEG_INF))
        corr_new = torch.exp(torch.where(torch.isfinite(m), m - new_max,
                                         _NEG_INF))
        finite = torch.isfinite(new_max)
        corr_old = torch.where(finite, corr_old, 0.0)
        corr_new = torch.where(finite, corr_new, 0.0)
        run_sum = run_sum * corr_old + l * corr_new
        # acc: [B, Lq, H, D]; corr: [B, H, Lq] -> [B, Lq, H, 1]
        acc = acc * corr_old.transpose(1, 2)[..., None] + \
            o * corr_new.transpose(1, 2)[..., None]
        run_max = new_max
        if s + 1 < n:
            kk, vv = ppermute_next(mesh, axis_name, kk, vv)
    denom = torch.clamp(run_sum, min=1e-20).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Single-device reference attention ([B, L, H, D])."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # preferred_element_type=float32: products of the inputs are exact in
    # float32, so the dot runs on float32 copies.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        li, lj = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(li, lj, dtype=torch.bool,
                          device=logits.device).tril()
        logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
