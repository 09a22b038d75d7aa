"""Collectives over one mesh axis (or several), with their gradients.

The JAX package writes no collective in its model code: GSPMD inserts
them from the shardings, and ``shard_map`` bodies call ``psum`` and
``ppermute``, whose transposes JAX derives.  The port issues them itself
and gives each its backward as an ``autograd.Function``, in Megatron's
convention: a tensor that every rank of an axis holds whole (replicated)
carries, on each rank, the gradient of the whole loss, so

  * :func:`copy_to` (Megatron's f): identity forward, all-reduce
    backward, where a replicated tensor enters per-rank partial work;
  * :func:`reduce_from` (Megatron's g): all-reduce forward, identity
    backward, where partial results become a replicated tensor (not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces again and multiplies replicated gradients by the axis
    size);
  * :func:`gather`: all-gather along a dimension; the backward keeps the
    rank's own slice (the gathered tensor feeds replicated work) or,
    with ``sum_grad``, first sums the gradient over the axis (it feeds
    per-rank work);
  * :func:`ppermute_next`: tensors to the next rank of the axis, ring
    order, in one batch of point-to-point operations; the backward sends
    the gradients back to the previous rank.

A collective over an axis that spans one rank is not issued: each
function returns its input (``parallel.mesh.axis_group`` is ``None``).
Every rank must reach the same collectives in the same order, so the
callers select by rank with tensor operations, never with a Python
branch on the rank.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Axes, axis_group


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size())]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sum_grad):
        ctx.dim, ctx.group, ctx.sum_grad = dim, group, sum_grad
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            grad = _all_reduce(grad, ctx.group)
        part = grad.chunk(ctx.group.size(), ctx.dim)[ctx.group.rank()]
        return part.contiguous(), None, None, None


def _shift(tensors: List[torch.Tensor], group, step: int) -> List[torch.Tensor]:
    """Each tensor to the rank ``step`` places on along the ring of
    ``group``; the tensors of the rank ``step`` places back returned."""
    n, i = group.size(), group.rank()
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends] +
           [dist.P2POp(dist.irecv, t, src, group) for t in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


class _PermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(_shift(list(xs), group, 1))

    @staticmethod
    def backward(ctx, *grads):
        # An output nobody used still takes part: its neighbour waits
        # for it.
        grads = [g if g is not None else torch.zeros(s, dtype=d, device=v)
                 for g, (s, d, v) in zip(grads, ctx.meta)]
        return (None, *_shift(grads, ctx.group, -1))


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Identity forward, gradient summed over ``axes`` (Megatron's f)."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` forward, gradient passed through (Megatron's g)."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, dim: int, mesh, axes: Axes,
           sum_grad: bool = False) -> torch.Tensor:
    """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in
    coordinate order; the gradient is this rank's slice (summed over the
    axes first with ``sum_grad``)."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return x if group is None else _Gather.apply(x, dim, group, sum_grad)


def ppermute_next(mesh, axes: Axes, *xs: torch.Tensor) -> Tuple:
    """``xs`` moved one rank on along the ring of ``axes`` (JAX's
    ``ppermute`` with ``[(i, (i + 1) % n)]``), in one batch of sends and
    receives; the gradients go back one rank."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return xs if group is None else _PermuteNext.apply(group, *xs)


def all_reduce(t: torch.Tensor, mesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axes``, outside autograd."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return t if group is None else _all_reduce(t.detach(), group, op)


def all_gather(t: torch.Tensor, dim: int, mesh, axes: Axes) -> torch.Tensor:
    """The ranks' ``t`` along ``axes`` concatenated on ``dim``, outside
    autograd."""
    group = axis_group(mesh, axes) if mesh is not None else None
    return t if group is None else _all_gather(t.detach(), dim, group)
