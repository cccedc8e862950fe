"""The collectives of the sharded step, as differentiable functions.

:func:`all_reduce_sum`'s backward all-reduces the cotangent (each rank
backpropagates its own share of a sum), :func:`all_to_all`'s is the reverse
all-to-all, and :func:`reduce_` sums in place outside autograd. A group of
``None`` (an axis of one rank) makes each the identity. They sit below both
``ops/`` (the grouped BatchNorm moments of ``ops/norm.py``) and
``parallel/`` (the mesh and the sharded step), so neither layer names the
other for them. The timeouts are the process groups' own
(``parallel/mesh.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal chunks of ``x``'s rows: chunk ``q`` to the group's rank ``q``,
    and the chunk from rank ``q`` at position ``q``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``x`` itself when the group is
    ``None``). Differentiable: the backward all-reduces the cotangent, the
    gradient of every rank's input when each rank backpropagates its own
    share of the result (``parallel/sharded.py``)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s rows in as many equal chunks as ``group`` has ranks, chunk
    ``q`` sent to rank ``q``; returns the received chunks in rank order.
    Differentiable: the backward is the reverse all-to-all."""
    return x if group is None else _AllToAll.apply(x, group)


def reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``, outside autograd (``None``: no-op)."""
    return t if group is None else _all_reduce_(t, group)
