"""Megatron's two tensor-parallel collectives, with their gradients, and
the gathers the sharded paths use.

A column-parallel layer computes this rank's output columns from the
whole input; a row-parallel one the partial sum of this rank's input
columns. Between them each rank holds its own heads or FF columns and
nothing is exchanged. Two collectives close the block (Shoeybi et al.,
2019):

- ``copy_to`` (Megatron's *f*), on the input of a column-parallel layer:
  identity forward, all-reduce of the gradient backward, so that a
  replicated leaf before the block gets the whole gradient on every rank;
- ``reduce_from`` (*g*), after a row-parallel product: all-reduce
  forward, identity backward.

``torch.distributed.all_reduce`` has no gradient, so both are autograd
Functions. Outside autograd (inference) *f* is nothing and *g* reduces in
place. With a group of one rank both are the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) ``x`` over ``group``, in place; returns x."""
    if _size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: x as it is; its gradient summed over ``group``."""
    if _size(group) == 1 or not _tracked(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: x summed over ``group``; its gradient passed through."""
    if _size(group) == 1:
        return x
    if not _tracked(x):
        return all_reduce(x.contiguous(), group)
    return _ReduceFrom.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0, halves: bool = False) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order of ``group``; with ``halves``, slices that ``rank_slice`` took
    from each half ([a_0 | b_0], [a_1 | b_1] ...) joined as [a | b]. No
    gradient."""
    n = _size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    if halves:
        pieces = [p.chunk(2, dim=dim) for p in parts]
        parts = [p[0] for p in pieces] + [p[1] for p in pieces]
    return torch.cat(parts, dim=dim)


def rank_slice(x: torch.Tensor, dim: int, rank: int, parts: int,
               halves: bool = False) -> torch.Tensor:
    """Rank ``rank``'s slice of ``parts`` along ``dim``: a contiguous
    1/parts, or with ``halves`` the matching 1/parts of each half."""
    if parts == 1:
        return x
    if halves:
        a, b = x.chunk(2, dim=dim)
        return torch.cat([rank_slice(a, dim, rank, parts), rank_slice(b, dim, rank, parts)],
                         dim=dim)
    n = x.shape[dim] // parts
    return x.narrow(dim, rank * n, n)


def mean_over(x: torch.Tensor, group, size: Optional[int] = None) -> torch.Tensor:
    """The mean of x over ``group``, in place."""
    n = size or _size(group)
    if n > 1:
        all_reduce(x, group).div_(n)
    return x
