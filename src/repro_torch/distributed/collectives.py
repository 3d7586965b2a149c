"""Sums across the ranks of a process group, plain and differentiable.

`all_reduce_` is the one place the port reduces tensors across ranks.  On
a gloo group it reduces CUDA tensors too: gloo stages them through host
memory, which is how the one-card mesh (several ranks on one H100) runs;
NCCL reduces them on the cards.

The differentiable forms are Megatron's conjugate pair and their product,
for values that every rank of the group computes alike downstream:

  * `reduce_from(x)`: the sum over the group forward, the identity
    backward (the partial outputs of the row-sharded gather: each rank's
    partial gets the whole upstream gradient);
  * `copy_to(x)`: the identity forward, the sum backward (an input every
    rank holds alike whose gradient each rank has in part: the query's
    weights in the plain sharded cell);
  * `sum_both(x)`: the sum forward and backward (the batch statistics of a
    data-parallel batchnorm: every rank's loss is its part of the global
    loss, so the statistics' gradient is the sum of the parts).

A group of None or of one rank makes each of them the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place; returns it."""
    if not _trivial(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_flat_(tensors: list[torch.Tensor], group) -> None:
    """Sum every tensor of `tensors` (one dtype, one device) over `group`
    with one all-reduce of their concatenation, in place."""
    if _trivial(group) or not tensors:
        return
    if len(tensors) == 1:
        all_reduce_(tensors[0], group)
        return
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _CopyTo.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _SumBoth.apply(x, group)
