"""The port's collectives, in one place (the JAX package lets XLA insert
them from its shardings).

Tensor parallelism splits a trunk's column-parallel products (q/k/v,
gate/up) and row-parallel ones (o, down) over the ranks of a tp group, as
Megatron-LM does; three functions carry activations across the split, each a
``torch.autograd.Function`` so that the SFT step's backward is right under
tp:

* ``copy_to_tp``: identity forward, all-reduce of the gradient backward
  (before a column-parallel product, and on a whole weight that each rank
  applies to its own heads);
* ``reduce_from_tp``: all-reduce forward, identity backward (after a
  row-parallel product);
* ``gather_last_dim``: every rank's slice of the last axis concatenated
  forward, the rank's slice of the gradient backward (vocab-split heads).

Every function is the same on NCCL and on gloo. A gather is written as an
all-reduce of a zero-filled full tensor, each rank's slice in its place,
which is exact (x + 0 = x): gloo takes an all-reduce of CUDA tensors but
lists no all-gather for them, and the port never copies to the host to get
round it. Each all-reduce adds one to ``all_reduce.calls``.

A CUDA graph can capture NCCL collectives, not gloo's, which run through the
host: ``capturable`` says which groups a captured program may hold.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks, in place; returns ``x``."""
    all_reduce.calls += 1
    dist.all_reduce(x, group=group)
    return x


all_reduce.calls = 0


def group_size(group) -> int:
    """The ranks of ``group`` (1 for None); a group need not be registered
    with a default group (``ProcessGroupGloo(store, rank, size)``)."""
    return 1 if group is None else group.size()


def group_rank(group) -> int:
    return 0 if group is None else group.rank()


def capturable(groups: Iterable) -> bool:
    """Whether a CUDA graph may capture collectives over ``groups`` (None
    entries are no group): NCCL's, not gloo's."""
    return all(g is None or g.name() == "nccl" for g in groups)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (equal
    shapes on every rank): an all-reduce of a zero-filled full tensor."""
    n = group_size(group)
    if group is None:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * n
    full = x.new_zeros(shape)
    full.narrow(dim, group_rank(group) * width, width).copy_(x)
    return all_reduce(full, group)


def _local(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's slice of ``x`` along ``dim`` (the inverse of ``gather``)."""
    width = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * width, width).contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather(x.contiguous(), group, -1)

    @staticmethod
    def backward(ctx, grad):
        return _local(grad, ctx.group, -1), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group`` backward."""
    if group is None or not _differentiable(x):
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum over ``group`` forward (in place when no gradient is taken,
    as at inference); the gradient as it is backward. With a group it
    reduces whatever the group's size."""
    if group is None:
        return x
    if _differentiable(x):
        return _ReduceFromTP.apply(x, group)
    return all_reduce(x, group)


def gather_last_dim(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Every rank's slice of the last axis concatenated forward; the rank's
    slice of the gradient backward."""
    if group is None:
        return x
    if _differentiable(x):
        return _GatherLastDim.apply(x, group)
    return gather(x.contiguous(), group, -1)
