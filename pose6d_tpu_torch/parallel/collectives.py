"""The collectives of data and head (Megatron) parallelism, with their
gradients, over torch.distributed process groups.

Each rank runs one process. A `Group` is a set of ranks (the data or the
model group of parallel/mesh.py) with this rank's index in it. Only
all_reduce and all_gather are used: gloo (the CPU, and several ranks
sharing one card) and NCCL both take them.

The autograd functions, and the backward of each:

  copy_to_group    forward identity; backward all-reduce (sum). At the
                   input of a column-parallel layer, whose input is the same
                   on every rank of the model group: each rank's backward
                   sees only its own columns' part of the input gradient.
  reduce_from_group forward all-reduce (sum); backward identity. At a
                   row-parallel output: the gradient arriving there is
                   already the same on every rank of the group (an
                   all-reduce here would multiply it by the group's size,
                   as torch.distributed.nn.functional.all_reduce would).
  reduce_sum       forward all-reduce (sum); backward all-reduce (sum).
                   Partial statistics (BatchNorm's over the data group,
                   LayerNorm's over the model group): each rank applies the
                   reduced statistic to its own rows or features, so the
                   statistic's gradient is the sum of every rank's part.
  gather_rows      forward all-gather along dim 0; backward this rank's
                   rows of the gradient. For outputs and metrics that every
                   rank of the group then consumes alike.

On a group of one rank every function is the identity (the collective
still runs: a world of one over NCCL goes through NCCL). A Group's pg is
None for the default group (the whole world).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """Ranks `ranks` of the default group as one process group `pg`, and
    this process's index `index` among them."""

    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


def all_reduce_(x: torch.Tensor, group: Group, op=None) -> torch.Tensor:
    """In-place all-reduce (sum unless `op`); returns x."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=group.pg)
    return x


def all_gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in group order, moved as
    bytes so that any dtype (bool, bfloat16) goes through any backend."""
    x = x.contiguous()
    raw = x.reshape(-1).view(torch.uint8)
    parts: List[torch.Tensor] = [torch.empty_like(raw) for _ in range(group.size)]
    dist.all_gather(parts, raw, group=group.pg)
    shape = x.shape if x.ndim else (1,)
    return torch.cat([p.view(x.dtype).view(shape) for p in parts], 0)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = (group.index * x.shape[0], x.shape[0])
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, *ctx.rows), None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _ReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _GatherRows.apply(x, group)
