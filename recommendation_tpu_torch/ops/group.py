"""Sums over a process group, for code below the parallel layer.

A loss that takes a ``group`` (LightGCN's, ``losses.py``) holds one rank's
slice of a batch whose rows are split over the group's ranks in rank
order. These helpers give it the global batch's value:

  * ``all_reduce``: a reduced copy over the group, no gradient;
  * ``reduce_sum``: the group's sum, differentiable, whose backward is the
    identity: every rank goes on with the same value and keeps the
    gradient of its own addend;
  * ``group_rows``: the global row count of equal slices;
  * ``rank_slice``: this rank's entries of a draw made for the global batch.

``parallel/`` builds on them; nothing here reads a mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over the group, on every rank. No gradient."""
    with torch.no_grad():
        out = x.detach().clone()
        dist.all_reduce(out, op=op, group=group)
        return out


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, differentiable: the backward passes the
    gradient to this rank's addend unchanged."""
    return _ReduceSum.apply(x, group)


def group_rows(n: int, group=None) -> int:
    """The global row count of a batch of ``n`` rows a rank (equal slices)."""
    return n if group is None else n * dist.get_world_size(group)


def rank_slice(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """This rank's ``n`` entries along the last dimension of ``x``, drawn
    for the global batch (all of ``x`` with no group)."""
    if group is None:
        return x
    lo = dist.get_rank(group) * n
    return x[..., lo:lo + n].contiguous()
