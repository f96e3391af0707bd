"""Sums over a process group, for code below the parallel layer.

A loss that takes a ``group`` (``losses.py``, every model's ``loss``)
holds one rank's slice of a batch whose rows are split over the group's
ranks in rank order. It returns the global batch's value on every rank,
and its backward is the rank's share of the global gradient, so that the
group's sum of the ranks' gradients is the global one. These helpers give
it that:

  * ``all_reduce``: a reduced copy over the group, no gradient;
  * ``reduce_sum``: the group's sum, differentiable, whose backward is the
    identity: every rank goes on with the same value and keeps the
    gradient of its own addend (``x`` itself with no group);
  * ``graph_share``: a term that every rank computes whole (it reads no
    batch row: a loss over all nodes, an L2 over whole tables), unchanged
    in value, its backward scaled by 1 / the group's size;
  * ``group_rows``: the global row count of equal slices;
  * ``rank_slice``: this rank's entries of a draw made for the global batch;
  * ``global_batch``: the global batch a rank's batch is a slice of, and
    the rank's first row in it (a term whose partners run over the whole
    batch takes its keys from there).

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


def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of ``x``, differentiable: the backward passes the
    gradient to this rank's addend unchanged. ``x`` itself with no group."""
    return x if group is None else _ReduceSum.apply(x, group)


class _GraphShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


def graph_share(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, a term that every rank of the group computes whole and alike,
    whose backward is this rank's share: the gradient over the group's
    size, so the group's sum of the shares is the term's gradient. ``x``
    itself with no group."""
    if group is None:
        return x
    return _GraphShare.apply(x, dist.get_world_size(group))


def group_rows(n: int, group=None) -> int:
    """The global row count of a batch of ``n`` rows a rank (equal slices)."""
    return n if group is None else n * dist.get_world_size(group)


def rank_offset(n: int, group=None) -> int:
    """This rank's first row in the global batch of slices of ``n`` rows
    (0 with no group)."""
    return 0 if group is None else dist.get_rank(group) * n


def rank_slice(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """This rank's ``n`` entries along the last dimension of ``x``, drawn
    for the global batch (all of ``x`` with no group)."""
    if group is None:
        return x
    lo = rank_offset(n, group)
    return x[..., lo:lo + n].contiguous()


def global_batch(batch):
    """(the global batch, this rank's first row in it) of a batch that
    carries its data group (``sampling.PairwiseBatch``): its ``whole`` and
    the rank's offset, or the batch itself and 0 with no group."""
    if batch.group is None:
        return batch, 0
    return batch.whole, rank_offset(batch.users.shape[0], batch.group)
