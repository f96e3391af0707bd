"""Collectives over a mesh axis (counterpart of
``recommendation_tpu/parallel/collectives.py``).

  * ``sharded_topk``: top-k over a row-sharded item table: each model rank
    scores its rows (``torch.matmul``) and takes a local ``torch.topk``,
    the (score, global id) candidates are all-gathered over the model group
    and merged with one final top-k: O(B·k·S) across ranks, never O(B·N);
  * ``sharded_batch_softmax_denominator``: log Σ_j exp(u·v_j/τ) with the
    items sharded: an all-reduce MAX, then an all-reduce SUM of the sums
    rescaled to the global max;
  * ``sharded_uniformity``: DirectAU's uniformity over all pairs with the
    rows sharded: each rank sums its block-row of exp(−t·d²) against the
    all-gathered rows (pairs i < j by global index), then an all-reduce SUM.

These three give values (no gradient), as the JAX package's tests use them.
The trainer's all-gathers carry autograd: ``gather_rows``, whose
backward keeps the rank's own rows of the gradient (the ranks that
gathered computed the same thing, so nothing is summed), and
``gather_row_blocks``, edge-parallel propagation's gather of each data
rank's row range, whose backward sums the ranks' shares of the gradient
(each rank's loss reads every rank's rows) and keeps the rank's own
range. The all-reduces
(``all_reduce``, and ``reduce_sum`` with the identity as its backward,
which the losses read) are in ``ops/group.py``.

Only an all-gather into one tensor and ``all_reduce`` (SUM, MAX) are
used, so gloo and NCCL run one code path; each is synchronous, so a kernel that reads its
output finds it written. Under NCCL each is captured as it is in a CUDA
graph (the sharded trainer's epoch, the mesh service's wave): NCCL's
stream joins the capture through the events that its process group
records against the current stream, and nothing here reads a value on
the host. gloo's run on the host and are never captured
(``captures`` tells them apart).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from recommendation_tpu_torch.ops.group import all_reduce
from recommendation_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_rank, axis_size


def group_backend(*groups) -> str:
    """The backend that ``groups`` share ('nccl' or 'gloo')."""
    names = {str(dist.get_backend(g)) for g in groups}
    if len(names) != 1:
        raise ValueError(f"the groups run on several backends: {sorted(names)}")
    return names.pop()


def captures(*groups) -> bool:
    """Whether a CUDA graph can hold the collectives of ``groups``: NCCL's
    (on the cards NCCL needs) can; gloo's run on the host and cannot."""
    return group_backend(*groups) == "nccl"


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank. No gradient. The ranks' rows land in one output
    (along ``dim`` 0 it is the result; another ``dim`` takes one copy), not
    in a list of parts then concatenated: two copies of the gathered table
    fewer."""
    with torch.no_grad():
        x = x.contiguous()
        size = dist.get_world_size(group)
        out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        if dim == 0 or size == 1:
            return out
        return torch.cat(out.split(x.shape[0]), dim=dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.lo = dist.get_rank(group) * x.shape[0]
        ctx.rows = x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.rows].contiguous(), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The full table from every rank's row shard (equal shards, rank
    order), differentiable: the gradient of the full table comes back as
    its rows of this rank, not summed over the group."""
    return _GatherRows.apply(x, group)


class _GatherRowBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ranges, part, group):
        lo, hi = ranges[part]
        ctx.args = (lo, hi, group)
        width = max(b - a for a, b in ranges)
        if y.shape[0] < width:  # equal blocks for the all-gather, trimmed after it
            y = torch.cat([y, y.new_zeros((width - y.shape[0],) + tuple(y.shape[1:]))])
        blocks = all_gather_cat(y, group).split(width)
        return torch.cat([blk[:b - a] for blk, (a, b) in zip(blocks, ranges)])

    @staticmethod
    def backward(ctx, grad):
        lo, hi, group = ctx.args
        return all_reduce(grad, group)[lo:hi].contiguous(), None, None, None


def gather_row_blocks(y: torch.Tensor, ranges, part: int, group) -> torch.Tensor:
    """The whole table from each rank's block of rows: ``y`` holds rows
    ``ranges[part]`` (``part`` is this rank's index in ``group``), every
    rank's block is padded to the widest for one all-gather and trimmed
    after it. Differentiable: the gradient of the whole table is this
    rank's share of the global gradient (``ops/group.py``), so the
    backward sums the group's shares (an all-reduce) and keeps the rank's
    own rows."""
    return _GatherRowBlocks.apply(y, tuple(ranges), part, group)


def sharded_topk(user_emb: torch.Tensor, local_items: torch.Tensor, k: int, mesh):
    """Top-k over a row-sharded item table.

    ``user_emb`` f32 [B, d], the same on every model rank; ``local_items``
    f32 [rows, d], this model rank's rows of the padded table (equal
    shards). Returns (scores f32 [B, k], global ids int64 [B, k]), the same
    on every rank. A shard contributes at most its own rows; the merge
    recovers the global top-k while k ≤ Σ local_k."""
    group = axis_group(mesh, MODEL_AXIS)
    n_shards = axis_size(mesh, MODEL_AXIS)
    rows = local_items.shape[0]
    local_k = min(k, rows)
    k = min(k, rows * n_shards)
    with torch.no_grad():
        scores = user_emb @ local_items.T
        s, i = torch.topk(scores, local_k, dim=1)
        gids = i + axis_rank(mesh, MODEL_AXIS) * rows
        all_s = all_gather_cat(s, group, dim=1)  # [B, S·local_k]
        all_i = all_gather_cat(gids, group, dim=1)
        ms, mi = torch.topk(all_s, k, dim=1)
        return ms, torch.gather(all_i, 1, mi)


def sharded_batch_softmax_denominator(user_emb: torch.Tensor, local_items: torch.Tensor,
                                      temperature: float, mesh) -> torch.Tensor:
    """log Σ_j exp(u·v_j/τ) over a row-sharded item table: f32 [B], the
    same on every rank. Stable: the rank's maxima, their global max, then
    the sums rescaled to it."""
    group = axis_group(mesh, MODEL_AXIS)
    with torch.no_grad():
        scores = (user_emb @ local_items.T) / temperature
        global_max = all_reduce(torch.max(scores, dim=1).values, group, dist.ReduceOp.MAX)
        local_sum = torch.sum(torch.exp(scores - global_max[:, None]), dim=1)
        return global_max + torch.log(all_reduce(local_sum, group))


def sharded_uniformity(x_local: torch.Tensor, mesh, t: float = 2.0) -> torch.Tensor:
    """DirectAU's uniformity log-mean-exp over all pairs of a row-sharded
    ``x`` (``x_local``: this model rank's rows, equal shards): the dense
    value, pair bookkeeping included (i < j by global row, no self)."""
    group = axis_group(mesh, MODEL_AXIS)
    with torch.no_grad():
        rows = x_local.shape[0]
        full = all_gather_cat(x_local, group)
        xn_l = x_local / torch.clamp(torch.linalg.norm(x_local, dim=1, keepdim=True), min=1e-12)
        xn_f = full / torch.clamp(torch.linalg.norm(full, dim=1, keepdim=True), min=1e-12)
        d2 = (torch.sum(xn_l * xn_l, dim=1)[:, None] + torch.sum(xn_f * xn_f, dim=1)[None, :]
              - 2.0 * (xn_l @ xn_f.T))
        d2 = torch.clamp(d2, min=0.0)
        gidx = axis_rank(mesh, MODEL_AXIS) * rows + torch.arange(rows, device=x_local.device)
        mask = gidx[:, None] < torch.arange(full.shape[0], device=x_local.device)[None, :]
        local_sum = torch.sum(torch.where(mask, torch.exp(-t * d2), torch.zeros_like(d2)))
        total = all_reduce(local_sum, group)
        n = full.shape[0]
        n_pairs = n * (n - 1) // 2
        return torch.log(total / max(n_pairs, 1) + 1e-8)
