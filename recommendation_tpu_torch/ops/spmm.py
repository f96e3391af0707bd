"""Sparse propagation ``adj @ x`` and the segment reductions (counterpart
of ``recommendation_tpu/ops/spmm.py``).

``adj_matmul`` has three branches. The bucketed one, ``bucketed_matmul``,
gather-only in both passes (kernels P1 and K7, ``graph/bucketed.py``). The
dense one, a product with the materialized (U+I)² matrix, which the JAX
package leaves to XLA and the port to ``torch.matmul``: in the bf16 regime
both operands are rounded to bf16 and the products are summed in f32, as
the JAX package's ``preferred_element_type=f32`` does. The segment one,
``_segment_matmul``: P2 over the adjacency's row-sorted view
(``ops/segment.py``) forward and over its transpose view backward, where
the JAX package gathers the [E, d] messages and ``segment_sum``s them. The
``pallas`` backend runs the segment branch, with one logged warning a
process, as the JAX package's ``ops/pallas_spmm.py`` does.

A segment adjacency with an edge shard (``DeviceAdj.shard``, placed by a
sharded trainer where the JAX package shards the COO over its data axis,
``recommendation_tpu/parallel/trainer.py:93-97``) is edge-parallel: each
data rank runs P2 over its row range of the row-sorted view and the rows
are all-gathered over the data group (``parallel.collectives.
gather_row_blocks``); the backward sums the group's gradient shares, keeps
the rank's rows and pulls them through the transpose view's slots of those
rows, which gives the rank's share of ``Aᵀ g``. Each row sums its slots in
the order the whole view's P2 sums them, so the forward is the replicated
one bit for bit on the card. Every rank of the group must make each such
call. ``edge_parallel_matmul.calls`` counts them.

``plain_products()`` makes every ``adj_matmul`` the plain COO product
(``segment_matmul_plain``) while it is open, on any backend and in f32 or
float64: the reference a step on the card is held against.

``segment_softmax`` and ``segment_mean`` take the JAX signatures
(per-edge values, a segment id per edge in any order): a stable sort per
call, then S2 or P2 over the sorted slots. The models use their cached
views instead.
"""

from __future__ import annotations

import contextlib
import logging

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_matmul
from recommendation_tpu_torch.graph.device import DeviceAdj
from recommendation_tpu_torch.ops.segment import (
    SegmentSoftmax,
    segment_csr,
    segment_pull,
    segment_sum,
)
from recommendation_tpu_torch.parallel.collectives import gather_row_blocks

_warned = False
_plain = False  # set by plain_products()


def adj_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` (f32 [n_rows, d]) with the adjacency's backend; x is
    [n_cols, d]. The bucketed and segment backwards pull through the
    transpose; the dense one is autograd's."""
    if _plain:
        return segment_matmul_plain(adj, x)
    if adj.backend == "bucketed" and adj.pull is not None:
        return bucketed_matmul(adj.pull, adj.pull_t, x, adj.compute_dtype)
    if adj.backend == "dense":
        if adj.compute_dtype == "bfloat16":
            # bf16 operands (the matrix rounded once, kept), exact products, f32 sums
            return torch.matmul(adj.dense_operand, x.to(torch.bfloat16).float())
        return torch.matmul(adj.dense, x.float())
    if adj.backend == "pallas":
        global _warned
        if not _warned:
            _warned = True
            logging.getLogger("recommendation_tpu_torch").warning(
                "graph.backend='pallas': the JAX package has no hand-tiled SpMM kernel for it "
                "(its ops/pallas_spmm.py) — running the segment backend instead")
    if adj.backend in ("segment", "pallas"):
        return _segment_matmul(adj, x)
    raise ValueError(f"adj_matmul: unknown backend {adj.backend!r}")


def edge_parallel_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` over an edge-sharded segment adjacency: P2 over the
    rank's row range (``shard.fwd``, the values in its slot order), the
    transpose view of those rows (``shard.bwd``) as the backward's, and the
    rows gathered over the data group."""
    sh = adj.shard
    edge_parallel_matmul.calls += 1
    y = segment_pull(x, sh.fwd, sh.bwd, val=adj.vals[sh.fwd.perm], val_t=adj.vals[sh.bwd.perm])
    return gather_row_blocks(y, sh.ranges, sh.part, sh.group)


edge_parallel_matmul.calls = 0


def _segment_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` over the row-sorted views: P2 with the values in slot
    order, ``Aᵀ g`` through the transpose view as the backward. The edge
    values take no gradient (as on the bucketed backend; ``segment_pull``
    raises if they require one). With an edge shard, edge-parallel."""
    if adj.shard is not None:
        return edge_parallel_matmul(adj, x)
    seg, seg_t = adj.segment_views()
    return segment_pull(x, seg, seg_t, val=adj.vals[seg.perm], val_t=adj.vals[seg_t.perm])


def segment_matmul_plain(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` in plain torch over the COO (the [E, d] messages added
    into their rows), on any device, in f32 (float64 for a float64 ``x``);
    autograd differentiates it."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    msgs = x.to(dtype)[adj.cols.long()] * adj.vals.to(dtype)[:, None]
    return torch.zeros((adj.n_rows, x.shape[1]), dtype=dtype,
                       device=x.device).index_add(0, adj.rows.long(), msgs)


@contextlib.contextmanager
def plain_products():
    """Every ``adj_matmul`` the plain COO product ``segment_matmul_plain``
    while open, on any backend, under autograd (whose backward scatters
    where the kernels pull through the transpose), in float64 for float64
    inputs: the reference of the tests and ``chip_smoke.py``. A model's
    step inside it launches no kernel of the port's sparse products."""
    global _plain
    saved, _plain = _plain, True
    try:
        yield
    finally:
        _plain = saved


def segment_softmax(scores: torch.Tensor, segments: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """The softmax of per-edge ``scores`` ([E] or [E, H]) over each segment
    (the JAX package's ``segment_softmax``): the max taken out, 0 where a
    segment's max is not finite, exp, divided by the sum + 1e-16. A stable
    sort of ``segments``, then S2 over the sorted slots."""
    view = segment_csr(segments, segments, num_segments, num_segments)
    flat = scores.dim() == 1
    e = (scores[:, None] if flat else scores).float()[view.perm]
    att = SegmentSoftmax.apply(e, view.row_ptr, None)
    inv = torch.empty_like(view.perm)
    inv[view.perm] = torch.arange(view.n_slots, device=inv.device)
    out = att[inv]
    return out[:, 0] if flat else out


class _SortedMean(torch.autograd.Function):
    """P2 over the sorted slots (the source row of each slot its COO
    position, ``post`` 1/max(count, 1)); the backward gathers ``post · g``
    back to each edge by its segment."""

    @staticmethod
    def forward(ctx, values, view, segments, post):
        ctx.args = (segments, post)
        return segment_sum(values.float().contiguous(), view, post=post,
                           idx=view.perm.to(torch.int32))

    @staticmethod
    def backward(ctx, g):
        segments, post = ctx.args
        return (g * post[:, None])[segments.long()], None, None, None


def segment_mean(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment mean of the rows of ``values`` [E, d] (the JAX package's
    ``segment_mean``: the sums over the counts, at least 1). A stable sort
    of ``segments``, then P2 over the sorted slots."""
    view = segment_csr(segments, segments, num_segments, num_segments)
    counts = torch.diff(view.row_ptr).float()
    return _SortedMean.apply(values, view, segments, 1.0 / torch.clamp(counts, min=1.0))
