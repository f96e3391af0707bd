"""Sparse propagation ``adj @ x`` and the segment reductions (counterpart
of ``recommendation_tpu/ops/spmm.py``).

``adj_matmul`` has three branches. The bucketed one, ``bucketed_matmul``,
gather-only in both passes (kernels P1 and K7, ``graph/bucketed.py``). The
dense one, a product with the materialized (U+I)² matrix, which the JAX
package leaves to XLA and the port to ``torch.matmul``: in the bf16 regime
both operands are rounded to bf16 and the products are summed in f32, as
the JAX package's ``preferred_element_type=f32`` does. The segment one,
``_segment_matmul``: P1 over the adjacency's row-sorted view
(``ops/segment.py``) forward and over its transpose view backward, where
the JAX package gathers the [E, d] messages and ``segment_sum``s them. The
``pallas`` backend runs the segment branch, with one logged warning a
process, as the JAX package's ``ops/pallas_spmm.py`` does.

``segment_softmax`` and ``segment_mean`` take the JAX signatures
(per-edge values, a segment id per edge in any order): a stable sort per
call, then S2 or P1 over the sorted slots. The models use their cached
views instead.
"""

from __future__ import annotations

import logging

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_matmul
from recommendation_tpu_torch.graph.device import DeviceAdj
from recommendation_tpu_torch.ops.gather import gather_sum
from recommendation_tpu_torch.ops.segment import SegmentSoftmax, segment_csr, segment_pull

_warned = False


def adj_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` (f32 [n_rows, d]) with the adjacency's backend; x is
    [n_cols, d]. The bucketed and segment backwards pull through the
    transpose; the dense one is autograd's."""
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


def _segment_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` over the row-sorted views: P1 with the values in slot
    order, ``Aᵀ g`` through the transpose view as the backward. The edge
    values take no gradient (as on the bucketed backend; ``segment_pull``
    raises if they require one)."""
    seg, seg_t = adj.segment_views()
    return segment_pull(x, seg, seg_t, val=adj.vals[seg.perm], val_t=adj.vals[seg_t.perm])


def segment_matmul_plain(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` in plain torch over the COO (the [E, d] messages added
    into their rows), on any device; autograd differentiates it."""
    msgs = x.float()[adj.cols.long()] * adj.vals[:, None]
    return torch.zeros((adj.n_rows, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add(0, adj.rows.long(), msgs)


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
    """P1 over the sorted slots (``idx`` the COO position of each slot,
    ``post`` 1/max(count, 1)); the backward gathers ``post · g`` back to
    each edge by its segment."""

    @staticmethod
    def forward(ctx, values, view, segments, post):
        ctx.args = (segments, post)
        return gather_sum(values.float().contiguous(), view.perm.to(torch.int32), view.row_ptr,
                          post=post, schedule=view.schedule)

    @staticmethod
    def backward(ctx, g):
        segments, post = ctx.args
        return (g * post[:, None])[segments.long()], None, None, None


def segment_mean(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment mean of the rows of ``values`` [E, d] (the JAX package's
    ``segment_mean``: the sums over the counts, at least 1). A stable sort
    of ``segments``, then P1 over the sorted slots."""
    view = segment_csr(segments, segments, num_segments, num_segments)
    counts = torch.diff(view.row_ptr).float()
    return _SortedMean.apply(values, view, segments, 1.0 / torch.clamp(counts, min=1.0))
