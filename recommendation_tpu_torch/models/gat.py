"""GAT: two-layer multi-head graph attention over the bipartite graph
(counterpart of ``recommendation_tpu/models/gat.py``; `gat.py:14-40`).

Learned id embeddings → dropout → GATConv (``GAT.num_heads`` heads of
``GAT.hidden``, attention dropout ``GAT.edge_dropout``, LeakyReLU slope
``GAT.neg_slope``) → ELU → dropout (``GAT.dropout``) → GATConv (one head of
embedding.size) → users and items; BPR. The logits e_ij =
LeakyReLU(a_srcᵀh_src + a_dstᵀh_dst) are normalized over each
destination's incoming edges.

One attention routine serves every backend, over a static ``Attention``
structure (a forward view whose rows are destinations, its transpose view,
and the map between their slots):

  * the segment path (dense, segment and pallas backends; JAX
    ``gat_layer``): the rows are nodes, the views are the graph's
    ``bipartite_views`` over ``bidirectional_edges`` (``segment_attention``),
    the attention dropout is drawn in the JAX package's [2·E_pad, H] edge
    order and put in slot order;
  * the bucketed path (JAX ``gat_layer_bucketed_sf``): the rows are the
    bucket rows of ``norm_adj.pull`` (each a CSR segment of the flat
    tables), the transpose view ``pull_t`` with the slot maps of
    ``DeviceGraph.ensure_gat_aux`` (``bucketed_attention``); dead slots
    (padding, and the COO's zero-valued padding entries: ``val == 0``) are
    no neighbours; K7 reorders the rows into node order.

``AttentionPull`` is its autograd Function: the logits by gathers, S2 over
the forward view (the masked softmax), S1 for the aggregation, and a
backward in which every reverse flow is a gather or an ordered sum, as the
JAX package's custom VJP (`gat.py:138-211`): ``datt`` by S3 (each slot's
cotangent row dotted with its source row), S2's backward, ``dα_dst`` the
per-row sums (P1 over the forward view), ``dh`` S1 over the transpose view
with the weights gathered by slot, ``dα_src`` P1 over the transpose view.
No atomics: a step repeats bit for bit. ``attention_plain`` computes the
same with the plain versions under autograd (the reference), and
``gat_layer_bucketed`` with ``bucketed_row_nodes`` keeps the JAX package's
per-bucket dense softmax as the oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from recommendation_tpu_torch.graph.augment import device_generator, keep_draw
from recommendation_tpu_torch.losses import bpr_loss, l2_reg_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.gather import gather_rows, gather_sum
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.segment import (
    segment_dot,
    segment_softmax_rows,
    segment_softmax_rows_bwd,
    segment_softmax_rows_plain,
    transpose_map,
    weighted_pull,
    weighted_pull_plain,
)
from recommendation_tpu_torch.weights import flatten_tree


@dataclasses.dataclass
class Attention:
    """The static structure an attention layer pulls over. Forward view:
    ``row_ptr`` i64 [R + 1], ``idx`` i32 [S] (each slot's source node),
    ``dst`` i32 [S] (its destination node), ``live`` bool [S], ``ident``
    i32 [S] (0..S−1) and the pull schedule; ``out_pos`` i32 [N] each node's
    row (None where the rows are the nodes). Transpose view: ``t_row_ptr``,
    ``t_idx`` (each slot's destination node, whose cotangent it pulls),
    ``t2f`` i32 (its forward slot), ``t_live``, ``t_schedule``,
    ``t_out_pos``. ``edge_perm`` i64 [S]: each forward slot's position in
    the order the dropout is drawn in (None: slot order)."""

    row_ptr: torch.Tensor
    idx: torch.Tensor
    dst: torch.Tensor
    live: torch.Tensor
    ident: torch.Tensor
    schedule: Tuple
    out_pos: Optional[torch.Tensor]
    t_row_ptr: torch.Tensor
    t_idx: torch.Tensor
    t2f: torch.Tensor
    t_live: torch.Tensor
    t_schedule: Tuple
    t_out_pos: Optional[torch.Tensor]
    edge_perm: Optional[torch.Tensor]
    n_draw: int  # rows of the dropout draw


def segment_attention(graph) -> Attention:
    """The segment path's structure over ``bidirectional_edges``: the
    destination view of ``bipartite_views`` forward, the source view as
    its transpose; padded edges (mask 0) are dead."""
    by_src, by_dst = graph.bipartite_views()
    mask = torch.cat([graph.edge_valid, graph.edge_valid]) > 0
    live = mask[by_dst.perm]
    return Attention(row_ptr=by_dst.row_ptr, idx=by_dst.idx, dst=by_dst.slot_row, live=live,
                     ident=by_dst.ident, schedule=by_dst.schedule, out_pos=None,
                     t_row_ptr=by_src.row_ptr, t_idx=by_src.idx,
                     t2f=transpose_map(by_dst, by_src).to(torch.int32),
                     t_live=mask[by_src.perm], t_schedule=by_src.schedule, t_out_pos=None,
                     edge_perm=by_dst.perm, n_draw=int(mask.shape[0]))


def _real_slots(csr) -> torch.Tensor:
    """bool [S]: slots holding a real edge, non-padding (edge >= 0) with a
    nonzero COO value (``from_scipy`` pads the COO with zero-valued entries
    that carry valid edge ids)."""
    return (csr.edge >= 0) & (csr.val != 0)


def bucketed_attention(csr, csr_t, aux) -> Attention:
    """The bucketed path's structure: the rows of ``csr`` (A's tables) and
    of ``csr_t`` (Aᵀ's), with ``aux`` the slot maps
    (``DeviceGraph.ensure_gat_aux``)."""
    return Attention(row_ptr=csr.row_ptr, idx=csr.idx, dst=aux["slot_node"],
                     live=_real_slots(csr), ident=torch.arange(csr.n_slots, dtype=torch.int32,
                                                               device=csr.idx.device),
                     schedule=csr.schedule, out_pos=csr.gather_pos, t_row_ptr=csr_t.row_ptr,
                     t_idx=csr_t.idx, t2f=aux["tpos"], t_live=_real_slots(csr_t),
                     t_schedule=csr_t.schedule, t_out_pos=csr_t.gather_pos, edge_perm=None,
                     n_draw=csr.n_slots)


def _logits(a_src, a_dst, st: Attention, neg_slope):
    z = a_src[st.idx.long()] + a_dst[st.dst.long()]
    return z, F.leaky_relu(z, neg_slope)


def _to_nodes(y: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows → nodes by K7 (``pos`` None: already nodes)."""
    if pos is None:
        return y
    return gather_rows(y.reshape(y.shape[0], -1), pos).view((-1,) + tuple(y.shape[1:]))


class AttentionPull(torch.autograd.Function):
    """``out[n] = Σ_s att[s] · keep[s] · h[idx[s]]`` over node n's slots,
    ``att`` the masked softmax of the logits: S2, S1 (and K7 on the
    bucketed path) forward; S3, S2's backward, S1 and P1 (and K7) backward.
    ``keep`` f32 [S, H] carries the dropout scale (None: no dropout); it
    and the structure take no gradient."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, keep, st, neg_slope):
        z, e = _logits(a_src, a_dst, st, neg_slope)
        att = segment_softmax_rows(e.contiguous(), st.row_ptr, st.live)
        w = att if keep is None else att * keep
        y = weighted_pull(h, w, st.idx, st.row_ptr, st.schedule)
        ctx.save_for_backward(h, att, w, z, keep)
        ctx.args = (st, neg_slope)
        return _to_nodes(y, st.out_pos)

    @staticmethod
    def backward(ctx, g):
        h, att, w, z, keep = ctx.saved_tensors
        st, neg_slope = ctx.args
        heads = h.shape[1]
        g = g.contiguous()
        datt = segment_dot(g, st.dst, h, st.idx, heads)
        if keep is not None:
            datt = datt * keep
        de = segment_softmax_rows_bwd(att, datt, st.row_ptr)
        slope = torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, neg_slope))
        dz = torch.where(st.live[:, None], de * slope, torch.zeros_like(de)).contiguous()
        da_dst = _to_nodes(gather_sum(dz, st.ident, st.row_ptr, schedule=st.schedule),
                           st.out_pos)
        wt = torch.where(st.t_live[:, None], w[st.t2f.long()], torch.zeros((), device=w.device))
        dh = _to_nodes(weighted_pull(g, wt.contiguous(), st.t_idx, st.t_row_ptr, st.t_schedule),
                       st.t_out_pos)
        da_src = _to_nodes(gather_sum(dz, st.t2f, st.t_row_ptr, val=st.t_live.float(),
                                      schedule=st.t_schedule), st.t_out_pos)
        return dh, da_src, da_dst, None, None, None


def attention_plain(h, a_src, a_dst, keep, st: Attention, neg_slope):
    """``AttentionPull``'s function in plain torch (S1 and S2's plain
    versions, indexing for K7), differentiated by autograd."""
    _, e = _logits(a_src, a_dst, st, neg_slope)
    att = segment_softmax_rows_plain(e, st.row_ptr, st.live)
    y = weighted_pull_plain(h, att if keep is None else att * keep, st.idx, st.row_ptr)
    return y if st.out_pos is None else y[st.out_pos.long()]


def gat_layer(x, st: Attention, n_nodes, w, a_src, a_dst, heads, neg_slope, generator,
              att_drop, plain=False):
    """Multi-head GAT conv over ``st`` (``segment_attention`` or
    ``bucketed_attention``). x: [N, d_in]; w: [d_in, H·d]; a_*: [H, d].
    Returns [N, H·d] (heads concatenated). With a ``generator`` and
    ``att_drop`` > 0 the attention weights are dropped: one keep draw of
    [n_draw, H] in edge order (the JAX package's), put in slot order.
    ``plain`` runs ``attention_plain``."""
    d = a_src.shape[1]
    h = (x @ w).reshape(-1, heads, d).contiguous()  # [N, H, d]
    alpha_src = torch.einsum("nhd,hd->nh", h, a_src)
    alpha_dst = torch.einsum("nhd,hd->nh", h, a_dst)
    keep = None
    if generator is not None and att_drop > 0:
        keep = keep_draw(generator, (st.n_draw, heads), 1.0 - att_drop, x.device).float()
        if st.edge_perm is not None:
            keep = keep[st.edge_perm]
        keep = (keep * (1.0 / (1.0 - att_drop))).contiguous()
    if plain:
        out = attention_plain(h, alpha_src, alpha_dst, keep, st, neg_slope)
    else:
        out = AttentionPull.apply(h, alpha_src, alpha_dst, keep, st, neg_slope)
    return out.reshape(n_nodes, heads * d)


def gat_layer_bucketed_sf(x, csr, csr_t, aux, n_nodes, w, a_src, a_dst, heads, neg_slope,
                          generator, att_drop, plain=False):
    """The scatter-free bucketed GAT conv: ``gat_layer`` over
    ``bucketed_attention(csr, csr_t, aux)``; the dropout is one draw of
    [slots, H] in slot order, as the JAX package's."""
    return gat_layer(x, bucketed_attention(csr, csr_t, aux), n_nodes, w, a_src, a_dst, heads,
                     neg_slope, generator, att_drop, plain)


def bucketed_row_nodes(csr, n_nodes):
    """Node id per concat row of the bucketed tables (``gather_pos``'s
    inverse; degree-0 nodes collide harmlessly on the trailing zero row)."""
    out = torch.zeros(csr.total_rows + 1, dtype=torch.int32, device=csr.idx.device)
    out[csr.gather_pos.long()] = torch.arange(n_nodes, dtype=torch.int32, device=out.device)
    return out


def gat_layer_bucketed(x, csr, row_nodes, n_nodes, w, a_src, a_dst, heads, neg_slope,
                       generator, att_drop):
    """The JAX package's first bucketed GAT conv, kept as the oracle: per
    bucket a dense masked softmax along the cap axis and the [nb, cap, H, d]
    messages summed, under autograd; the dropout drawn per bucket
    ([nb, cap, H])."""
    d = a_src.shape[1]
    h = (x @ w).reshape(-1, heads, d)
    alpha_src = torch.einsum("nhd,hd->nh", h, a_src)
    alpha_dst = torch.einsum("nhd,hd->nh", h, a_dst)
    outs, off = [], 0
    for b in csr.buckets:
        nb = b.idx.shape[0]
        dst_rows = row_nodes[off:off + nb].long()
        off += nb
        e = F.leaky_relu(alpha_src[b.idx.long()] + alpha_dst[dst_rows][:, None, :], neg_slope)
        real = ((b.edge >= 0) & (b.val != 0))[:, :, None]
        e = torch.where(real, e, torch.full_like(e, float("-inf")))
        e_max = torch.amax(e, dim=1, keepdim=True)
        e_max = torch.where(torch.isfinite(e_max), e_max, torch.zeros_like(e_max))
        ex = torch.where(real, torch.exp(e - e_max), torch.zeros_like(e))
        att = ex / (torch.sum(ex, dim=1, keepdim=True) + 1e-16)
        if generator is not None and att_drop > 0:
            keep = keep_draw(generator, att.shape, 1.0 - att_drop, x.device)
            att = torch.where(keep, att / (1.0 - att_drop), torch.zeros_like(att))
        outs.append(torch.sum(h[b.idx.long()] * att[..., None], dim=1))
    concat = torch.cat(outs + [h.new_zeros((1, heads, d))])
    return concat[csr.gather_pos.long()].reshape(n_nodes, heads * d)


def attention_structure(graph) -> Attention:
    """The graph's GAT structure, built at the first call and kept on the
    graph (``gat_attention``): the bucketed one (with the graph's slot
    maps, ``ensure_gat_aux``) where the graph is bucketed, else the
    segment one."""
    if graph.gat_attention is None:
        if graph.backend == "bucketed":
            adj = graph.norm_adj
            graph.gat_attention = bucketed_attention(adj.pull, adj.pull_t, graph.ensure_gat_aux())
        else:
            graph.gat_attention = segment_attention(graph)
    return graph.gat_attention


@register("gat")
class GAT(Model):
    name = "gat"
    plain = False  # PlainGAT runs attention_plain

    def __init__(self, config):
        super().__init__(config)
        self.heads = int(config.get("GAT.num_heads", 4))
        self.hidden = int(config.get("GAT.hidden", 64))
        self.dropout = float(config.get("GAT.dropout", 0.2))
        self.edge_dropout = float(config.get("GAT.edge_dropout", 0.2))
        self.neg_slope = float(config.get("GAT.neg_slope", 0.2))

    def init(self, generator: torch.Generator, graph):
        d_in, h, heads, d_out = self.emb_size, self.hidden, self.heads, self.emb_size
        dev = graph.device

        def glorot(shape):
            limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
            return torch.empty(shape).uniform_(-limit, limit, generator=generator).to(dev)

        params = {
            "user_emb": self._init_table(generator, graph.n_users, d_in, dev),
            "item_emb": self._init_table(generator, graph.n_items, d_in, dev),
            "gat1": {"w": glorot((d_in, heads * h)), "a_src": glorot((heads, h)),
                     "a_dst": glorot((heads, h))},
            "gat2": {"w": glorot((heads * h, d_out)), "a_src": glorot((1, d_out)),
                     "a_dst": glorot((1, d_out))},
        }
        return flatten_tree(params), {}

    def _forward(self, params, graph, generator=None):
        g = None if generator is None else device_generator(generator, graph.device)
        st = attention_structure(graph)
        n = graph.n_nodes

        def maybe_dropout(t):
            if g is None or self.dropout <= 0:
                return t
            keep = keep_draw(g, t.shape, 1.0 - self.dropout, t.device)
            return torch.where(keep, t / (1.0 - self.dropout), torch.zeros_like(t))

        def layer(x, name, heads):
            drop = self.edge_dropout if g is not None else 0.0
            w, a_src, a_dst = (params[f"{name}.{k}"] for k in ("w", "a_src", "a_dst"))
            return gat_layer(x, st, n, w, a_src, a_dst, heads, self.neg_slope, g, drop,
                             self.plain)

        x = maybe_dropout(torch.cat([params["user_emb"], params["item_emb"]]))
        x = layer(x, "gat1", self.heads)
        x = maybe_dropout(F.elu(x))
        x = layer(x, "gat2", 1)
        return x[:graph.n_users], x[graph.n_users:]

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self._forward(params, graph, generator)
        u = take_rows(user_all, batch.users)
        pos = take_rows(item_all, batch.pos_items)
        neg = take_rows(item_all, batch.neg_items)
        loss = bpr_loss(u, pos, neg) + l2_reg_loss(self.reg, u, pos, neg) / batch.users.shape[0]
        return loss, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self._forward(params, graph)


class PlainGAT(GAT):
    """GAT with ``attention_plain`` (S1 and S2's plain versions under
    autograd): the reference a kernel step is held against. Not
    registered."""

    plain = True
