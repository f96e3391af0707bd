"""GraphSAGE over the bipartite graph (counterpart of
``recommendation_tpu/models/graphsage.py``; `graphsage.py:15-32,46`).

A stack of SAGE layers with the mean aggregator, x' = W_self·x +
W_neigh·mean_N(x), over RANDOM node features (`graphsage.py:46`: node ids
carry no learned embedding), ReLU and dropout between layers, BPR or BCE.
``GraphSAGE.learned_features`` learns the features instead. Config:
``GraphSAGE.n_layers`` (``n_layers``, 2), ``GraphSAGE.hidden`` (64),
``GraphSAGE.dropout`` (0.2), ``GraphSAGE.in_dim`` (64), ``loss``.

The fixed features stay in the parameters (checkpoints carry them) but
take no gradient: the JAX package's ``stop_gradient`` gives them a zero
gradient, which Adam turns into a zero update; here the model names them
``frozen``, so the trainer makes them without ``requires_grad``, the step
loop differentiates only the other parameters, and every optimizer leaves
the features exactly as they are (no L2 reaches them either; the forward
detaches them too).

The aggregation is ``masked_segment_mean`` over both directions of every
edge (``bidirectional_edges``), on every backend: P2 over the graph's
cached destination view (``DeviceGraph.bipartite_views``) with the edge
mask in slot order as the values and 1/max(count, 1) as the row scale,
and P2 over the source view as its backward, where the JAX package
gathers the [2E, d] messages and ``segment_sum``s them. Dropout masks come
from ``graph.augment.uniform``, as every mask of the port's models.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.augment import keep_draw
from recommendation_tpu_torch.losses import bce_loss, bpr_loss, l2_reg_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import group_rows
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.segment import SegmentCSR, row_counts, segment_pull
from recommendation_tpu_torch.weights import flatten_tree, layer_count


def bidirectional_edges(graph):
    """(src, dst, mask): both directions of every interaction edge, padded
    (i64 node ids over the [2·E_pad] positions, f32 mask), as the JAX
    package's: ``src = [u; i + U]``, ``dst = [i + U; u]``."""
    u = graph.edge_users.long()
    i = graph.edge_items.long() + graph.n_users
    return torch.cat([u, i]), torch.cat([i, u]), torch.cat([graph.edge_valid, graph.edge_valid])


def masked_segment_mean(x: torch.Tensor, dst_view: SegmentCSR, src_view: SegmentCSR,
                        mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``masked_segment_mean(x[src], dst, mask, n)``: per
    destination, the masked sum of its sources' rows over the masked count
    (at least 1). ``dst_view``/``src_view`` are the edges' views by
    destination and by source, ``mask`` f32 over the edge positions. P2
    over ``dst_view`` forward, over ``src_view`` backward."""
    val = mask[dst_view.perm]
    post = 1.0 / torch.clamp(row_counts(dst_view, val), min=1.0)
    return segment_pull(x, dst_view, src_view, val=val, val_t=mask[src_view.perm], post=post)


def masked_segment_mean_plain(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                              mask: torch.Tensor, n: int) -> torch.Tensor:
    """The same in plain torch (the [2E, d] messages added into their
    destinations); autograd differentiates it."""
    sums = torch.zeros((n, x.shape[1]), device=x.device).index_add(0, dst, x[src] * mask[:, None])
    counts = torch.zeros(n, device=x.device).index_add(0, dst, mask)
    return sums / torch.clamp(counts, min=1.0)[:, None]


@register("graphsage")
class GraphSAGE(Model):
    name = "graphsage"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("GraphSAGE.n_layers", config.get("n_layers", 2)))
        self.hidden = int(config.get("GraphSAGE.hidden", 64))
        self.dropout = float(config.get("GraphSAGE.dropout", 0.2))
        self.in_dim = int(config.get("GraphSAGE.in_dim", 64))
        self.loss_type = str(config.get("loss", "bpr"))
        self.learned_features = bool(config.get("GraphSAGE.learned_features", False))
        self.frozen = () if self.learned_features else ("features",)

    def init(self, generator: torch.Generator, graph):
        dev = graph.device
        if self.learned_features:
            features = self._init_table(generator, graph.n_nodes, self.in_dim, dev)
        else:
            # fixed N(0, 1) features (`graphsage.py:46`), kept for checkpoints
            features = torch.randn(graph.n_nodes, self.in_dim, generator=generator).to(dev)
        dims = [self.in_dim] + [self.hidden] * (self.n_layers - 1) + [self.emb_size]
        layers = [{"self": self._init_linear(generator, dims[li], dims[li + 1], dev),
                   "neigh": self._init_linear(generator, dims[li], dims[li + 1], dev)}
                  for li in range(self.n_layers)]
        return flatten_tree({"features": features, "layers": layers}), {}

    def _aggregate(self, x, graph):
        by_src, by_dst = graph.bipartite_views()
        return masked_segment_mean(x, by_dst, by_src, bidirectional_edges(graph)[2])

    def _forward(self, params, graph, generator=None):
        x = params["features"]
        if not self.learned_features:
            x = x.detach()
        n_layers = layer_count(params, "layers")
        for li in range(n_layers):
            neigh = self._aggregate(x, graph)
            x = (x @ params[f"layers.{li}.self.w"] + params[f"layers.{li}.self.b"]
                 + neigh @ params[f"layers.{li}.neigh.w"] + params[f"layers.{li}.neigh.b"])
            if li < n_layers - 1:
                x = torch.relu(x)
                if generator is not None and self.dropout > 0:
                    keep = keep_draw(generator, x.shape, 1.0 - self.dropout, x.device)
                    x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        return x[:graph.n_users], x[graph.n_users:]

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self._forward(params, graph, generator)
        u = take_rows(user_all, batch.users)
        pos = take_rows(item_all, batch.pos_items)
        neg = take_rows(item_all, batch.neg_items)
        fn = bpr_loss if self.loss_type == "bpr" else bce_loss
        grp = batch.group  # the data group: the global batch's mean and L2 (losses.py)
        b = group_rows(batch.users.shape[0], grp)
        return fn(u, pos, neg, group=grp) + l2_reg_loss(self.reg, u, pos, neg, group=grp) / b, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self._forward(params, graph)


class PlainGraphSAGE(GraphSAGE):
    """GraphSAGE with the plain masked mean (autograd through torch ops):
    the reference a kernel step is held against. Not registered."""

    def _aggregate(self, x, graph):
        src, dst, mask = bidirectional_edges(graph)
        return masked_segment_mean_plain(x, src, dst, mask, graph.n_nodes)
