"""G-BT: Graph Barlow Twins (counterpart of ``recommendation_tpu/models/gbt.py``;
`univariate/gbt.py:203-228,386-433,454-530`).

A two-layer GCN over ``norm_adj_selfloops`` (widening to ``GBT.hidden``,
2·d by default, then back to d) with batch normalization between the
layers, the bias after each propagation; two views with edges dropped by
value and feature columns masked; the Barlow Twins cross-correlation
loss. ``_batch_norm`` is BatchNorm1d's (the BIASED variance, eps inside
the root), where ``barlow_twins_loss`` standardizes by the unbiased std.
The optimizer is Adam under optax's ``cosine_decay_schedule(lr,
GBT.total_steps)`` (the reference's CosineAnnealingLR, `gbt.py:512-514`):
``train.loop.CosineDecayAdam``. Config: ``GBT.hidden``, ``GBT.out_dim``
(embedding.size), ``GBT.drop_edge`` (0.25), ``GBT.drop_feat`` (0.25),
``GBT.total_steps`` (1000).

Its products are GRACE's: ``torch.matmul`` on the dense backend, P1 over
the segment views of ``norm_adj_selfloops`` on the bucketed and the
segment ones.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.augment import drop_edges, mask_features
from recommendation_tpu_torch.losses import barlow_twins_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.grace import gcn_layer
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import graph_share
from recommendation_tpu_torch.train.loop import CosineDecayAdam
from recommendation_tpu_torch.weights import flatten_tree


def batch_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm1d with batch statistics and no affine part: the biased
    variance, ``eps`` inside the root."""
    return (x - x.mean(dim=0)) / torch.sqrt(x.var(dim=0, unbiased=False) + eps)


@register("gbt")
class GBT(Model):
    name = "gbt"

    def __init__(self, config):
        super().__init__(config)
        self.hidden = int(config.get("GBT.hidden", 2 * int(config.get("embedding.size", 64))))
        self.out_dim = int(config.get("GBT.out_dim", config.get("embedding.size", 64)))
        self.drop_edge = float(config.get("GBT.drop_edge", 0.25))
        self.drop_feat = float(config.get("GBT.drop_feat", 0.25))
        self.total_steps = int(config.get("GBT.total_steps", 1000))

    def make_optimizer(self, config, params):
        return CosineDecayAdam(list(params.values()), float(config.get("learning.rate", 1e-3)),
                               self.total_steps)

    def init(self, generator: torch.Generator, graph):
        graph.norm_adj_selfloops  # built here, at the first access
        dev = graph.device
        return flatten_tree({
            "features": self._init_table(generator, graph.n_nodes, self.out_dim, dev),
            "conv1": self._init_linear(generator, self.out_dim, self.hidden, dev),
            "conv2": self._init_linear(generator, self.hidden, self.out_dim, dev),
        }), {}

    def _gcn(self, params, x, adj):
        z = torch.relu(batch_norm(gcn_layer(params, "conv1", x, adj)))
        return gcn_layer(params, "conv2", z, adj)

    def loss(self, params, state, batch, graph, generator=None):
        adj1 = drop_edges(generator, graph.norm_adj_selfloops, self.drop_edge)
        adj2 = drop_edges(generator, graph.norm_adj_selfloops, self.drop_edge)
        x1 = mask_features(generator, params["features"], self.drop_feat)
        x2 = mask_features(generator, params["features"], self.drop_feat)
        # over all nodes, whatever the batch (the share of a data group's rank)
        loss = barlow_twins_loss(self._gcn(params, x1, adj1), self._gcn(params, x2, adj2))
        return graph_share(loss, batch.group), state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            z = self._gcn(params, params["features"], graph.norm_adj_selfloops)
            return z[:graph.n_users], z[graph.n_users:]
