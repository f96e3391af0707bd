"""GRACE: GCN contrastive learning with two augmented views (counterpart
of ``recommendation_tpu/models/grace.py``; `univariate/grace.py:236-553`).

A GCN encoder over the self-loop normalized adjacency
(``norm_adj_selfloops``, D̃^-1/2 (A + I) D̃^-1/2) on identity node
features, held as a learned [U + I, hidden] table (I·W = W); each layer
adds its bias AFTER the propagation, ``relu(adj @ (x W) + b)``, as
GCNConv does (`grace.py:510-519`). Each view drops edges by value
(``drop_edges``, kept values scaled by 1/(1 - p)) and masks feature
columns (``mask_features``); an ELU projection head; the dual-branch
InfoNCE with intra-view negatives (``grace_dual_branch_loss``). The loss
takes the whole graph every step, whatever the batch. Config:
``GRACE.num_layers`` (2), ``GRACE.hidden`` (embedding.size),
``GRACE.proj_dim`` (64), ``GRACE.tau`` (0.5), ``GRACE.drop_edge1/2`` (0.3,
0.4), ``GRACE.drop_feat1/2`` (0.3, 0.4).

On the dense backend its products are ``torch.matmul`` with the (U+I)²
matrix (no kernel of the port). Where the graph is bucketed the JAX
package puts ``norm_adj_selfloops`` on the segment backend, and so does
the port: its products are then P1 over the row-sorted view, and over the
transpose view in the backward (``ops/spmm.py::_segment_matmul``); the
same on the segment backend.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recommendation_tpu_torch.graph.augment import drop_edges, mask_features
from recommendation_tpu_torch.losses import grace_dual_branch_loss
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import graph_share
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.weights import flatten_tree, layer_count


def gcn_layer(params, name: str, x: torch.Tensor, adj) -> torch.Tensor:
    """GCNConv: ``adj @ (x W) + b``, the bias after the propagation (Â·b ≠ b
    under the symmetric normalization)."""
    return adj_matmul(adj, x @ params[f"{name}.w"]) + params[f"{name}.b"]


@register("grace")
class GRACE(Model):
    name = "grace"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("GRACE.num_layers", 2))
        self.hidden = int(config.get("GRACE.hidden", config.get("embedding.size", 64)))
        self.proj_dim = int(config.get("GRACE.proj_dim", 64))
        self.tau = float(config.get("GRACE.tau", 0.5))
        self.drop_edge1 = float(config.get("GRACE.drop_edge1", 0.3))
        self.drop_edge2 = float(config.get("GRACE.drop_edge2", 0.4))
        self.drop_feat1 = float(config.get("GRACE.drop_feat1", 0.3))
        self.drop_feat2 = float(config.get("GRACE.drop_feat2", 0.4))

    def init(self, generator: torch.Generator, graph):
        graph.norm_adj_selfloops  # built here, at the first access
        h, dev = self.hidden, graph.device
        return flatten_tree({
            "features": self._init_table(generator, graph.n_nodes, h, dev),
            "convs": [self._init_linear(generator, h, h, dev) for _ in range(self.n_layers)],
            "fc1": self._init_linear(generator, h, self.proj_dim, dev),
            "fc2": self._init_linear(generator, self.proj_dim, h, dev),
        }), {}

    def _gcn(self, params, x, adj):
        for i in range(layer_count(params, "convs")):
            x = torch.relu(gcn_layer(params, f"convs.{i}", x, adj))
        return x

    def _project(self, params, z):
        return linear(params, "fc2", F.elu(linear(params, "fc1", z)))

    def loss(self, params, state, batch, graph, generator=None):
        adj1 = drop_edges(generator, graph.norm_adj_selfloops, self.drop_edge1)
        adj2 = drop_edges(generator, graph.norm_adj_selfloops, self.drop_edge2)
        x1 = mask_features(generator, params["features"], self.drop_feat1)
        x2 = mask_features(generator, params["features"], self.drop_feat2)
        z1 = self._project(params, self._gcn(params, x1, adj1))
        z2 = self._project(params, self._gcn(params, x2, adj2))
        # over all nodes, whatever the batch: under a data group each rank
        # computes it whole and takes its share of the gradient
        return graph_share(grace_dual_branch_loss(z1, z2, self.tau), batch.group), state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            z = self._gcn(params, params["features"], graph.norm_adj_selfloops)
            return z[:graph.n_users], z[graph.n_users:]
