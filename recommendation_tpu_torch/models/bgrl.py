"""BGRL (G2L): bootstrapped graph latents with an EMA target network
(counterpart of ``recommendation_tpu/models/bgrl.py``;
`univariate/bgrl_g2l.py:121-127,277-308,436-446,505-583`).

A GIN encoder over the raw (binarized) adjacency: each layer
``relu(MLP(z + adj @ z))`` with a two-layer MLP (``mlp1`` widening to
2·hidden, ReLU, ``mlp2``), then batch normalization, the projection,
batch normalization and a PReLU with a learned 0-d slope (``prelu``,
0.25 at init). Node features are a learned [U + I, hidden] table; each of
two views drops edges by value and masks feature columns. The online
encoder's projections go through a linear predictor; the target encoder
(carried state ``target.*``, a copy of ``online.*`` at init) runs under
``no_grad`` with a sum readout, and the loss is the G2L bootstrap
(``bootstrap_g2l_loss``). ``post_step`` moves the whole target tree toward
the online one, ``t·m + o·(1 - m)`` (momentum ``BGRL.momentum``, 0.99).
Config: ``BGRL.num_layers`` (2), ``BGRL.hidden`` (embedding.size),
``BGRL.drop_edge`` (0.25), ``BGRL.drop_feat`` (0.25).

``adj_matmul`` is ``torch.matmul`` with the (U+I)² matrix on the dense
backend and P1 (value path) plus K7 each way on the bucketed one. The
binarized adjacency is built once per graph and kept, where the JAX
package rebuilds it inside every step: the same values.
``PlainBucketedBGRL`` pulls through the plain versions of P1 and K7.
"""

from __future__ import annotations

import weakref

import torch

from recommendation_tpu_torch.graph.augment import drop_edges, mask_features
from recommendation_tpu_torch.graph.bucketed import PLAIN, pull
from recommendation_tpu_torch.graph.device import binarized
from recommendation_tpu_torch.losses import bootstrap_g2l_loss
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.gbt import batch_norm
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import graph_share
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.weights import flatten_tree, layer_count, subtree


@register("bgrl")
@register("bgrl_g2l")
class BGRL(Model):
    name = "bgrl"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("BGRL.num_layers", 2))
        self.hidden = int(config.get("BGRL.hidden", config.get("embedding.size", 64)))
        self.momentum = float(config.get("BGRL.momentum", 0.99))
        self.drop_edge = float(config.get("BGRL.drop_edge", 0.25))
        self.drop_feat = float(config.get("BGRL.drop_feat", 0.25))
        self._raw_adj = weakref.WeakKeyDictionary()  # graph -> binarized(graph.norm_adj)

    def _encoder_params(self, generator, device):
        h = self.hidden
        return {
            "convs": [{"mlp1": self._init_linear(generator, h, 2 * h, device),
                       "mlp2": self._init_linear(generator, 2 * h, h, device)}
                      for _ in range(self.n_layers)],
            "proj": self._init_linear(generator, h, h, device),
            "prelu": torch.tensor(0.25, device=device),
        }

    def init(self, generator: torch.Generator, graph):
        dev = graph.device
        online = self._encoder_params(generator, dev)
        params = flatten_tree({
            "features": self._init_table(generator, graph.n_nodes, self.hidden, dev),
            "online": online,
            "predictor": self._init_linear(generator, self.hidden, self.hidden, dev),
        })
        target = {k: v.clone() for k, v in flatten_tree(online).items()}
        return params, flatten_tree({"target": target})

    def _adj(self, graph):
        if graph not in self._raw_adj:
            self._raw_adj[graph] = binarized(graph.norm_adj)
        return self._raw_adj[graph]

    def _matmul(self, adj, x):
        return adj_matmul(adj, x)

    def _gin(self, enc, x, adj):
        """The GIN stack (`bgrl_g2l.py:498-531`) of the encoder ``enc`` (a
        flat dict relative to its prefix), then batch norm and the
        projection head: (z, p)."""
        z = x
        for i in range(layer_count(enc, "convs")):
            h = torch.relu(linear(enc, f"convs.{i}.mlp1", z + self._matmul(adj, z)))
            z = torch.relu(linear(enc, f"convs.{i}.mlp2", h))
        z = batch_norm(z)
        p = batch_norm(linear(enc, "proj", z))
        return z, torch.where(p >= 0, p, enc["prelu"] * p)

    def loss(self, params, state, batch, graph, generator=None):
        ones = self._adj(graph)
        a1 = drop_edges(generator, ones, self.drop_edge)
        a2 = drop_edges(generator, ones, self.drop_edge)
        x1 = mask_features(generator, params["features"], self.drop_feat)
        x2 = mask_features(generator, params["features"], self.drop_feat)
        online = subtree(params, "online")
        h1 = linear(params, "predictor", self._gin(online, x1, a1)[1])
        h2 = linear(params, "predictor", self._gin(online, x2, a2)[1])
        with torch.no_grad():
            target = subtree(state, "target")
            g1 = torch.sum(self._gin(target, x1, a1)[1], dim=0)  # global_add_pool
            g2 = torch.sum(self._gin(target, x2, a2)[1], dim=0)
        # over all nodes, whatever the batch (the share of a data group's rank)
        return graph_share(bootstrap_g2l_loss(h1, h2, g1, g2), batch.group), state

    def post_step(self, params, state, batch):
        """The whole target tree's EMA toward the online one, as new tensors."""
        m = self.momentum
        with torch.no_grad():
            return {k: t * m + params["online." + k[len("target."):]] * (1.0 - m)
                    for k, t in state.items()}

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            z, _ = self._gin(subtree(params, "online"), params["features"], self._adj(graph))
            return z[:graph.n_users], z[graph.n_users:]


class PlainBucketedBGRL(BGRL):
    """BGRL on a bucketed graph with each product a ``pull`` through the
    plain versions of P1 and K7 (autograd through torch ops). Not
    registered."""

    def _matmul(self, adj, x):
        return pull(adj.pull, x, adj.compute_dtype, ops=PLAIN)
