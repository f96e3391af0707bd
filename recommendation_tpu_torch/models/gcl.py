"""GCL: graph contrastive learning for recommendation, GRACE-style
(counterpart of ``recommendation_tpu/models/gcl.py``; `gcl.py:18-64,195-235`).

Two edge-dropped, re-normalized views of the bipartite graph
(``dropped_norm_adj``), each through the encoder and a two-layer
projection head; the symmetric InfoNCE over ALL users and over all items
between the views, plus BPR on view 1's projected rows and the SQUARED
row regularizer divided by the batch (`gcl.py:224-225`; not
``l2_reg_loss``). Evaluation ranks with the raw encodings of
``norm_adj``. Config: ``GCL.num_layers`` (2), ``GCL.proj_dim`` (64),
``GCL.ssl_temp`` (0.2), ``GCL.drop_edge`` (0.2), ``GCL.reg_weight``,
``GCL.encoder``: 'graph' (the default: L ``adj_matmul`` rounds with the
mean readout) or 'linear' (the reference script's stack of linear layers
that ignores the graph, `gcl.py:52-56`).

``adj_matmul`` is a product with the (U+I)² matrix on the dense backend
(``torch.matmul``, as the JAX package leaves it to XLA) and P1 (value
path) plus K7 each way on the bucketed one. The InfoNCE materializes
[U, U] and [I, I] score matrices, as the JAX package's does.
``PlainBucketedGCL`` pulls through the plain versions of P1 and K7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from recommendation_tpu_torch.graph.augment import dropped_norm_adj
from recommendation_tpu_torch.graph.bucketed import PLAIN, pull
from recommendation_tpu_torch.losses import batch_mean, info_nce
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import graph_share, group_rows, reduce_sum
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.weights import flatten_tree, layer_count


@register("gcl")
@register("grace_rec")
class GCL(Model):
    name = "gcl"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("GCL.num_layers", config.get("n_layers", 2)))
        self.proj_dim = int(config.get("GCL.proj_dim", 64))
        self.ssl_temp = float(config.get("GCL.ssl_temp", 0.2))
        self.drop_edge = float(config.get("GCL.drop_edge", 0.2))
        self.reg_weight = float(config.get("GCL.reg_weight", config.get("reg.lambda", 1e-4)))
        self.encoder_kind = str(config.get("GCL.encoder", "graph"))

    def init(self, generator: torch.Generator, graph):
        d, dev = self.emb_size, graph.device
        tree = {
            "user_emb": self._init_table(generator, graph.n_users, d, dev),
            "item_emb": self._init_table(generator, graph.n_items, d, dev),
            "proj1": self._init_linear(generator, d, self.proj_dim, dev),
            "proj2": self._init_linear(generator, self.proj_dim, self.proj_dim, dev),
        }
        if self.encoder_kind == "linear":
            tree["convs"] = [self._init_linear(generator, d, d, dev)
                             for _ in range(self.n_layers)]
        return flatten_tree(tree), {}

    def _matmul(self, adj, x):
        return adj_matmul(adj, x)

    def _encode(self, params, adj):
        x = torch.cat([params["user_emb"], params["item_emb"]])
        if self.encoder_kind == "linear":
            for i in range(layer_count(params, "convs")):
                x = linear(params, f"convs.{i}", x)
            return x
        acc = x
        for _ in range(self.n_layers):
            x = self._matmul(adj, x)
            acc = acc + x
        return acc / (self.n_layers + 1)

    def _project(self, params, x):
        return linear(params, "proj2", torch.relu(linear(params, "proj1", x)))

    def loss(self, params, state, batch, graph, generator=None):
        adj1 = dropped_norm_adj(generator, graph, self.drop_edge)
        adj2 = dropped_norm_adj(generator, graph, self.drop_edge)
        z1 = self._project(params, self._encode(params, adj1))
        z2 = self._project(params, self._encode(params, adj2))
        nu = graph.n_users
        u1, i1, u2, i2 = z1[:nu], z1[nu:], z2[:nu], z2[nu:]

        def sym_nce(a, b):  # the mean of both directions (`gcl.py:28-35`)
            return (info_nce(a, b, self.ssl_temp) + info_nce(b, a, self.ssl_temp)) / 2.0

        # with the data group: the InfoNCE over all nodes is every rank's
        # whole (its gradient's share), BPR and the rows' squares the global
        # batch's
        grp = batch.group
        ssl = graph_share(sym_nce(u1, u2) + sym_nce(i1, i2), grp)
        u_e = take_rows(u1, batch.users)
        p_e = take_rows(i1, batch.pos_items)
        n_e = take_rows(i1, batch.neg_items)
        bpr = -batch_mean(F.logsigmoid(torch.sum(u_e * p_e, dim=1) - torch.sum(u_e * n_e, dim=1)),
                          grp)
        reg = reduce_sum(torch.sum(u_e ** 2) + torch.sum(p_e ** 2) + torch.sum(n_e ** 2),
                        grp) / group_rows(u_e.shape[0], grp)
        return ssl + bpr + self.reg_weight * reg, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            z = self._encode(params, graph.norm_adj)
            return z[:graph.n_users], z[graph.n_users:]


class PlainBucketedGCL(GCL):
    """GCL on a bucketed graph with each round a ``pull`` through the plain
    versions of P1 and K7 (autograd through torch ops). Not registered."""

    def _matmul(self, adj, x):
        return pull(adj.pull, x, adj.compute_dtype, ops=PLAIN)
