"""LightGCN: K-layer normalized propagation + layer-mean readout, BPR/BCE.

Counterpart of ``recommendation_tpu/models/lightgcn.py`` on every
backend: ``lightgcn_propagate``'s bipartite dense branch
(``return_layers=False``) in the f32 and the bf16 regime,
``lightgcn_propagate_square`` for its branches over the square adjacency
(``norm_adj``, dense, bucketed or segment, with ``return_layers``), and
``LightGCN.init/propagate/loss/eval_embeddings``. Config:
``LightGCN.n_layers`` (default 3), ``loss`` in {'bpr', 'bce', 'pointwise'},
``n_negs`` (extra negatives per edge, `lightgcn.py:93-104`),
``Pointwise.n_negs``, ``reg.lambda``.

On the dense backend the layer chain goes through ``ops.prop.ChainMean``
(kernels K1 forward, K2 backward); on the bucketed backend through
``graph.bucketed.BucketedChainMean`` (K7 and P1 both ways); on the segment
(and pallas) backend, which has no R̂, as in the JAX package, through L
``adj_matmul`` rounds over ``norm_adj`` (P1 over its row-sorted view, and
over the transpose view in the backward). The card runs the kernels, the
CPU their plain versions.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_chain_mean
from recommendation_tpu_torch.losses import bce_loss, bpr_loss, l2_reg_loss, pointwise_bce_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.prop import ChainMean
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.sampling import negative_words, sample_negatives, sample_pointwise


def lightgcn_propagate(
    user_emb: torch.Tensor, item_emb: torch.Tensor, r_hat: torch.Tensor, n_layers: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """L rounds of Â·E with the mean-of-layers readout (layer 0 included),
    over the bipartite block form Â = [[0, R̂], [R̂ᵀ, 0]], with a gradient
    to both tables.

    ``r_hat`` is R̂ in the compute dtype (``DeviceGraph.propagation_matrix``):
    bf16 rounds the running table to bf16 before each product, f32 keeps
    f32. Accumulation is f32 in both."""
    return ChainMean.apply(r_hat, user_emb.contiguous(), item_emb.contiguous(), n_layers)


def lightgcn_propagate_square(user_emb: torch.Tensor, item_emb: torch.Tensor, norm_adj,
                              n_layers: int, return_layers: bool = False):
    """The same readout over the square normalized adjacency ``norm_adj``
    (a dense or bucketed ``DeviceAdj``) on the stacked [users; items]
    table: the fused row-space chain where both bucketed directions share
    a row space (``sym_rowspace``), else, and for ``return_layers``, L
    ``adj_matmul`` rounds (on the dense backend, products with the (U+I)²
    matrix). ``return_layers`` adds the list of the L + 1 layer tables."""
    n_users = user_emb.shape[0]
    ego = torch.cat([user_emb, item_emb])
    if not return_layers and norm_adj.sym_rowspace:
        mean = bucketed_chain_mean(n_layers, norm_adj.compute_dtype, norm_adj.pull,
                                   norm_adj.pull_t, ego)
        return mean[:n_users], mean[n_users:]
    if return_layers:
        layers = [ego]
        for _ in range(n_layers):
            ego = adj_matmul(norm_adj, ego)
            layers.append(ego)
        mean = torch.mean(torch.stack(layers), dim=0)
        return mean[:n_users], mean[n_users:], layers
    acc = ego
    for _ in range(n_layers):
        ego = adj_matmul(norm_adj, ego)
        acc = acc + ego
    mean = acc / (n_layers + 1.0)
    return mean[:n_users], mean[n_users:]


def lightgcn_encode(user_emb: torch.Tensor, item_emb: torch.Tensor, graph, n_layers: int):
    """LightGCN's encoder on the graph's backend: the dense chain over R̂
    (``ChainMean``: K1 forward, K2 backward) or, on the other backends,
    the square path over ``norm_adj``: the bucketed row-space chain (K7 and
    P1 both ways), L segment matmuls (P1 both ways)."""
    if graph.backend != "dense":
        return lightgcn_propagate_square(user_emb, item_emb, graph.norm_adj, n_layers)
    return lightgcn_propagate(user_emb, item_emb, graph.propagation_matrix, n_layers)


@register("lightgcn")
class LightGCN(Model):
    name = "lightgcn"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("LightGCN.n_layers", config.get("n_layers", 3)))
        self.loss_type = str(config.get("loss", "bpr"))
        self.n_negs = int(config.get("n_negs", 1))

    def init(self, generator: torch.Generator, graph):
        params = {
            "user_emb": self._init_table(generator, graph.n_users, self.emb_size, graph.device),
            "item_emb": self._init_table(generator, graph.n_items, self.emb_size, graph.device),
        }
        return params, {}

    def propagate(self, params, graph):
        return lightgcn_encode(params["user_emb"], params["item_emb"], graph, self.n_layers)

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self.propagate(params, graph)
        b = batch.users.shape[0]

        if self.loss_type == "pointwise":
            # 1 positive + k y=0 rows per edge, BCE over the scores
            k = int(self.config.get("Pointwise.n_negs", 4))
            words = negative_words(generator, k, b, graph.device)
            pw = sample_pointwise(words, graph, batch.users, batch.pos_items,
                                  n_negs=k, weight=batch.weight)
            u = take_rows(user_all, pw.users)
            it = take_rows(item_all, pw.items)
            scores = torch.sum(u * it, dim=1)
            rank = pointwise_bce_loss(scores, pw.labels, pw.weight)
            return rank + l2_reg_loss(self.reg, u, it) / b, state

        u = take_rows(user_all, batch.users)
        pos = take_rows(item_all, batch.pos_items)
        neg = take_rows(item_all, batch.neg_items)
        fn = bpr_loss if self.loss_type == "bpr" else bce_loss
        if self.n_negs > 1:
            # mean of the rank loss over n_negs fresh negatives
            # (`lightgcn.py:93-104`); the L2 term keeps the batch's negative
            words = negative_words(generator, self.n_negs, b, graph.device)
            rank = torch.mean(torch.stack([
                fn(u, pos, take_rows(item_all, sample_negatives(words[j], graph, batch.users)))
                for j in range(self.n_negs)
            ]))
        else:
            rank = fn(u, pos, neg)
        return rank + l2_reg_loss(self.reg, u, pos, neg) / b, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self.propagate(params, graph)
