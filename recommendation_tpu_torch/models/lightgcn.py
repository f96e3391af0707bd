"""LightGCN: K-layer normalized propagation + layer-mean readout, BPR/BCE.

Counterpart of ``recommendation_tpu/models/lightgcn.py`` on the dense
backend: the bipartite dense branch of ``lightgcn_propagate``
(``return_layers=False``) in the f32 and the bf16 regime, and
``LightGCN.init/propagate/loss/eval_embeddings``. Config: ``LightGCN.n_layers``
(default 3), ``loss`` in {'bpr', 'bce', 'pointwise'}, ``n_negs`` (extra
negatives per edge, `lightgcn.py:93-104`), ``Pointwise.n_negs``,
``reg.lambda``.

The layer chain always goes through ``ops.prop.ChainMean``: kernels K1
(forward) and K2 (backward) on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.losses import bce_loss, bpr_loss, l2_reg_loss, pointwise_bce_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.prop import ChainMean
from recommendation_tpu_torch.ops.rows import take_rows
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
        return lightgcn_propagate(
            params["user_emb"], params["item_emb"], graph.propagation_matrix, self.n_layers
        )

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
