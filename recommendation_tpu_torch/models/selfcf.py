"""SelfCF-HE: self-supervised CF without negatives, through historical
embeddings (counterpart of ``recommendation_tpu/models/selfcf.py``;
`selfcf.py:457-591`).

An online LightGCN encoder and a linear predictor; the target of each
batch row is a momentum blend of its HISTORICAL embedding with the current
online row (`selfcf.py:497-510`). The histories ``u_his`` [U, d] and
``i_his`` [I, d] are carried state: a step reads the batch's history rows,
then returns NEW tables with those rows overwritten by the online rows
(``index_copy``, not in place), so the step loop's NaN guard can keep the
old ones. Duplicate ids in a batch carry identical rows, so any write
order gives the same tables. Config: ``SelfCF.tau`` (momentum, 0.05),
``SelfCF.n_layer`` (2), ``reg.weight`` (1.0).

The encoder is LightGCN's (``lightgcn_encode``): the dense chain over R̂
(K1 forward, K2 backward) on the dense backend, the row-space chain over
``norm_adj`` (K7 and P1, P1 on the separable fold) on the bucketed one, L
segment matmuls (P1) on the segment one.
Ranking uses the dual score p(u)·iᵀ + u·p(i)ᵀ (`selfcf.py:581-591`) as one
product of the width-2d tables [p(u), u] and [i, p(i)].
``PlainSelfCF`` swaps the chain's kernels for their plain versions: the
reference a kernel step is held against.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_chain_mean_plain
from recommendation_tpu_torch.ops.spmm import segment_matmul_plain
from recommendation_tpu_torch.losses import selfcf_loss
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.lightgcn import lightgcn_encode
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.prop import chain_mean_plain
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.weights import flatten_tree


def dual_score_tables(params, u: torch.Tensor, i: torch.Tensor):
    """([p(u), u], [i, p(i)]): the width-2d tables whose product is the dual
    score, ``p`` the linear ``predictor``."""
    return (torch.cat([linear(params, "predictor", u), u], dim=1),
            torch.cat([i, linear(params, "predictor", i)], dim=1))


@register("selfcf")
class SelfCF(Model):
    name = "selfcf"

    def __init__(self, config):
        super().__init__(config)
        self.momentum = float(config.get("SelfCF.tau", 0.05))
        self.n_layers = int(config.get("SelfCF.n_layer", config.get("n_layers", 2)))
        self.reg_weight = float(config.get("reg.weight", 1.0))

    def init(self, generator: torch.Generator, graph):
        d, dev = self.emb_size, graph.device
        params = flatten_tree({
            "user_emb": self._init_table(generator, graph.n_users, d, dev),
            "item_emb": self._init_table(generator, graph.n_items, d, dev),
            "predictor": self._init_linear(generator, d, d, dev),
        })
        # the histories start from randn, as the reference's (`selfcf.py:498-499`)
        state = {"u_his": torch.randn(graph.n_users, d, generator=generator).to(dev),
                 "i_his": torch.randn(graph.n_items, d, generator=generator).to(dev)}
        return params, state

    def propagate(self, params, graph):
        return lightgcn_encode(params["user_emb"], params["item_emb"], graph, self.n_layers)

    def loss(self, params, state, batch, graph, generator=None):
        u_online, i_online = self.propagate(params, graph)
        users, items = batch.users.long(), batch.pos_items.long()
        u_rows = take_rows(u_online, users)
        i_rows = take_rows(i_online, items)
        m = self.momentum
        with torch.no_grad():
            # the targets read the histories before this step writes them
            u_target = state["u_his"][users] * m + u_rows * (1.0 - m)
            i_target = state["i_his"][items] * m + i_rows * (1.0 - m)
            new_state = {"u_his": state["u_his"].index_copy(0, users, u_rows),
                         "i_his": state["i_his"].index_copy(0, items, i_rows)}
        loss = self.reg_weight * selfcf_loss(linear(params, "predictor", u_rows), u_target,
                                             linear(params, "predictor", i_rows), i_target)
        return loss, new_state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return dual_score_tables(params, *self.propagate(params, graph))


class PlainSelfCF(SelfCF):
    """SelfCF with the plain chains (autograd through torch ops): the dense
    ``chain_mean_plain`` over R̂, the bucketed ``bucketed_chain_mean_plain``
    over ``norm_adj``, or L plain segment matmuls over it. Not registered."""

    def propagate(self, params, graph):
        u, i = params["user_emb"], params["item_emb"]
        adj = graph.norm_adj if graph.backend != "dense" else None
        if graph.backend == "bucketed":
            mean = bucketed_chain_mean_plain(self.n_layers, adj.compute_dtype, adj.pull,
                                             torch.cat([u, i]))
            return mean[:graph.n_users], mean[graph.n_users:]
        if adj is not None:
            ego = acc = torch.cat([u, i])
            for _ in range(self.n_layers):
                ego = segment_matmul_plain(adj, ego)
                acc = acc + ego
            mean = acc / (self.n_layers + 1.0)
            return mean[:graph.n_users], mean[graph.n_users:]
        return chain_mean_plain(graph.propagation_matrix, u, i, self.n_layers)
