"""SSL4Rec: two-tower retrieval with an item-dropout contrastive loss
(counterpart of ``recommendation_tpu/models/ssl4rec.py``;
`ssl4rec.py:160-266`).

The query and item towers are MLPs over id embeddings (``n.layers``
linear layers, hidden ``SSL4Rec.hidden`` 1024, out ``SSL4Rec.out_dim``
128, ReLU between, tanh last; `ssl4rec.py:176-187`). The loss is the
in-batch softmax retrieval loss plus ``SSL4Rec.alpha`` × the InfoNCE
between two dropout views of the batch's raw item embeddings through the
item tower (``feature_dropout``: kept entries scaled by 1/(1 - p)), plus
the L2 term (`ssl4rec.py:25-30,192-196`). There is no graph in the loss,
so it runs on either backend and reaches no kernel of the port.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.augment import keep_draw
from recommendation_tpu_torch.losses import batch_softmax_loss, info_nce, l2_reg_loss
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import global_batch
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.weights import flatten_tree, layer_count


def mlp_apply(params, prefix: str, x: torch.Tensor, final_tanh: bool = True) -> torch.Tensor:
    """The MLP ``prefix.0``, ``prefix.1``, ..: ReLU after each layer but the
    last, tanh after the last (``final_tanh``)."""
    n = layer_count(params, prefix)
    for idx in range(n):
        x = linear(params, f"{prefix}.{idx}", x)
        if idx < n - 1:
            x = torch.relu(x)
        elif final_tanh:
            x = torch.tanh(x)
    return x


def feature_dropout(generator: torch.Generator, x: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability 1 - p, scaled by
    1/(1 - p)."""
    keep = keep_draw(generator, x.shape, 1.0 - p, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


@register("ssl4rec")
class SSL4Rec(Model):
    name = "ssl4rec"

    def __init__(self, config):
        super().__init__(config)
        self.cl_rate = float(config.get("SSL4Rec.alpha", 0.5))
        self.tau = float(config.get("SSL4Rec.tau", 0.1))
        self.drop = float(config.get("SSL4Rec.drop", 0.1))
        self.n_layers = int(config.get("n.layers", 1))
        self.hidden = int(config.get("SSL4Rec.hidden", 1024))
        self.out_dim = int(config.get("SSL4Rec.out_dim", 128))

    def _build_mlp(self, generator, d_in, device):
        layers = []
        for i in range(self.n_layers):
            d_out = self.hidden if i < self.n_layers - 1 else self.out_dim
            layers.append(self._init_linear(generator, d_in, d_out, device))
            d_in = d_out
        return layers

    def init(self, generator: torch.Generator, graph):
        d, dev = self.emb_size, graph.device
        return flatten_tree({
            "user_emb": self._init_table(generator, graph.n_users, d, dev),
            "item_emb": self._init_table(generator, graph.n_items, d, dev),
            "user_net": self._build_mlp(generator, d, dev),
            "item_net": self._build_mlp(generator, d, dev),
        }), {}

    def towers(self, params, user_ids, item_ids):
        u = mlp_apply(params, "user_net", take_rows(params["user_emb"], user_ids))
        i = mlp_apply(params, "item_net", take_rows(params["item_emb"], item_ids))
        return u, i

    def loss(self, params, state, batch, graph, generator=None):
        # with the data group the rank's rows are the queries and the global
        # batch's items the keys (the dropout drawn at the global shape, as
        # one device would draw it); with no group both are the batch's
        grp = batch.group
        whole, lo = global_batch(batch)
        n = batch.users.shape[0]
        u_emb, keys = self.towers(params, batch.users, whole.pos_items)
        rec = batch_softmax_loss(u_emb, keys, self.tau, group=grp)
        raw = take_rows(params["item_emb"], whole.pos_items)
        v1 = mlp_apply(params, "item_net", feature_dropout(generator, raw, self.drop))
        v2 = mlp_apply(params, "item_net", feature_dropout(generator, raw, self.drop))
        cl = self.cl_rate * info_nce(v1[lo:lo + n], v2, self.tau, group=grp)
        return rec + cl + l2_reg_loss(self.reg, u_emb, keys[lo:lo + n], group=grp), state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self.towers(params, torch.arange(graph.n_users, device=graph.device),
                               torch.arange(graph.n_items, device=graph.device))
