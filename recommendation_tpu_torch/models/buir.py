"""BUIR-NB: BYOL for recommendation, with online and target LightGCN
encoders (counterpart of ``recommendation_tpu/models/buir.py``;
`univariate/buir.py:177-340`).

Both encoders propagate over ``norm_adj`` with its edges dropped at a
per-forward rate ``U(0,1)·BUIR.drop_rate`` and the kept values scaled by
1 / max(1 - rate, 1e-8) (`buir.py:300-309,330`): one draw of the rate and
of the keep mask per encoder (``edge_dropout_draw``), the values swapped in
by ``with_vals``. The target encoder runs under ``no_grad``; its tables are
carried state (``t_user_emb``, ``t_item_emb``, copies of the online tables
at init), and ``post_step`` moves the batch's rows toward the online ones
by EMA (`buir.py:251-257`, row-wise). The loss is the symmetric 2 - 2·cos
with a linear predictor on the online side. Config: ``BUIR.tau``
(momentum, 0.995), ``BUIR.n_layer`` (2), ``BUIR.drop_rate`` (0.2).

The encoder is ``lightgcn_propagate_square``: on the dense backend L
products with the (U+I)² matrix (``torch.matmul``, as the JAX package
leaves them to XLA), on the bucketed backend the row-space chain on P1's
value path (refreshed values carry no separable scales), K7 both ways.
Ranking uses SelfCF's width-2d dual-score tables. ``PlainBucketedBUIR``
swaps the bucketed chain's kernels for their plain versions.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.bucketed import bucketed_chain_mean_plain
from recommendation_tpu_torch.graph.device import with_vals
from recommendation_tpu_torch.losses import buir_loss
from recommendation_tpu_torch.models.base import Model, linear
from recommendation_tpu_torch.models.lightgcn import lightgcn_propagate_square
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.models.selfcf import dual_score_tables
from recommendation_tpu_torch.ops.group import global_batch
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.weights import flatten_tree


def edge_dropout_draw(generator: torch.Generator, n: int, drop_rate: float, device):
    """One encoder's draw: (rate, keep), ``rate`` = U(0,1)·drop_rate (f32,
    0-d) and ``keep`` bool[n] kept with probability 1 - rate."""
    rate = augment.uniform(generator, (), device) * drop_rate
    return rate, augment.keep_draw(generator, (n,), 1.0 - rate, device)


@register("buir")
class BUIR(Model):
    name = "buir"

    def __init__(self, config):
        super().__init__(config)
        self.momentum = float(config.get("BUIR.tau", 0.995))
        self.n_layers = int(config.get("BUIR.n_layer", config.get("n_layers", 2)))
        self.drop_rate = float(config.get("BUIR.drop_rate", 0.2))

    def init(self, generator: torch.Generator, graph):
        d, dev = self.emb_size, graph.device
        user_emb = self._init_table(generator, graph.n_users, d, dev)
        item_emb = self._init_table(generator, graph.n_items, d, dev)
        params = flatten_tree({"user_emb": user_emb, "item_emb": item_emb,
                               "predictor": self._init_linear(generator, d, d, dev)})
        # the target starts as a copy of the online tables (`buir.py:251-255`)
        return params, {"t_user_emb": user_emb.clone(), "t_item_emb": item_emb.clone()}

    def propagate(self, user_emb, item_emb, adj):
        return lightgcn_propagate_square(user_emb, item_emb, adj, self.n_layers)

    def _encode(self, user_emb, item_emb, graph, generator):
        adj = graph.norm_adj
        rate, keep = edge_dropout_draw(generator, adj.vals.shape[0], self.drop_rate,
                                       adj.vals.device)
        vals = torch.where(keep, adj.vals / torch.clamp(1.0 - rate, min=1e-8),
                           torch.zeros_like(adj.vals))
        return self.propagate(user_emb, item_emb, with_vals(adj, vals))

    def loss(self, params, state, batch, graph, generator=None):
        u_on, i_on = self._encode(params["user_emb"], params["item_emb"], graph, generator)
        with torch.no_grad():
            u_tg, i_tg = self._encode(state["t_user_emb"], state["t_item_emb"], graph, generator)
        users, items = batch.users.long(), batch.pos_items.long()
        loss = buir_loss(linear(params, "predictor", take_rows(u_on, users)),
                         take_rows(u_tg, users),
                         linear(params, "predictor", take_rows(i_on, items)),
                         take_rows(i_tg, items), batch.group)
        return loss, state

    def post_step(self, params, state, batch):
        """Row-wise EMA of the target tables over the batch's rows, as new
        tensors: over the global batch's ids, in its order, with the data
        group (the same tables on every rank)."""
        m = self.momentum
        whole, _ = global_batch(batch)
        with torch.no_grad():
            out = {}
            for key, table, ids in (("t_user_emb", params["user_emb"], whole.users),
                                    ("t_item_emb", params["item_emb"], whole.pos_items)):
                ids = ids.long()
                t = state[key]
                out[key] = t.index_copy(0, ids, t[ids] * m + table[ids] * (1.0 - m))
        return out

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            u, i = self.propagate(params["user_emb"], params["item_emb"], graph.norm_adj)
            return dual_score_tables(params, u, i)


class PlainBucketedBUIR(BUIR):
    """BUIR on a bucketed graph with the plain row-space chain
    (``bucketed_chain_mean_plain``) in place of the kernels'. Not
    registered."""

    def propagate(self, user_emb, item_emb, adj):
        mean = bucketed_chain_mean_plain(self.n_layers, adj.compute_dtype, adj.pull,
                                         torch.cat([user_emb, item_emb]))
        n = user_emb.shape[0]
        return mean[:n], mean[n:]
