"""SEPT: socially-aware self-supervised tri-view co-training (counterpart of
``recommendation_tpu/models/sept.py``).

  * full SEPT (``sept``, alias ``sept_social``;
    `univariate/sept_social.py:333-488`): the rec view (LightGCN with a
    per-layer L2 normalization on ``norm_adj``), the friend and sharing
    social views (``SocialDeviceGraph.sept_friend``, ``sept_sharing``), an
    edge-dropped view refreshed per epoch (``aug_keep`` through
    ``normalized_bipartite``), and tri-view pseudo-label co-training: label
    prediction, the top-``ins_cnt`` pseudo positives (``torch.topk``), the
    neighbour-discrimination InfoNCE at τ = 0.1; SSL after a warm-up of
    ``max.epoch · warmup_fraction`` epochs (the 0/1 ``ssl_on`` flag);
  * ``sept_basic`` (`univariate/sept.py:198-260`): the social-free variant,
    the same encoder with the mean readout on a per-epoch edge-dropped
    adjacency, plain BPR.

As in the JAX package, the SSL terms run over every batch occurrence (the
reference restricts them to ``torch.unique(u_idx)``), so shapes stay fixed.
The products go through ``adj_matmul`` on the graph's backend (P1 and K7
each way on the bucketed one, P1 over the views on the segment one).
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.augment import device_generator, edge_keep_mask
from recommendation_tpu_torch.losses import _l2_normalize, bpr_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.diffnet import require_social
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import global_batch, graph_share, reduce_sum
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul


def sept_encoder(emb: torch.Tensor, adj, n_layers: int, readout: str = "sum") -> torch.Tensor:
    """Propagation with a per-layer L2 normalization; the readout over the
    layers, layer 0 included: the SUM for the full social SEPT
    (`sept_social.py:370-377`), the MEAN for the simplified script
    (`sept.py:220-226`)."""
    acc = emb
    for _ in range(n_layers):
        emb = _l2_normalize(adj_matmul(adj, emb))
        acc = acc + emb
    if readout == "mean":
        return acc / (n_layers + 1)
    return acc


def _tables(model: Model, generator: torch.Generator, graph) -> dict:
    return {"user_emb": model._init_table(generator, graph.n_users, model.emb_size, graph.device),
            "item_emb": model._init_table(generator, graph.n_items, model.emb_size, graph.device)}


def _ego(params) -> torch.Tensor:
    return torch.cat([params["user_emb"], params["item_emb"]])


@register("sept")
@register("sept_social")
class SEPT(Model):
    name = "sept"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("SEPT.n_layer", config.get("n_layers", 2)))
        self.ss_rate = float(config.get("SEPT.ss_rate", 0.005))
        self.drop_rate = float(config.get("SEPT.drop_rate", 0.3))
        self.instance_cnt = int(config.get("SEPT.ins_cnt", 10))
        self.warmup_fraction = float(config.get("SEPT.warmup_fraction", 1.0 / 3.0))
        self.max_epoch = int(config.get("max.epoch", 30))
        self.ssl_tau = float(config.get("SEPT.tau", 0.1))

    def init(self, generator: torch.Generator, graph):
        require_social(graph, "sept_friend", "SEPT")
        return _tables(self, generator, graph), {
            "aug_keep": torch.ones_like(graph.edge_valid),
            "ssl_on": torch.zeros((), device=graph.device)}

    def epoch_begin(self, params, state, graph, generator: torch.Generator, epoch: int):
        """After the warm-up: a fresh edge-dropped adjacency mask and SSL on
        (`sept_social.py:425-429`)."""
        if epoch > self.max_epoch * self.warmup_fraction:
            keep = edge_keep_mask(device_generator(generator, graph.device), graph, self.drop_rate)
            return {"aug_keep": keep, "ssl_on": torch.ones((), device=graph.device)}
        return {"aug_keep": torch.ones_like(graph.edge_valid),
                "ssl_on": torch.zeros((), device=graph.device)}

    def _views(self, params, state, graph):
        ego = _ego(params)
        rec = sept_encoder(ego, graph.norm_adj, self.n_layers)
        aug = sept_encoder(ego, graph.normalized_bipartite(state["aug_keep"]), self.n_layers)
        friend = sept_encoder(params["user_emb"], graph.sept_friend, self.n_layers)
        sharing = sept_encoder(params["user_emb"], graph.sept_sharing, self.n_layers)
        nu = graph.n_users
        return rec[:nu], rec[nu:], aug[:nu], friend, sharing

    @staticmethod
    def _label_prediction(emb, aug_users):
        """softmax(norm(emb) @ norm(aug)ᵀ) over the batch users
        (`sept_social.py:394-399`)."""
        return torch.softmax(_l2_normalize(emb) @ _l2_normalize(aug_users).T, dim=1)

    def _neighbor_discrimination(self, positive_idx, emb, aug_users):
        """−Σ log(Σ_pos exp(s/τ) / Σ_all exp(s/τ))  (`sept_social.py:408-420`)."""
        emb_n = _l2_normalize(emb)
        aug_n = _l2_normalize(aug_users)
        pos = torch.einsum("bd,bkd->bk", emb_n, aug_n[positive_idx])
        ttl = emb_n @ aug_n.T
        pos_score = torch.sum(torch.exp(pos / self.ssl_tau), dim=1)
        ttl_score = torch.sum(torch.exp(ttl / self.ssl_tau), dim=1)
        return -torch.sum(torch.log(pos_score / ttl_score + 1e-12))

    def loss(self, params, state, batch, graph, generator=None):
        rec_u, rec_i, aug_u, friend, sharing = self._views(params, state, graph)
        users = batch.users
        # with the data group: BPR over the global batch's rows, the L2 over
        # whole tables every rank's whole (its gradient's share), and each of
        # the rank's users labelled against the global batch's augmented rows
        grp = batch.group
        whole, _ = global_batch(batch)
        rec = bpr_loss(take_rows(rec_u, users), take_rows(rec_i, batch.pos_items),
                       take_rows(rec_i, batch.neg_items), group=grp)
        rec = rec + graph_share(self.reg * (torch.sum(params["user_emb"] ** 2)
                                            + torch.sum(params["item_emb"] ** 2)), grp)

        # tri-view pseudo-label SSL over the batch users
        aug_b = take_rows(aug_u, whole.users)
        f_b, s_b, r_b = (take_rows(t, users) for t in (friend, sharing, rec_u))
        f_prob = self._label_prediction(f_b, aug_b)
        s_prob = self._label_prediction(s_b, aug_b)
        r_prob = self._label_prediction(r_b, aug_b)
        k = min(self.instance_cnt, whole.users.shape[0])

        def pseudo(p1, p2):
            return torch.topk((p1 + p2) / 2.0, k, dim=1).indices

        ssl = reduce_sum(self._neighbor_discrimination(pseudo(s_prob, r_prob), f_b, aug_b)
                        + self._neighbor_discrimination(pseudo(f_prob, r_prob), s_b, aug_b)
                        + self._neighbor_discrimination(pseudo(f_prob, s_prob), r_b, aug_b), grp)
        return rec + state["ssl_on"] * self.ss_rate * ssl, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            rec = sept_encoder(_ego(params), graph.norm_adj, self.n_layers)
            return rec[:graph.n_users], rec[graph.n_users:]


@register("sept_basic")
class SEPTBasic(Model):
    """The social-free `univariate/sept.py` variant: the encoder on a
    per-epoch edge-dropped adjacency, plain BPR + the batch rows' L2."""

    name = "sept_basic"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("SEPT.n_layer", config.get("n_layers", 2)))
        self.drop_rate = float(config.get("SEPT.drop_rate", 0.3))

    def init(self, generator: torch.Generator, graph):
        return _tables(self, generator, graph), {"aug_keep": torch.ones_like(graph.edge_valid)}

    def epoch_begin(self, params, state, graph, generator: torch.Generator, epoch: int):
        return {"aug_keep": edge_keep_mask(device_generator(generator, graph.device), graph,
                                           self.drop_rate)}

    def loss(self, params, state, batch, graph, generator=None):
        adj = graph.normalized_bipartite(state["aug_keep"])
        out = sept_encoder(_ego(params), adj, self.n_layers, readout="mean")
        u, i = out[:graph.n_users], out[graph.n_users:]
        ue, ie, je = (take_rows(u, batch.users), take_rows(i, batch.pos_items),
                      take_rows(i, batch.neg_items))
        # the batch rows' squared norms / 2 (`sept.py:242-243`), over the
        # global batch's rows with the data group
        grp = batch.group
        reg = self.reg * reduce_sum(torch.sum(ue ** 2) + torch.sum(ie ** 2) + torch.sum(je ** 2),
                                   grp) / 2.0
        return bpr_loss(ue, ie, je, group=grp) + reg, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            out = sept_encoder(_ego(params), graph.norm_adj, self.n_layers, readout="mean")
            return out[:graph.n_users], out[graph.n_users:]
