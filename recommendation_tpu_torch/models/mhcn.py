"""MHCN: multi-channel hypergraph convolutional network (counterpart of
``recommendation_tpu/models/mhcn.py``; `univariate/mhcn.py:316-555`).

Three hypergraph channels (social H_s, joint H_j, purchase H_p, from the
ten triangular motifs: ``SocialDeviceGraph.mhcn_hs``, ``mhcn_hj``,
``mhcn_hp``) and a "simple" user channel through R·V; a self-gate per
channel; the channel attention, a softmax over the channel axis; the item
convolution through Rᵀ·mixed (``interaction_norm.transpose()``: on the
bucketed backend the same tables with their roles swapped, on the segment
one the same views). Loss: BPR + ``ss_rate`` × the hierarchical MIM SSL per
channel (`mhcn.py:480-505`, ``losses.hierarchical_mim_loss``, its
permutations drawn on the device) + L2 over every parameter as
``sqrt(Σp² + 1e-12)`` (the zero-initialized gate biases keep a finite
gradient).
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.losses import _l2_normalize, bpr_loss, hierarchical_mim_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.diffnet import require_social
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import graph_share
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.weights import flatten_tree


@register("mhcn")
class MHCN(Model):
    name = "mhcn"
    N_CHANNELS = 4

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("MHCN.n_layer", config.get("n_layers", 2)))
        self.ss_rate = float(config.get("MHCN.ss_rate", 0.01))

    def init(self, generator: torch.Generator, graph):
        require_social(graph, "mhcn_hs", "MHCN")
        d, dev = self.emb_size, graph.device

        def table(n, m):
            return self._init_table(generator, n, m, dev)

        params = {"user_emb": table(graph.n_users, d), "item_emb": table(graph.n_items, d),
                  "attention": table(1, d), "attention_mat": table(d, d)}
        gating_w = [table(d, d) for _ in range(self.N_CHANNELS)]
        sgating_w = [table(d, d) for _ in range(self.N_CHANNELS)]

        def zeros():
            return [torch.zeros((1, d), device=dev) for _ in range(self.N_CHANNELS)]

        params.update(gating_w=gating_w, gating_b=zeros(), sgating_w=sgating_w,
                      sgating_b=zeros())
        return flatten_tree(params), {}

    @staticmethod
    def _gate(params, em, c, supervised=False):
        prefix = "sgating" if supervised else "gating"
        return em * torch.sigmoid(em @ params[f"{prefix}_w.{c}"] + params[f"{prefix}_b.{c}"])

    @staticmethod
    def _channel_attention(params, *channels):
        weights = torch.stack([torch.sum(params["attention"] * (c @ params["attention_mat"]),
                                         dim=1) for c in channels])  # [C, n_users]
        score = torch.softmax(weights, dim=0)
        mixed = score[0][:, None] * channels[0]
        for i in range(1, len(channels)):
            mixed = mixed + score[i][:, None] * channels[i]
        return mixed

    def _forward(self, params, graph):
        u1, u2, u3, simple = (self._gate(params, params["user_emb"], c) for c in range(4))
        item = params["item_emb"]
        acc1, acc2, acc3, acc_s, acc_i = u1, u2, u3, simple, item
        for _ in range(self.n_layers):
            mixed = self._channel_attention(params, u1, u2, u3) + simple / 2.0
            u1 = adj_matmul(graph.mhcn_hs, u1)
            acc1 = acc1 + _l2_normalize(u1)
            u2 = adj_matmul(graph.mhcn_hj, u2)
            acc2 = acc2 + _l2_normalize(u2)
            u3 = adj_matmul(graph.mhcn_hp, u3)
            acc3 = acc3 + _l2_normalize(u3)
            new_item = adj_matmul(graph.interaction_norm.transpose(), mixed)
            acc_i = acc_i + _l2_normalize(new_item)
            simple = adj_matmul(graph.interaction_norm, item)
            acc_s = acc_s + _l2_normalize(simple)
            item = new_item
        final_user = self._channel_attention(params, acc1, acc2, acc3) + acc_s / 2.0
        return final_user, acc_i

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self._forward(params, graph)
        # with the data group: BPR over the global batch's rows; the L2 and
        # the MIMs read no batch row (the MIMs shuffle all users), so each
        # rank computes them whole and takes its share of their gradient
        grp = batch.group
        rec = bpr_loss(take_rows(user_all, batch.users), take_rows(item_all, batch.pos_items),
                       take_rows(item_all, batch.neg_items), group=grp)
        # L2 over ALL parameters, unsquared norms (`mhcn.py:522-525`), in the
        # JAX package's leaf order (its tree flattening sorts the dict keys)
        reg = self.reg * sum(torch.sqrt(torch.sum(params[k] ** 2) + 1e-12)
                             for k in sorted(params))
        ss = 0.0
        for c, adj in enumerate((graph.mhcn_hs, graph.mhcn_hj, graph.mhcn_hp)):
            gated = self._gate(params, user_all, c, supervised=True)
            ss = ss + hierarchical_mim_loss(generator, gated, adj_matmul(adj, gated))
        return rec + graph_share(reg, grp) + graph_share(self.ss_rate * ss, grp), state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self._forward(params, graph)
