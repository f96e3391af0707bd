"""DirectAU: a LightGCN encoder trained with alignment + γ·uniformity
(counterpart of ``recommendation_tpu/models/directau.py``; `directau.py:196-293`).

The reference script composes ``loss = L(u, pos) − L(u, neg) + reg``
(`directau.py:223-226`); the published algorithm uses positives only. Both
are here through ``DirectAU.neg_composition`` (default True, the script's).
``DirectAU.normalize_adj`` False (the default) propagates over the raw
adjacency, as the script's ``_build_adj`` does (`directau.py:132-141`):
``binarized(norm_adj)``; True over D^-1/2 A D^-1/2. Config:
``DirectAU.gamma`` (1.0), ``DirectAU.n_layers`` (2), ``reg.lambda``.

The encoder is ``lightgcn_propagate_square`` over that adjacency: on the
dense backend L products with the (U+I)² matrix (``torch.matmul``, as the
JAX package leaves them to XLA), on the bucketed backend the row-space
chain (kernels K7 and P1 both ways, P1 on its value path, since refreshed
values carry no separable scales). The binarized adjacency is built once
per graph and kept, where the JAX package rebuilds it inside every
jitted step: the same values. The uniformity term streams from 4096 rows
on (``losses.uniformity_streaming``). ``PlainBucketedDirectAU`` swaps the
bucketed chain's kernels for their plain versions: the reference a kernel
step is held against.
"""

from __future__ import annotations

import weakref

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_chain_mean_plain
from recommendation_tpu_torch.graph.device import binarized
from recommendation_tpu_torch.losses import alignment_loss, l2_reg_loss, uniformity_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.lightgcn import lightgcn_propagate_square
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.group import global_batch, group_rows
from recommendation_tpu_torch.ops.rows import take_rows


@register("directau")
class DirectAU(Model):
    name = "directau"

    def __init__(self, config):
        super().__init__(config)
        self.gamma = float(config.get("DirectAU.gamma", 1.0))
        self.n_layers = int(config.get("DirectAU.n_layers", config.get("n_layers", 2)))
        self.neg_composition = bool(config.get("DirectAU.neg_composition", True))
        self.normalize_adj = bool(config.get("DirectAU.normalize_adj", False))
        self._raw_adj = weakref.WeakKeyDictionary()  # graph -> binarized(graph.norm_adj)

    def init(self, generator: torch.Generator, graph):
        params = {
            "user_emb": self._init_table(generator, graph.n_users, self.emb_size, graph.device),
            "item_emb": self._init_table(generator, graph.n_items, self.emb_size, graph.device),
        }
        return params, {}

    def _au(self, u, i, keys_u, keys_i, group=None):
        """align(u, i) + γ·(uniform + uniform)/2 over the global batch: with
        the data ``group`` the rank's rows ``u``, ``i`` align, and the
        uniformity pairs each of them with the global batch's rows
        ``keys_u``, ``keys_i`` (``u``, ``i`` themselves with no group)."""
        align = alignment_loss(u, i, group)
        uniform = self.gamma * (uniformity_loss(keys_u, group=group)
                                + uniformity_loss(keys_i, group=group)) / 2.0
        return align + uniform

    def _adj(self, graph):
        if self.normalize_adj:
            return graph.norm_adj
        if graph not in self._raw_adj:
            self._raw_adj[graph] = binarized(graph.norm_adj)
        return self._raw_adj[graph]

    def propagate(self, params, graph):
        return lightgcn_propagate_square(params["user_emb"], params["item_emb"],
                                         self._adj(graph), self.n_layers)

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self.propagate(params, graph)
        u = take_rows(user_all, batch.users)
        pos = take_rows(item_all, batch.pos_items)
        neg = take_rows(item_all, batch.neg_items)
        grp = batch.group
        whole, _ = global_batch(batch)
        keys = (u, pos, neg) if grp is None else (
            take_rows(user_all, whole.users), take_rows(item_all, whole.pos_items),
            take_rows(item_all, whole.neg_items))
        loss = self._au(u, pos, keys[0], keys[1], grp)
        if self.neg_composition:
            loss = loss - self._au(u, neg, keys[0], keys[2], grp)
        b = group_rows(batch.users.shape[0], grp)
        return loss + l2_reg_loss(self.reg, u, pos, neg, group=grp) / b, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self.propagate(params, graph)


class PlainBucketedDirectAU(DirectAU):
    """DirectAU on a bucketed graph with the plain row-space chain
    (``bucketed_chain_mean_plain`` over its adjacency, autograd through
    torch ops) in place of the kernels' chain. Not registered."""

    def propagate(self, params, graph):
        adj = self._adj(graph)
        ego = torch.cat([params["user_emb"], params["item_emb"]])
        mean = bucketed_chain_mean_plain(self.n_layers, adj.compute_dtype, adj.pull, ego)
        return mean[:graph.n_users], mean[graph.n_users:]
