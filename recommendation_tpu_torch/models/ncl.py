"""NCL — Neighborhood-enriched Contrastive Learning (counterpart of
``recommendation_tpu/models/ncl.py``).

A LightGCN encoder whose loss adds to BPR on the layer mean (`ncl.py:282-422`):
  * the structure-contrastive InfoNCE between layer ``2·hyper_layers`` and
    layer 0, with full-catalog denominators, summed over the batch
    (`ncl.py:358-367`);
  * ProtoNCE against k-means clusters of the mean embeddings
    (`ncl.py:369-375`), ``info_nce`` × B.

On the dense backend the forward is ``ops.prop.ChainMeanLayer`` (kernels K3
forward, K4 backward on the card), which returns the mean and the context
layer in one chain; with a context index of 0 the context is layer 0 and the
chain is LightGCN's (``ChainMean``). On the bucketed and the segment
backends it is the JAX package's fallback: L ``adj_matmul`` rounds over ``norm_adj``
(``lightgcn_propagate_square(return_layers=True)``: each a P1 pull, with a
K7 reorder on the bucketed backend, and the same through the transpose in
the backward), the mean of
the L + 1 layers, and the context layer from the list. Both denominators go
through ``ops.lse.CatalogLSE`` (K5 forward, K6 backward). The E-step runs the
mean under ``no_grad`` through ``chain_mean`` (K1) on the dense backend, the
square path (``eval_embeddings``) on the others, and clusters it with
``ops/kmeans.py``: once every
``NCL.e_step_cadence`` epochs (always at epoch 0), or inside every loss with
``NCL.e_step_cadence='batch'``, on detached embeddings. Every random draw of
an E-step comes from ``cluster_draws`` (the init rows, and the mini-batch
rows past ``NCL.kmeans_minibatch_above``); ``e_step`` takes them as an
argument, so a test hands it the JAX package's indices.

The cluster state holds ``user_centroids`` f32[ku, d], ``user_2cluster``
i32[U], ``item_centroids`` f32[ki, d] and ``item_2cluster`` i32[I], as the
JAX package's.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.losses import _l2_normalize as _l2n
from recommendation_tpu_torch.losses import bpr_loss, info_nce, l2_reg_loss
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.lightgcn import (
    lightgcn_propagate,
    lightgcn_propagate_square,
)
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.kmeans import (
    kmeans,
    kmeans_batches,
    kmeans_init,
    kmeans_minibatch,
)
from recommendation_tpu_torch.ops.lse import CatalogLSE
from recommendation_tpu_torch.ops.prop import ChainMeanLayer, chain_mean
from recommendation_tpu_torch.ops.rows import take_rows


@register("ncl")
class NCL(Model):
    name = "ncl"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("NCL.n_layers", 3))
        self.ssl_temp = float(config.get("NCL.tau", 0.1))
        # 1e-8 and 1e-7: the JAX package's defaults (its ncl.py says why)
        self.ssl_reg = float(config.get("NCL.ssl_reg", 1e-8))
        self.proto_reg = float(config.get("NCL.proto_reg", 1e-7))
        self.hyper_layers = int(config.get("NCL.hyper_layers", 1))
        self.alpha = float(config.get("NCL.alpha", 1.0))
        self.num_clusters = int(config.get("NCL.num_clusters", 100))
        self.kmeans_iters = int(config.get("NCL.kmeans_iters", 10))
        # an int: re-cluster every N epochs; "batch": inside every loss
        cad = config.get("NCL.e_step_cadence", 1)
        self.e_step_per_batch = str(cad).lower() == "batch"
        self.e_step_cadence = 1 if self.e_step_per_batch else int(cad)
        # tables past this row count cluster with mini-batch k-means; 0
        # forces mini-batch everywhere, -1 full Lloyd everywhere
        self.kmeans_minibatch_above = int(config.get("NCL.kmeans_minibatch_above", 131_072))
        self.kmeans_batch = int(config.get("NCL.kmeans_batch", 65_536))

    def _k_for(self, n: int) -> int:
        """k capped at max(2, n//39) (`ncl.py:350-351`)."""
        return min(self.num_clusters, max(2, n // 39))

    def init(self, generator: torch.Generator, graph):
        params = {
            "user_emb": self._init_table(generator, graph.n_users, self.emb_size, graph.device),
            "item_emb": self._init_table(generator, graph.n_items, self.emb_size, graph.device),
        }
        dev = graph.device
        state = {
            "user_centroids": torch.zeros(self._k_for(graph.n_users), self.emb_size, device=dev),
            "user_2cluster": torch.zeros(graph.n_users, dtype=torch.int32, device=dev),
            "item_centroids": torch.zeros(self._k_for(graph.n_items), self.emb_size, device=dev),
            "item_2cluster": torch.zeros(graph.n_items, dtype=torch.int32, device=dev),
        }
        return params, state

    # -- the chain and the denominators (the kernels' entry points) ------------

    def _chain_layer(self, r, u0, i0, k):
        """(mean_u, mean_i, u_k, i_k) through K3/K4."""
        return ChainMeanLayer.apply(r, u0.contiguous(), i0.contiguous(), self.n_layers, k)

    def _catalog_lse(self, q, x):
        """logsumexp(q·xᵀ/τ) over the whole catalog through K5/K6."""
        return CatalogLSE.apply(q, x, self.ssl_temp)

    def _forward_ctx(self, params, graph):
        """(user_all, item_all, (u0, i0), (u_k, i_k)) with k = the context
        index min(2·hyper_layers, L): what ``loss`` consumes."""
        u0, i0 = params["user_emb"], params["item_emb"]
        ctx_idx = min(self.hyper_layers * 2, self.n_layers)
        if graph.backend != "dense":
            au, ai, layers = lightgcn_propagate_square(u0, i0, graph.norm_adj, self.n_layers,
                                                       return_layers=True)
            ctx = layers[ctx_idx]
            return au, ai, (u0, i0), (ctx[:graph.n_users], ctx[graph.n_users:])
        r = graph.propagation_matrix
        if ctx_idx >= 1:
            au, ai, uk, ik = self._chain_layer(r, u0, i0, ctx_idx)
            return au, ai, (u0, i0), (uk, ik)
        au, ai = lightgcn_propagate(u0, i0, r, self.n_layers)
        return au, ai, (u0, i0), (u0, i0)

    # -- E-step -----------------------------------------------------------------

    def cluster_draws(self, generator: torch.Generator, graph) -> dict:
        """The random rows of one E-step, users' then items': the k initial
        rows of each, and the per-iteration rows where the table takes
        mini-batch k-means."""
        draws = {}
        for side, n in (("user", graph.n_users), ("item", graph.n_items)):
            init = kmeans_init(generator, n, self._k_for(n))
            batch = None
            if 0 <= self.kmeans_minibatch_above < n:
                batch = kmeans_batches(generator, n, self.kmeans_iters, min(self.kmeans_batch, n))
            draws[side] = (init, batch)
        return draws

    def _cluster(self, x, init_idx, batch_idx):
        """Full Lloyd for small tables, mini-batch k-means past the threshold."""
        if batch_idx is not None:
            return kmeans_minibatch(x, init_idx, batch_idx, self.kmeans_iters)
        return kmeans(x, init_idx, self.kmeans_iters)

    def e_step(self, user_all, item_all, draws) -> dict:
        """The cluster state of the (detached) mean embeddings."""
        uc, ua = self._cluster(user_all, *draws["user"])
        ic, ia = self._cluster(item_all, *draws["item"])
        return {"user_centroids": uc, "user_2cluster": ua,
                "item_centroids": ic, "item_2cluster": ia}

    def epoch_begin(self, params, state, graph, generator: torch.Generator, epoch: int):
        """E-step on the mean embeddings (`ncl.py:340-356`) every
        ``e_step_cadence`` epochs, always at epoch 0; in per-batch mode the
        E-step lives in ``loss`` instead."""
        if self.e_step_per_batch:
            return state
        if epoch % max(1, self.e_step_cadence) != 0 and epoch > 0:
            return state
        with torch.no_grad():
            if graph.backend != "dense":
                user_all, item_all = self.eval_embeddings(params, state, graph)
            else:
                user_all, item_all = chain_mean(graph.propagation_matrix,
                                                params["user_emb"].detach().contiguous(),
                                                params["item_emb"].detach().contiguous(),
                                                self.n_layers)
        return self.e_step(user_all, item_all, self.cluster_draws(generator, graph))

    # -- loss -------------------------------------------------------------------

    def _ssl_layer_loss(self, context, initial, users, items):
        """Layer-contrast InfoNCE with full-catalog denominators, summed over
        the batch (`ncl.py:358-367`)."""
        (cu, ci), (iu, ii) = context, initial
        n_cu, n_iu = _l2n(take_rows(cu, users)), _l2n(take_rows(iu, users))
        n_ci, n_ii = _l2n(take_rows(ci, items)), _l2n(take_rows(ii, items))
        pos_u = torch.sum(n_cu * n_iu, dim=1) / self.ssl_temp
        loss_u = -torch.sum(pos_u - self._catalog_lse(n_cu, _l2n(iu)))
        pos_i = torch.sum(n_ci * n_ii, dim=1) / self.ssl_temp
        loss_i = -torch.sum(pos_i - self._catalog_lse(n_ci, _l2n(ii)))
        return self.ssl_reg * (loss_u + self.alpha * loss_i)

    def _proto_nce(self, state, initial, users, items, batch_size):
        """InfoNCE against the assigned centroids, × B (`ncl.py:369-375`)."""
        user_emb, item_emb = initial
        u2c = take_rows(state["user_centroids"], take_rows(state["user_2cluster"], users))
        i2c = take_rows(state["item_centroids"], take_rows(state["item_2cluster"], items))
        loss_u = info_nce(take_rows(user_emb, users), u2c, self.ssl_temp) * batch_size
        loss_i = info_nce(take_rows(item_emb, items), i2c, self.ssl_temp) * batch_size
        return self.proto_reg * (loss_u + loss_i)

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all, initial, context = self._forward_ctx(params, graph)
        users, pos, neg = batch.users, batch.pos_items, batch.neg_items
        u = take_rows(user_all, users)
        p, n = take_rows(item_all, pos), take_rows(item_all, neg)
        rec = bpr_loss(u, p, n)
        ssl = self._ssl_layer_loss(context, initial, users, pos)
        if self.e_step_per_batch:
            # re-cluster the current embeddings before ProtoNCE (`ncl.py:324`);
            # the centroids are data, so no gradient reaches them
            if generator is None:
                raise ValueError("NCL.e_step_cadence='batch' draws each E-step from the "
                                 "loss's generator; pass one")
            state = self.e_step(user_all.detach(), item_all.detach(),
                                self.cluster_draws(generator, graph))
        b = users.shape[0]
        proto = self._proto_nce(state, initial, users, pos, b)
        reg = l2_reg_loss(self.reg, u, p, n) / b
        return rec + reg + ssl + proto, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            if graph.backend != "dense":
                return lightgcn_propagate_square(params["user_emb"], params["item_emb"],
                                                 graph.norm_adj, self.n_layers)
            return lightgcn_propagate(params["user_emb"], params["item_emb"],
                                      graph.propagation_matrix, self.n_layers)
