"""ESRF: adversarial social refinement, a generator and a discriminator
(counterpart of ``recommendation_tpu/models/esrf.py``;
`univariate/esrf.py:1011-1378`).

The generator proposes K alternative neighbours for a random segment of
``ESRF.segment`` users (`esrf.py:1127-1149`) by a gumbel-softmax over the
motif-propagated user similarity (``SocialDeviceGraph.esrf_motif``). The
discriminator is a social-aware LightGCN (`esrf.py:1151-1192`), with the
reference's quirk: with social on, propagation is REPLACED by user +
alt·users / K on the user rows (`esrf.py:1184-1192`). Three phases by
thirds of the epochs (`esrf.py:1220-1359`): BPR pretraining, social
training with the generator frozen, the adversarial min-max.

The phase rides the model state as a Python int that ``epoch_begin`` sets
(the JAX package's ``lax.switch`` on a device scalar becomes a branch), so
no step reads the device; a checkpoint carries it, and the trainer's
captured epoch (``train/graphed.py``) keeps one graph per phase, keyed by
the state's host values. In phase 2
``ESRF.alternating_updates`` (default True) keeps the reference's
stop-gradient placement: the D objective flows through the friend
embeddings, the G objective through the whole discriminator forward with
the D parameters detached (both gradients taken at the pre-update point,
as the reference's two optimizer steps take them); False detaches D's
outputs in the G objective instead. ``make_optimizer`` is one Adam with two
parameter groups: ``d.*`` at the learning rate, ``g.*`` at five times it
(the JAX package's ``optax.multi_transform``); on the card it is
``capturable``, its two rates device tensors (``train.loop.tensor_rates``),
so a captured update reads them. Draws, both from the step's generator: the segment
start (``augment.randint``, a device scalar: the segment's rows are read
and written at that offset, the JAX function's ``randint`` and
``dynamic_slice_in_dim``), then the gumbel noise (``augment.uniform``).
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.losses import _l2_normalize, batch_sum
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.diffnet import randn_table, require_social, summed_bpr
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.train.loop import tensor_rates
from recommendation_tpu_torch.weights import flatten_tree, subtree


def gumbel_softmax(generator: torch.Generator, logits: torch.Tensor, temperature: float = 0.2,
                   eps: float = 1e-10) -> torch.Tensor:
    u = augment.uniform(generator, logits.shape, logits.device)
    g = -torch.log(-torch.log(u + eps) + eps)
    y = torch.log(torch.clamp(logits, min=0.0) + eps) + g
    return torch.softmax(y / temperature, dim=-1)


@register("esrf")
class ESRF(Model):
    name = "esrf"

    def __init__(self, config):
        super().__init__(config)
        self.K = int(config.get("ESRF.K", 10))
        self.beta = float(config.get("ESRF.beta", 0.1))
        self.n_layers_g = int(config.get("ESRF.n_layers_G", 2))
        self.n_layers_d = int(config.get("ESRF.n_layer", config.get("n_layers", 2)))
        self.n_layers = self.n_layers_d
        self.segment = int(config.get("ESRF.segment", 100))
        self.max_epoch = int(config.get("max.epoch", 30))
        self.reg_u = float(config.get("reg.lambda", 1e-4))
        self.alternating = bool(config.get("ESRF.alternating_updates", True))

    def make_optimizer(self, config, params):
        lr = float(config.get("learning.rate", 1e-3))
        groups = [{"params": [p for k, p in params.items() if k.startswith(f"{part}.")],
                   "lr": rate} for part, rate in (("d", lr), ("g", 5.0 * lr))]
        cuda = next(iter(params.values())).is_cuda
        opt = torch.optim.Adam(groups, lr=lr, eps=1e-8, capturable=cuda)
        return tensor_rates(opt) if cuda else opt

    def init(self, generator: torch.Generator, graph):
        require_social(graph, "esrf_motif", "ESRF")
        d, dev, nu = self.emb_size, graph.device, graph.n_users
        return flatten_tree({
            "d": {"user_emb": randn_table(generator, nu, d, 0.01, dev),
                  "item_emb": randn_table(generator, graph.n_items, d, 0.01, dev)},
            "g": {"relation_emb": randn_table(generator, nu, d, 0.005, dev),
                  "c_selector": randn_table(generator, self.K, nu, 0.005, dev)},
        }), {"phase": 0}

    def phase_of(self, epoch: int) -> int:
        third = max(1, self.max_epoch // 3)
        return min(epoch // third, 2)

    def epoch_begin(self, params, state, graph, generator: torch.Generator, epoch: int):
        return {"phase": self.phase_of(epoch)}

    # -- generator ------------------------------------------------------------

    def _generator(self, g_params, graph, generator: torch.Generator):
        """The alternative neighbourhood of a random user segment
        (`esrf.py:1137-1160`): [U, U], zero outside the segment's rows. The
        segment's ``seg`` rows start at a device offset: read and written
        through their indices, so no step reads the start on the host."""
        emb = g_params["relation_emb"]
        acc = cur = emb
        for _ in range(self.n_layers_g):
            cur = adj_matmul(graph.esrf_motif, cur)
            acc = acc + _l2_normalize(cur)
        user_embeddings = acc / (self.n_layers_g + 1)
        n = graph.n_users
        seg = min(self.segment, n)
        start = augment.randint(generator, max(1, n - seg + 1), emb.device)
        rows = start + torch.arange(seg, device=emb.device)
        feats = user_embeddings.index_select(0, rows) @ user_embeddings.T  # [seg, n_users]
        alpha = feats[:, None, :] * g_params["c_selector"][None, :, :]  # [seg, K, n_users]
        multi_hot = torch.sum(gumbel_softmax(generator, alpha), dim=1)  # [seg, n_users]
        return multi_hot.new_zeros((n, n)).index_copy(0, rows, multi_hot)

    # -- discriminator --------------------------------------------------------

    def _discriminator(self, d_params, graph, alt=None):
        """The LightGCN readout over ``norm_adj``, or with ``alt`` (social
        on) the reference's replacement of each layer by user + alt·users/K
        (`esrf.py:1184-1192`)."""
        nu = graph.n_users
        ego = torch.cat([d_params["user_emb"], d_params["item_emb"]])
        acc = ego
        for _ in range(self.n_layers_d):
            if alt is not None:
                users = ego[:nu]
                ego = torch.cat([users + (alt @ users) / self.K, ego[nu:]])
            else:
                ego = adj_matmul(graph.norm_adj, ego)
            acc = acc + _l2_normalize(ego)
        return acc[:nu], acc[nu:]

    # -- losses ---------------------------------------------------------------

    def _rows(self, ue, ie, batch):
        return (take_rows(ue, batch.users), take_rows(ie, batch.pos_items),
                take_rows(ie, batch.neg_items))

    def loss(self, params, state, batch, graph, generator=None):
        d_params, g_params = subtree(params, "d"), subtree(params, "g")
        phase = int(state["phase"])
        # the data group: every term is a sum over the batch's rows, the
        # generator's segment draw is graph-wide (the same on every rank)
        grp = batch.group
        if phase < 2:
            # before the adversarial phase the generator's parameters enter at
            # weight 0: they take the zero gradient jax.grad gives them, and
            # Adam steps them as optax does (the step loop differentiates
            # every parameter it trains)
            untouched = 0.0 * sum(torch.sum(p) for p in g_params.values())
        if phase == 0:
            return untouched + summed_bpr(
                self.reg_u, *self._rows(*self._discriminator(d_params, graph), batch),
                grp), state
        if phase == 1:
            with torch.no_grad():
                alt = self._generator(g_params, graph, generator)
            return untouched + summed_bpr(
                self.reg_u, *self._rows(*self._discriminator(d_params, graph, alt), batch),
                grp), state
        alt = self._generator(g_params, graph, generator)
        alt_stop = alt.detach()
        # D objective: alt frozen
        ue, ie = self._discriminator(d_params, graph, alt_stop)
        u, pos, neg = self._rows(ue, ie, batch)
        y_ui = torch.sum(u * pos, dim=1)
        friends = (alt_stop[batch.users.long()] @ ue) / self.K
        if not self.alternating:
            friends = friends.detach()
        y_vi_d = torch.sum(friends * pos, dim=1)
        d_loss = summed_bpr(self.reg_u, u, pos, neg, grp) + self.beta * (
            -batch_sum(torch.log(torch.sigmoid(y_ui - y_vi_d) + 1e-10), grp))
        if self.alternating:
            # the G objective through the whole discriminator forward, the D
            # parameters detached (`esrf.py:1310-1314`)
            ue_g, ie_g = self._discriminator({k: v.detach() for k, v in d_params.items()},
                                             graph, alt)
            u_g, pos_g = take_rows(ue_g, batch.users), take_rows(ie_g, batch.pos_items)
            y_ui_g = torch.sum(u_g * pos_g, dim=1)
            y_vi_g = torch.sum((alt[batch.users.long()] @ ue_g) / self.K * pos_g, dim=1)
        else:
            # D's outputs frozen: only the direct alt path reaches G
            y_ui_g = y_ui.detach()
            friends_g = (alt[batch.users.long()] @ ue.detach()) / self.K
            y_vi_g = torch.sum(friends_g * pos.detach(), dim=1)
        g_loss = self.beta * (-batch_sum(torch.log(torch.sigmoid(y_vi_g - y_ui_g) + 1e-10), grp))
        return d_loss + g_loss, state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            return self._discriminator(subtree(params, "d"), graph)
