"""DiffNet: social influence diffusion (counterpart of
``recommendation_tpu/models/diffnet.py``; `univariate/diffnet.py:1050-1144`).

Per diffusion layer ``u ← ReLU([S·u ‖ u] · W_k)`` with S the row-normalized
trust matrix (``SocialDeviceGraph.social_adj``, `diffnet.py:1070-1077,
1124-1132`); the final user embedding adds the normalized interaction
aggregation ``R̂·V`` (``interaction_norm``). Items score against the raw
item table. Loss: the summed BPR (−Σ log σ(y_ui − y_uj)) plus regU times
the unsquared norms (`diffnet.py:1110-1117`). The products go through
``adj_matmul`` on the graph's backend: ``torch.matmul`` on the dense one,
P1 and K7 each way on the bucketed one, P1 over the row-sorted views on the
segment one.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.losses import batch_sum, safe_frobenius_norm
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.weights import flatten_tree


def require_social(graph, attr: str, model: str) -> None:
    if not hasattr(graph, attr):
        raise ValueError(f"{model} requires a SocialDeviceGraph (social side data)")


def randn_table(generator: torch.Generator, n: int, d: int, scale: float, device) -> torch.Tensor:
    """``scale`` × N(0, 1) [n, d], drawn on the CPU from ``generator`` and
    then moved (the reference's ``randn * scale`` init)."""
    return (scale * torch.randn(n, d, generator=generator)).to(device)


def summed_bpr(reg: float, u: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
               group=None) -> torch.Tensor:
    """−Σ log(σ(y_ui − y_uj) + 1e-10) + reg · (‖u‖ + ‖pos‖ + ‖neg‖), the
    norms unsquared (DiffNet's and ESRF's loss); over the global batch's
    rows with the data ``group``."""
    y = torch.sum(u * pos, dim=1) - torch.sum(u * neg, dim=1)
    pairwise = -batch_sum(torch.log(torch.sigmoid(y) + 1e-10), group)
    return pairwise + reg * (safe_frobenius_norm(u, group) + safe_frobenius_norm(pos, group)
                             + safe_frobenius_norm(neg, group))


@register("diffnet")
class DiffNet(Model):
    name = "diffnet"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("DiffNet.n_layer", config.get("n_layers", 2)))
        self.reg_u = float(config.get("DiffNet.reg_lambda", config.get("reg.lambda", 1e-4)))

    def init(self, generator: torch.Generator, graph):
        require_social(graph, "social_adj", "DiffNet")
        d, dev = self.emb_size, graph.device
        return flatten_tree({
            # randn * 0.005 init (`diffnet.py:1066-1067`)
            "user_emb": randn_table(generator, graph.n_users, d, 0.005, dev),
            "item_emb": randn_table(generator, graph.n_items, d, 0.005, dev),
            "weights": [self._init_table(generator, 2 * d, d, dev) for _ in range(self.n_layers)],
        }), {}

    def _forward(self, params, graph):
        u = params["user_emb"]
        for k in range(self.n_layers):
            diffused = adj_matmul(graph.social_adj, u)
            u = torch.relu(torch.cat([diffused, u], dim=1) @ params[f"weights.{k}"])
        return u + adj_matmul(graph.interaction_norm, params["item_emb"]), params["item_emb"]

    def loss(self, params, state, batch, graph, generator=None):
        user_all, item_all = self._forward(params, graph)
        u = take_rows(user_all, batch.users)
        pos = take_rows(item_all, batch.pos_items)
        neg = take_rows(item_all, batch.neg_items)
        return summed_bpr(self.reg_u, u, pos, neg, batch.group), state

    def eval_embeddings(self, params, state, graph):
        with torch.no_grad():
            user_all, item_all = self._forward(params, graph)
        return user_all, item_all.detach()
