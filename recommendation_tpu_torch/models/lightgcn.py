"""LightGCN: K-layer normalized propagation + layer-mean readout.

Counterpart of ``recommendation_tpu/models/lightgcn.py`` for serving: the
bipartite dense branch of ``lightgcn_propagate`` (``return_layers=False``)
in the f32 and the bf16 regime, and ``LightGCN.init/propagate/
eval_embeddings``. The loss belongs to the training slice.

The layer chain always goes through ``ops.prop.chain_mean``: the CUDA
kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.models.registry import register
from recommendation_tpu_torch.ops.prop import chain_mean


def lightgcn_propagate(
    user_emb: torch.Tensor, item_emb: torch.Tensor, r_hat: torch.Tensor, n_layers: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """L rounds of Â·E with the mean-of-layers readout (layer 0 included),
    over the bipartite block form Â = [[0, R̂], [R̂ᵀ, 0]].

    ``r_hat`` is R̂ in the compute dtype (``DeviceGraph.propagation_matrix``):
    bf16 rounds the running table to bf16 before each product, f32 keeps
    f32. Accumulation is f32 in both."""
    return chain_mean(r_hat, user_emb.contiguous(), item_emb.contiguous(), n_layers)


@register("lightgcn")
class LightGCN(Model):
    name = "lightgcn"

    def __init__(self, config):
        super().__init__(config)
        self.n_layers = int(config.get("LightGCN.n_layers", config.get("n_layers", 3)))

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

    def eval_embeddings(self, params, state, graph):
        return self.propagate(params, graph)
