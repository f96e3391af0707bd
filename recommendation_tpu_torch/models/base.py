"""Model protocol (counterpart of ``recommendation_tpu/models/base.py``).

A model is a bundle of plain functions over ``params``, a dict of tensors,
and ``state``, explicitly carried non-gradient state. Keeping the JAX
package's shape lets its parameter pytrees carry over name for name
(``weights.params_from_jax``). Random numbers come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any

import torch


class Model:
    """Base model: subclasses override init and eval_embeddings."""

    name: str = "model"

    def __init__(self, config):
        self.config = config
        self.emb_size = int(config.get("embedding.size", 64))

    def init(self, generator: torch.Generator, graph) -> tuple[Any, Any]:
        raise NotImplementedError

    def _init_table(self, generator: torch.Generator, n: int, d: int, device) -> torch.Tensor:
        """xavier_uniform (the reference encoders' initializer,
        `directau.py:282-287`, `selfcf.py:468-473`). Drawn on the CPU from
        ``generator`` and then moved, so a seed gives the same table on every
        device. (The numbers differ from ``jax.random``'s for the same seed.)"""
        limit = math.sqrt(6.0 / (n + d))
        table = torch.empty(n, d, dtype=torch.float32).uniform_(-limit, limit, generator=generator)
        return table.to(device)

    def eval_embeddings(self, params: Any, state: Any, graph) -> tuple[torch.Tensor, torch.Tensor]:
        """(user_emb, item_emb) used for ranking."""
        raise NotImplementedError
