"""Model protocol (counterpart of ``recommendation_tpu/models/base.py``).

A model is a bundle of plain functions over ``params``, a dict of tensors,
and ``state``, explicitly carried non-gradient state. Keeping the JAX
package's shape lets its parameter pytrees carry over name for name
(``weights.params_from_jax``); nested trees (linear layers, layer lists,
BGRL's online and target encoders) are flat dicts of dotted names
(``weights.flatten_tree``). Random numbers come from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any

import torch


def linear(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with the linear layer ``name`` of a flat parameter dict
    (``name.w`` [d_in, d_out], ``name.b`` [d_out])."""
    return x @ params[f"{name}.w"] + params[f"{name}.b"]


class Model:
    """Base model: subclasses override init, loss and eval_embeddings, and
    optionally epoch_begin and post_step."""

    name: str = "model"
    # parameters that take no gradient (GraphSAGE's fixed features): the
    # trainer makes them without ``requires_grad`` and the step loop
    # differentiates only the others, so no optimizer moves them
    frozen: tuple[str, ...] = ()
    # The single-device trainer runs every model's epochs as CUDA graphs
    # (``train/graphed.py``), so a step reads nothing on the host and draws
    # only from the loss's generator (the trainer's one generator on the
    # graph's device, which the graphs register, so every replay draws anew)

    def __init__(self, config):
        self.config = config
        self.emb_size = int(config.get("embedding.size", 64))
        self.reg = float(config.get("reg.lambda", 1e-4))

    # -- parameters -----------------------------------------------------------

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

    def _init_linear(self, generator: torch.Generator, d_in: int, d_out: int, device) -> dict:
        """torch ``nn.Linear``'s default init as the JAX package draws it
        (`models/base.py:60-67`): W [d_in, d_out] and b [d_out] from
        U(-1/√d_in, 1/√d_in), on the CPU from ``generator``, then moved."""
        bound = 1.0 / math.sqrt(d_in)
        w = torch.empty(d_in, d_out, dtype=torch.float32).uniform_(-bound, bound,
                                                                    generator=generator)
        b = torch.empty(d_out, dtype=torch.float32).uniform_(-bound, bound, generator=generator)
        return {"w": w.to(device), "b": b.to(device)}

    # -- training -------------------------------------------------------------

    def make_optimizer(self, config, params):
        """Optional model-specific optimizer over ``params``. None -> the
        trainer's default (``train.loop.make_optimizer``)."""
        return None

    def loss(self, params: Any, state: Any, batch, graph,
             generator: torch.Generator | None = None) -> tuple[torch.Tensor, Any]:
        """Returns (scalar loss, new_state). ``generator`` feeds any draw the
        loss makes (extra negatives); losses that draw nothing ignore it."""
        raise NotImplementedError

    def post_step(self, params: Any, state: Any, batch) -> Any:
        """Non-gradient update after the optimizer step (EMA targets etc.)."""
        return state

    def epoch_begin(self, params: Any, state: Any, graph, generator: torch.Generator,
                    epoch: int) -> Any:
        """Per-epoch state refresh (clustering E-steps, augmented views)."""
        return state

    # -- evaluation -----------------------------------------------------------

    def eval_embeddings(self, params: Any, state: Any, graph) -> tuple[torch.Tensor, torch.Tensor]:
        """(user_emb, item_emb) used for ranking."""
        raise NotImplementedError
