"""Batch row gathers (counterpart of ``recommendation_tpu/ops/rows.py``).

``take_rows(table, idx)`` is ``table[idx]``. The JAX package replaces the
gather's scatter-add backward by a one-hot matmul, a TPU form; the port
keeps plain indexing, whose backward is ``index_put_`` with accumulation
(atomic adds on the card, so the low bits of a gradient row may change
from run to run; the sum is the same f32 sum).
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for integer ``idx`` in ``[0, table.shape[0])``."""
    return table[idx.long()]
