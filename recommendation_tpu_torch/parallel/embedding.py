"""Row-sharded embedding lookup (counterpart of
``recommendation_tpu/parallel/embedding.py``).

Each model rank holds ``rows / model`` rows of a table. A lookup of ids
that every rank holds masks the ids to the rank's row range, gathers
locally (rows out of range become 0) and sums the partial rows over the
model group: one all-reduce SUM, after which every rank holds the full
rows. The JAX package's GSPMD path has no counterpart: a rank of the port
computes only what it is told to.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.ops.group import all_reduce
from recommendation_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_rank


def sharded_embedding_lookup(local_table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Rows ``ids`` of a table row-sharded over the model axis.

    ``local_table`` f32 [rows, d], this model rank's rows (the table's rows
    divide by the axis: pad them with ``pad_rows_to``); ``ids`` int [B], the
    same on every rank. Returns f32 [B, d], the same on every rank."""
    rows = local_table.shape[0]
    local = ids.long() - axis_rank(mesh, MODEL_AXIS) * rows
    in_range = (local >= 0) & (local < rows)
    safe = torch.clamp(local, 0, rows - 1)
    part = local_table[safe] * in_range[:, None].to(local_table.dtype)
    return all_reduce(part, axis_group(mesh, MODEL_AXIS))


def pad_rows_to(table: torch.Tensor, multiple: int) -> torch.Tensor:
    """``table`` with zero rows appended up to a multiple of ``multiple``."""
    pad = (-table.shape[0]) % multiple
    if pad == 0:
        return table
    return torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])
