"""Sparse propagation ``adj @ x`` (counterpart of
``recommendation_tpu/ops/spmm.py::adj_matmul``).

Two branches: the bucketed one, ``bucketed_matmul``, gather-only in both
passes (kernels P1 and K7, ``graph/bucketed.py``), and the dense one, a
product with the materialized (U+I)² matrix, which the JAX package leaves
to XLA and the port to ``torch.matmul``: in the bf16 regime both operands
are rounded to bf16 and the products are summed in f32, as the JAX
package's ``preferred_element_type=f32`` does. The segment and pallas
backends are not ported yet (ROADMAP queue 1, item 10), so those raise.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_matmul
from recommendation_tpu_torch.graph.device import DeviceAdj


def adj_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` (f32 [n_rows, d]) with the adjacency's backend; x is
    [n_cols, d]. The bucketed backward pulls through the prebuilt
    transpose; the dense one is autograd's."""
    if adj.backend == "bucketed" and adj.pull is not None:
        return bucketed_matmul(adj.pull, adj.pull_t, x, adj.compute_dtype)
    if adj.backend == "dense":
        if adj.compute_dtype == "bfloat16":
            # bf16 operands (the matrix rounded once, kept), exact products, f32 sums
            return torch.matmul(adj.dense_operand, x.to(torch.bfloat16).float())
        return torch.matmul(adj.dense, x.float())
    raise NotImplementedError(
        f"adj_matmul on the {adj.backend!r} backend is not ported yet (ROADMAP queue 1, "
        "item 10, 'Segment backend and neighbor models')")
