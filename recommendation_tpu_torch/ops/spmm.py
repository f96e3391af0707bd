"""Sparse propagation ``adj @ x`` (counterpart of
``recommendation_tpu/ops/spmm.py::adj_matmul``).

The port runs the bucketed branch: ``bucketed_matmul``, gather-only in both
passes (kernels P1 and K7, ``graph/bucketed.py``). Its dense backend
multiplies by R̂ in the layer-chain kernels instead of through a
``DeviceAdj``, and the segment and pallas backends are not ported yet
(ROADMAP queue 1, item 10), so those raise.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.bucketed import bucketed_matmul
from recommendation_tpu_torch.graph.device import DeviceAdj


def adj_matmul(adj: DeviceAdj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` (f32 [n_rows, d]) with the adjacency's backend; x is
    [n_cols, d]. The backward pulls through the prebuilt transpose."""
    if adj.backend == "bucketed" and adj.pull is not None:
        return bucketed_matmul(adj.pull, adj.pull_t, x, adj.compute_dtype)
    raise NotImplementedError(
        f"adj_matmul on the {adj.backend!r} backend is not ported yet (ROADMAP queue 1, "
        "item 10); the port propagates through the bucketed tables or, on the dense "
        "backend, through R̂ in the layer-chain kernels")
