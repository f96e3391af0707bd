"""Device-resident graph state for serving on the dense backend.

The serving subset of ``recommendation_tpu/graph/device.py::DeviceGraph``:
the backend choice, the per-user positives table used to mask train items
out of a top-k, the user degrees, and the dense normalized interaction
block R̂ = D_u^-1/2 R D_i^-1/2 that the LightGCN layer chain multiplies by.
Tables are built on the host with the same numpy code as the JAX package
and uploaded once.

The sampler tables, ``norm_adj_selfloops`` and ``user_pos_mask`` belong to
the training slice. Graphs that ``choose_backend`` sends to the bucketed or
segment backend are not ported yet (ROADMAP queue 1, "Large-graph
backend").
"""

from __future__ import annotations

import numpy as np
import torch

from recommendation_tpu_torch.device import resolve_device

# Graphs whose dense adjacency is at most this many f32 elements use the
# dense backend (the JAX package's threshold, kept so both choose alike).
DENSE_MAX_ELEMENTS = 128 * 1024 * 1024

# Padded per-user positives table cap (i32 elements): 64M = 256 MB.
POS_TABLE_MAX_ELEMENTS = 64 * 1024 * 1024

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def choose_backend(n_rows: int, n_cols: int, requested: str = "auto") -> str:
    if requested != "auto":
        return requested
    return "dense" if n_rows * n_cols <= DENSE_MAX_ELEMENTS else "bucketed"


class DeviceGraph:
    """Serving state derived from an ``Interaction``, on ``device``.

    ``interaction_norm_dense`` is R̂ in f32 [n_users, n_items]; in the
    bfloat16 regime ``interaction_norm_bf16`` holds it once more, cast to
    bf16 (round to nearest even, as the JAX chain's ``astype``).
    ``propagation_matrix`` is the one the layer chain multiplies by."""

    def __init__(self, data, backend: str = "auto", compute_dtype: str = "float32",
                 device="cuda"):
        self.device = resolve_device(device)
        self.n_users = data.user_num
        self.n_items = data.item_num
        self.n_nodes = self.n_users + self.n_items
        self.backend = choose_backend(self.n_nodes, self.n_nodes, backend)
        if self.backend != "dense":
            raise NotImplementedError(
                f"graph backend {self.backend!r} is not ported yet: the port serves "
                "the dense backend only (ROADMAP queue 1, 'Large-graph backend' / "
                "'Segment backend and neighbor models')"
            )
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
        self.compute_dtype = compute_dtype

        # Per-user positives as a padded [n_users, max_deg] table (-1 pads),
        # each row in CSR order: the top-k mask. Skipped above
        # POS_TABLE_MAX_ELEMENTS, where evaluation builds per-block tables.
        mat = data.interaction_mat
        degs = np.diff(mat.indptr)
        self.max_degree = int(degs.max()) if len(degs) else 0
        self.has_pos_table = self.n_users * max(1, self.max_degree) <= POS_TABLE_MAX_ELEMENTS
        if self.has_pos_table:
            pos = np.full((self.n_users, max(1, self.max_degree)), -1, dtype=np.int32)
            rows = np.repeat(np.arange(self.n_users, dtype=np.int64), degs)
            offs = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
                mat.indptr[:-1].astype(np.int64), degs
            )
            pos[rows, offs] = mat.indices
        else:
            pos = np.full((1, 1), -1, dtype=np.int32)
        self.user_positives = torch.from_numpy(pos).to(self.device)  # i32[n_users, max_deg]
        self.user_degrees = torch.from_numpy(degs.astype(np.int32)).to(self.device)

        # Dense R̂: the bipartite adjacency is [[0, R̂], [R̂ᵀ, 0]], so one
        # propagation round is R̂ · I and R̂ᵀ · U.
        deg_u = np.asarray(mat.sum(axis=1)).flatten()
        deg_i = np.asarray(mat.sum(axis=0)).flatten()
        du = np.where(deg_u > 0, deg_u ** -0.5, 0.0).astype(np.float32)
        di = np.where(deg_i > 0, deg_i ** -0.5, 0.0).astype(np.float32)
        r_hat = mat.multiply(du[:, None]).multiply(di[None, :])
        self.interaction_norm_dense = torch.from_numpy(
            np.asarray(r_hat.todense(), dtype=np.float32)
        ).to(self.device)
        self.interaction_norm_bf16 = None
        if compute_dtype == "bfloat16":
            self.interaction_norm_bf16 = self.interaction_norm_dense.to(torch.bfloat16)

    @property
    def propagation_matrix(self) -> torch.Tensor:
        """R̂ in the compute dtype: what the layer chain multiplies by."""
        if self.interaction_norm_bf16 is not None:
            return self.interaction_norm_bf16
        return self.interaction_norm_dense
