"""Device-resident graph state for serving and training on the dense backend.

Counterpart of ``recommendation_tpu/graph/device.py::DeviceGraph``: the
backend choice, the padded edge list, the per-user positives table used to
mask train items out of a top-k, the user degrees, the sampler's membership
tables (CSR, guaranteed-negative fallbacks, packed bitmap, dense mask) and
the dense normalized interaction block R̂ = D_u^-1/2 R D_i^-1/2 that the
LightGCN layer chain multiplies by. Tables are built on the host with the
same numpy code as the JAX package and uploaded once, so each equals the
JAX one bit for bit.

Two forms of the JAX graph stay out: ``user_bitmap_fb`` rows are not padded
to 64 words (a TPU gather-width workaround; the first W + 8 columns are the
same), and ``norm_adj_selfloops`` comes with GRACE/G-BT (ROADMAP queue 1,
"The other dense-path models"). Graphs that ``choose_backend`` sends to the bucketed or segment
backend are not ported yet (ROADMAP queue 1, "Large-graph backend").
"""

from __future__ import annotations

import numpy as np
import torch

from recommendation_tpu_torch.device import resolve_device

# Graphs whose dense adjacency is at most this many f32 elements use the
# dense backend (the JAX package's threshold, kept so both choose alike).
DENSE_MAX_ELEMENTS = 128 * 1024 * 1024

# Guaranteed-negative candidates kept per user for the sampler's fallback.
FALLBACK_NEGATIVES = 8

# The edge list is padded to a multiple of this many edges, the JAX
# package's default (recommendation_tpu/graph/device.py:240), so the epoch
# sampler's draws over [E_pad] edges have the same shape in both packages.
EDGE_PAD = 8

# Padded per-user positives table cap (i32 elements): 64M = 256 MB.
POS_TABLE_MAX_ELEMENTS = 64 * 1024 * 1024

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def choose_backend(n_rows: int, n_cols: int, requested: str = "auto") -> str:
    if requested != "auto":
        return requested
    return "dense" if n_rows * n_cols <= DENSE_MAX_ELEMENTS else "bucketed"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fallback_negatives(mat0, degs, n_users: int, n_items: int) -> np.ndarray:
    """i32[n_users, FALLBACK_NEGATIVES]: random non-positives per user, the
    sampler's fallback when every candidate collides. The JAX package's
    code and seeded RNG, so the table is the same bit for bit. Saturated
    users (every item positive) keep item 0."""
    F = FALLBACK_NEGATIVES
    fb_rng = np.random.default_rng(0xFA11BACC % (2**32))
    fallback = np.zeros((n_users, F), dtype=np.int32)
    indptr0, indices0 = mat0.indptr, mat0.indices  # sorted rows
    # membership by one searchsorted into the flat int64-keyed CSR
    # (row-major + sorted indices => keys are globally sorted)
    keys = (
        np.repeat(np.arange(n_users, dtype=np.int64), degs) * n_items
        + indices0.astype(np.int64)
    )
    open_users = degs < n_items
    pending = np.broadcast_to(open_users[:, None], (n_users, F)).copy()
    for _ in range(64):  # P(all collide) shrinks as density^round
        uu, ff = np.nonzero(pending)
        if len(uu) == 0:
            break
        cand = fb_rng.integers(0, n_items, size=len(uu))
        k = uu.astype(np.int64) * n_items + cand
        j = np.searchsorted(keys, k)
        miss = (j >= len(keys)) | (keys[np.minimum(j, len(keys) - 1)] != k)
        fallback[uu[miss], ff[miss]] = cand[miss]
        pending[uu[miss], ff[miss]] = False
    if pending.any():
        # near-saturated stragglers: draw the t-th NON-positive directly by
        # rank inversion (row[p] has row[p]-p non-positives below it)
        uu, ff = np.nonzero(pending)
        for u in np.unique(uu):
            row = indices0[indptr0[u]:indptr0[u + 1]].astype(np.int64)
            sel = ff[uu == u]
            t = fb_rng.integers(0, n_items - len(row), size=len(sel))
            p = np.searchsorted(row - np.arange(len(row)), t, side="right")
            fallback[u, sel] = (t + p).astype(np.int32)
    return fallback


class DeviceGraph:
    """Serving and training state derived from an ``Interaction``, on ``device``.

    ``interaction_norm_dense`` is R̂ in f32 [n_users, n_items]; in the
    bfloat16 regime ``interaction_norm_bf16`` holds it once more, cast to
    bf16 (round to nearest even, as the JAX chain's ``astype``).
    ``propagation_matrix`` is the one the layer chain multiplies by.

    Sampler tables (i32 unless noted): ``edge_users``/``edge_items`` and
    ``edge_ui`` [E_pad, 2] (padded to a multiple of ``EDGE_PAD``; f32
    ``edge_valid`` marks real edges); ``csr_indptr``/``csr_items`` (items
    sorted in each row); ``user_fallback_neg`` [U, 8]; the packed bitmap
    ``user_pos_bitmap`` [U, W] (W = ceil(I/32), an i32 view of the bits);
    ``user_bitmap_fb`` [U, W + 8] (bitmap and fallbacks in one row) and
    ``edge_bitmap_fb`` (its rows in edge order); the i8 mask
    ``user_pos_mask`` [U, I]. Each ``has_*`` flag says whether its table
    was built (a [1, 1] placeholder stands in otherwise)."""

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
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        e = len(data.edge_users)
        e_pad = max(EDGE_PAD, _round_up(e, EDGE_PAD))
        users = np.pad(data.edge_users, (0, e_pad - e))
        items = np.pad(data.edge_items, (0, e_pad - e))
        valid = np.zeros(e_pad, dtype=np.float32)
        valid[:e] = 1.0
        self.n_edges = e
        self.edge_users = put(users)  # i32[E_pad] user ids
        self.edge_items = put(items)  # i32[E_pad] item ids
        self.edge_valid = put(valid)  # f32[E_pad] 1 for real edges
        self.edge_ui = put(np.stack([users, items], axis=1))  # i32[E_pad, 2]

        # CSR membership arrays: per-user sorted item lists + row pointers
        mat0 = data.interaction_mat.copy()
        mat0.sort_indices()
        self.csr_indptr = put(mat0.indptr.astype(np.int32))
        self.csr_items = put(mat0.indices.astype(np.int32))

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
        self.user_positives = put(pos)  # i32[n_users, max_deg]
        self.user_degrees = put(degs.astype(np.int32))

        fallback = _fallback_negatives(mat0, degs, self.n_users, self.n_items)
        self.user_fallback_neg = put(fallback)

        # Packed membership bitmap [n_users, W] (bit i%32 of word i//32),
        # built where it is narrower than the positives table and fits its cap
        self._W = -(-self.n_items // 32)
        self.has_pos_bitmap = self.n_users * self._W <= POS_TABLE_MAX_ELEMENTS and (
            not self.has_pos_table or self._W < self.max_degree
        )
        self.has_edge_bitmap_fb = False
        if self.has_pos_bitmap:
            rows64 = np.repeat(np.arange(self.n_users, dtype=np.int64), degs)
            cols = mat.indices.astype(np.int64)
            bm_flat = np.zeros(self.n_users * self._W, dtype=np.uint32)
            np.bitwise_or.at(
                bm_flat, rows64 * self._W + (cols >> 5),
                (np.uint32(1) << (cols & 31).astype(np.uint32)),
            )
            bitmap = bm_flat.view(np.int32).reshape(self.n_users, self._W)
            # bitmap words and fallback candidates in one row per user
            fb = np.concatenate([bitmap, fallback], axis=1)
            self.user_pos_bitmap = put(bitmap)
            self.user_bitmap_fb = put(fb)
            # the same rows in edge order: the epoch sampler reads them by edge
            if e_pad * fb.shape[1] <= POS_TABLE_MAX_ELEMENTS:
                self.edge_bitmap_fb = put(fb[users])
                self.has_edge_bitmap_fb = True
            else:
                self.edge_bitmap_fb = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        else:
            self.user_pos_bitmap = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            self.user_bitmap_fb = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            self.edge_bitmap_fb = torch.zeros((1, 1), dtype=torch.int32, device=dev)

        # Dense int8 membership mask [n_users, n_items]
        self.has_pos_mask = self.n_users * self.n_items <= DENSE_MAX_ELEMENTS
        if self.has_pos_mask:
            self.user_pos_mask = put((mat != 0).toarray().astype(np.int8))
        else:
            self.user_pos_mask = torch.zeros((1, 1), dtype=torch.int8, device=dev)

        # Dense R̂: the bipartite adjacency is [[0, R̂], [R̂ᵀ, 0]], so one
        # propagation round is R̂ · I and R̂ᵀ · U.
        deg_u = np.asarray(mat.sum(axis=1)).flatten()
        deg_i = np.asarray(mat.sum(axis=0)).flatten()
        du = np.where(deg_u > 0, deg_u ** -0.5, 0.0).astype(np.float32)
        di = np.where(deg_i > 0, deg_i ** -0.5, 0.0).astype(np.float32)
        r_hat = mat.multiply(du[:, None]).multiply(di[None, :])
        self.interaction_norm_dense = put(np.asarray(r_hat.todense(), dtype=np.float32))
        self.interaction_norm_bf16 = None
        if compute_dtype == "bfloat16":
            self.interaction_norm_bf16 = self.interaction_norm_dense.to(torch.bfloat16)

    @property
    def propagation_matrix(self) -> torch.Tensor:
        """R̂ in the compute dtype: what the layer chain multiplies by."""
        if self.interaction_norm_bf16 is not None:
            return self.interaction_norm_bf16
        return self.interaction_norm_dense
