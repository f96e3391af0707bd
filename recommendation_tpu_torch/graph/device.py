"""Device-resident graph state for serving and training, on the dense, the
bucketed and the segment backends.

Counterpart of ``recommendation_tpu/graph/device.py``: ``DeviceAdj`` with
``from_scipy``, ``with_vals``, ``binarized``, ``densify`` and ``transpose``
on the dense, the bucketed and the segment (and ``pallas``, which runs the
segment path) backends, and ``DeviceGraph``:
the backend choice, the padded edge list, the per-user positives table used
to mask train items out of a top-k, the user degrees, the sampler's
membership tables (CSR, guaranteed-negative fallbacks, packed bitmap, dense
mask) and the propagation operator: on the dense backend the normalized
interaction block R̂ = D_u^-1/2 R D_i^-1/2 that the LightGCN layer chain
multiplies by, and the normalized bipartite adjacency ``norm_adj`` as a
``DeviceAdj``: on the dense backend its COO, uploaded at first access, and
its (U+I)² matrix, built from the COO at the first product (R̂-only models
never touch either), on the bucketed backend
(graphs whose (U+I)² passes ``DENSE_MAX_ELEMENTS``) its gather-only pull
tables (``graph/bucketed.py``), on the segment backend its padded
row-sorted COO with its two row-sorted views (``ops/segment.py``: the
rows', and the columns' for the transpose), built at upload. Tables are
built on the host with the same numpy code as the JAX package and uploaded
once, so each equals the JAX one bit for bit.

Edge augmentation stays on the device: ``normalized_bipartite(keep_mask)``
re-normalizes the bipartite adjacency under a keep-mask over the edges
(the degrees from the kept edges, both directions of a kept edge kept).
On the dense backend its (U+I)² matrix is built at first access; on the
bucketed one its pull tables are refreshed from structure-only templates
over the static bipartite pattern, built at the first call and kept; on
the segment one the new values ride the two row-sorted views of that
static pattern (``bipartite_views``, built at the first call and kept, so
no step sorts). The same views serve GraphSAGE's and GAT's sums over
``bidirectional_edges`` on every backend. ``norm_adj_selfloops``
(D̃^-1/2 (A + I) D̃^-1/2, GRACE's and G-BT's operator) is built at first
access: on the segment backend where the graph is bucketed, as the JAX
package puts it, else on the graph's. ``ensure_gat_aux`` builds the
bucketed GAT's slot maps (``graph/bucketed.py::slot_maps``) once and
keeps them on the graph, never in a checkpoint.

Forms of the JAX graph that stay out: ``user_bitmap_fb`` rows are not
padded to 64 words (a TPU gather-width workaround; the first W + 8 columns
are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from recommendation_tpu_torch.data.interaction import normalize_graph_mat
from recommendation_tpu_torch.device import resolve_device
from recommendation_tpu_torch.graph.bucketed import (
    BucketedCSR,
    build_bucketed,
    mirrored_transpose,
    refresh_vals,
    slot_maps,
)
from recommendation_tpu_torch.ops.segment import SegmentCSR, segment_csr

# Graphs whose dense adjacency is at most this many f32 elements use the
# dense backend (the JAX package's threshold, kept so both choose alike).
DENSE_MAX_ELEMENTS = 128 * 1024 * 1024

# Guaranteed-negative candidates kept per user for the sampler's fallback.
FALLBACK_NEGATIVES = 8

# The edge list is padded to a multiple of this many edges, the JAX
# package's default (recommendation_tpu/graph/device.py:240), so the epoch
# sampler's draws over [E_pad] edges have the same shape in both packages.
EDGE_PAD = 8
# R̂'s row stride on the dense backend, in elements (16 bytes of bf16)
R_ROW_ALIGN = 8

# Padded per-user positives table cap (i32 elements): 64M = 256 MB.
POS_TABLE_MAX_ELEMENTS = 64 * 1024 * 1024

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BACKENDS = ("dense", "bucketed", "segment", "pallas")


def choose_backend(n_rows: int, n_cols: int, requested: str = "auto") -> str:
    if requested != "auto":
        return requested
    return "dense" if n_rows * n_cols <= DENSE_MAX_ELEMENTS else "bucketed"


def _row_aligned(a: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` [rows, cols] cast to ``dtype`` (round to nearest even) on
    ``device``, as a view into a zeroed buffer whose row stride is a
    multiple of ``R_ROW_ALIGN`` elements: every row of R̂ then starts on a
    16-byte boundary, which the chain kernel's 16-byte loads need."""
    rows, cols = a.shape
    buf = torch.zeros((rows, _round_up(max(cols, 1), R_ROW_ALIGN)), dtype=dtype, device=device)
    buf[:, :cols] = a.to(device)
    return buf[:, :cols]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_compute_dtype(compute_dtype: str) -> None:
    if compute_dtype == "int8":
        raise NotImplementedError("int8 propagation is not ported yet (ROADMAP queue 1, item 15)")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")


@dataclasses.dataclass
class DeviceAdj:
    """A normalized sparse adjacency on the device. ``rows``/``cols``/``vals``
    are the COO (row-sorted as built) padded to a multiple of ``EDGE_PAD``
    with zero-valued ``(n_rows-1, n_cols-1)`` entries. On the dense backend
    ``dense`` is the materialized f32 [n_rows, n_cols] matrix, built from
    the COO at first access and kept, and ``dense_operand`` the matrix that
    ``adj_matmul`` multiplies by (in the bf16 regime ``dense`` rounded to
    bf16 once, kept in f32). On the bucketed backend ``pull`` and
    ``pull_t`` are the bucketed tables of A and Aᵀ, whose slot→edge maps
    point into ``vals`` positions (so ``with_vals`` refreshes both);
    ``sym_rowspace`` says that they share ``gather_pos``, the precondition
    of the row-space chain (``bucketed_chain_mean``). On the segment (and
    pallas) backend ``seg`` and ``seg_t`` are the row-sorted views of the
    COO by its rows and by its columns (``ops/segment.py``), which
    ``with_vals`` keeps (the values are gathered into slot order per
    product); ``rows_sorted`` says the COO itself is sorted by row."""

    rows: torch.Tensor  # i32[E_pad]
    cols: torch.Tensor  # i32[E_pad]
    vals: torch.Tensor  # f32[E_pad]
    n_rows: int
    n_cols: int
    backend: str
    compute_dtype: str = "float32"
    pull: Optional[BucketedCSR] = None
    pull_t: Optional[BucketedCSR] = None
    sym_rowspace: bool = False
    rows_sorted: bool = False
    seg: Optional[SegmentCSR] = dataclasses.field(default=None, repr=False)
    seg_t: Optional[SegmentCSR] = dataclasses.field(default=None, repr=False)
    _dense: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    _dense_operand: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dense(self) -> Optional[torch.Tensor]:
        """The f32 [n_rows, n_cols] matrix on the dense backend (None on the
        others): the COO's values added at their coordinates."""
        if self.backend != "dense":
            return None
        if self._dense is None:
            self._dense = _coo_to_dense(self)
        return self._dense

    @property
    def dense_operand(self) -> Optional[torch.Tensor]:
        """``dense`` as the dense product reads it: in the bf16 regime each
        entry rounded to bf16 (to nearest even) and kept as f32, so a plain
        f32 product sums the exact bf16 products in f32, as the JAX
        package's bf16 dot with f32 accumulation does; else ``dense``
        itself. Rounded at first access and kept."""
        if self.backend != "dense" or self.compute_dtype != "bfloat16":
            return self.dense
        if self._dense_operand is None:
            self._dense_operand = self.dense.to(torch.bfloat16).float()
        return self._dense_operand

    def segment_views(self) -> tuple[SegmentCSR, SegmentCSR]:
        """(seg, seg_t): the COO's views sorted by its rows and by its
        columns, built at the first call where the adjacency has none."""
        if self.seg is None:
            self.seg = segment_csr(self.rows, self.cols, self.n_rows, self.n_cols)
            self.seg_t = segment_csr(self.cols, self.rows, self.n_cols, self.n_rows)
        return self.seg, self.seg_t

    def transpose(self) -> "DeviceAdj":
        """Aᵀ. Without bucketed tables the COO is re-sorted by its new rows
        (a stable sort, as the JAX package's; its segment views are built
        anew at their first use); with them it keeps its positions, which
        their slot→edge maps index."""
        if self.pull is not None or self.pull_t is not None:
            order = torch.arange(self.vals.shape[0], device=self.vals.device)
        else:
            order = torch.argsort(self.cols, stable=True)
        return DeviceAdj(rows=self.cols[order], cols=self.rows[order], vals=self.vals[order],
                         n_rows=self.n_cols, n_cols=self.n_rows, backend=self.backend,
                         compute_dtype=self.compute_dtype, pull=self.pull_t, pull_t=self.pull,
                         sym_rowspace=self.sym_rowspace,
                         _dense=None if self._dense is None else self._dense.T,
                         _dense_operand=None if self._dense_operand is None
                         else self._dense_operand.T)


def _coo_to_dense(adj: DeviceAdj) -> torch.Tensor:
    """The COO as an f32 [n_rows, n_cols] matrix. A coordinate appears once,
    apart from the zero-valued padding at the corner, so the sum is exact
    in any order."""
    out = torch.zeros((adj.n_rows, adj.n_cols), dtype=torch.float32, device=adj.vals.device)
    out.index_put_((adj.rows.long(), adj.cols.long()), adj.vals.float(), accumulate=True)
    return out


def from_scipy(mat: sp.spmatrix, backend: str = "auto", compute_dtype: str = "float32",
               device="cuda") -> DeviceAdj:
    """Upload a scipy sparse matrix as a DeviceAdj (one host-to-device
    copy): the row-sorted COO padded to a multiple of ``EDGE_PAD``; the
    dense matrix built on the device at first access, the bucketed tables
    or the segment views built at upload."""
    _check_compute_dtype(compute_dtype)
    dev = resolve_device(device)
    coo = sp.coo_matrix(mat, dtype=np.float32)
    if len(coo.row) == 0 or np.all(coo.row[:-1] <= coo.row[1:]):
        # CSR->COO is already row-major: skip the O(E log E) argsort
        rows = coo.row.astype(np.int32)
        cols = coo.col.astype(np.int32)
        vals = coo.data.astype(np.float32)
    else:
        order = np.argsort(coo.row, kind="stable")
        rows = coo.row[order].astype(np.int32)
        cols = coo.col[order].astype(np.int32)
        vals = coo.data[order].astype(np.float32)
    n_rows, n_cols = coo.shape
    backend = choose_backend(n_rows, n_cols, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has {BACKENDS}")

    e_pad = max(EDGE_PAD, _round_up(len(vals), EDGE_PAD))
    # pad with (n_rows-1, n_cols-1) zero edges: padding must be symmetric, or
    # pull and pull_t get different degree layouts whenever nnz % EDGE_PAD != 0
    rows = np.pad(rows, (0, e_pad - len(rows)), constant_values=n_rows - 1)
    cols = np.pad(cols, (0, e_pad - len(cols)), constant_values=n_cols - 1)
    vals = np.pad(vals, (0, e_pad - len(vals)))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pull = pull_t = None
    sym_rowspace = False
    if backend == "bucketed":
        # slot->edge maps index the padded COO positions, so one [E_pad]
        # vector refreshes both directions
        eids = np.arange(e_pad, dtype=np.int32)
        pull = build_bucketed(rows, cols, vals, n_rows, n_cols, edge_ids=eids, device=dev)
        pull_t = build_bucketed(cols, rows, vals, n_cols, n_rows, edge_ids=eids, device=dev)
        # symmetric patterns (the normalized bipartite adjacency always is)
        # put both directions in one row space: the precondition for the chain
        sym_rowspace = n_rows == n_cols and bool(torch.equal(pull.gather_pos, pull_t.gather_pos))
    adj = DeviceAdj(rows=put(rows), cols=put(cols), vals=put(vals), n_rows=n_rows,
                    n_cols=n_cols, backend=backend, compute_dtype=compute_dtype, pull=pull,
                    pull_t=pull_t, sym_rowspace=sym_rowspace, rows_sorted=True)
    if backend in ("segment", "pallas"):
        adj.segment_views()
    return adj


def with_vals(adj: DeviceAdj, vals: torch.Tensor) -> DeviceAdj:
    """The same pattern with new edge values (aligned to ``adj.vals``
    positions): the hook every value-level augmentation goes through. The
    dense matrix is rebuilt from them (at its first access) and the
    bucketed tables are refreshed on the device, which keeps
    ``sym_rowspace``."""
    return dataclasses.replace(
        adj, vals=vals, _dense=None, _dense_operand=None,
        pull=None if adj.pull is None else refresh_vals(adj.pull, vals),
        pull_t=None if adj.pull_t is None else refresh_vals(adj.pull_t, vals),
    )


def binarized(adj: DeviceAdj) -> DeviceAdj:
    """The same pattern with every stored value 1: the raw adjacency (DirectAU's
    reference script propagates over it, `directau.py:132-141`)."""
    return with_vals(adj, (adj.vals > 0).to(torch.float32))


def densify(adj: DeviceAdj) -> torch.Tensor:
    """The dense matrix of ``adj`` on its device, on any backend."""
    if adj.backend == "dense":
        return adj.dense
    return _coo_to_dense(adj)


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

    Dense backend: ``interaction_norm_dense`` is R̂ in f32 [n_users,
    n_items]; in the bfloat16 regime ``interaction_norm_bf16`` holds it once
    more, cast to bf16 (round to nearest even, as the JAX chain's
    ``astype``). Both are views with a row stride padded to a multiple of
    ``R_ROW_ALIGN`` elements (``_row_aligned``). ``propagation_matrix`` is
    the one the layer chain multiplies by. On every backend ``norm_adj`` is
    the normalized bipartite adjacency D^-1/2 A D^-1/2 over the U + I nodes
    as a ``DeviceAdj`` (dense: uploaded at first access, its matrix built at
    the first product; bucketed: its pull tables, segment and pallas: its
    row-sorted views, built with the graph); only the dense backend has R̂,
    and ``propagation_matrix`` raises on the others. The
    ``data`` may be an ``Interaction`` or a ``data.synthetic.ArrayInteraction``.

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
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown graph backend {self.backend!r}; the port has {BACKENDS}")
        _check_compute_dtype(compute_dtype)
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

        self.interaction_norm_dense = self.interaction_norm_bf16 = None
        # the normalized bipartite adjacency (``norm_adj``): the bucketed
        # backend's pull tables now, the dense backend's COO at first access
        self._norm_adj_host = data.norm_adj
        self._norm_adj = None if self.backend == "dense" else self._upload_norm_adj()
        self._bipartite_tpl = None  # normalized_bipartite's bucketed templates, at first use
        self._bipartite_views = None  # the bipartite pattern's segment views, at first use
        self.gat_aux = None  # the bucketed GAT's slot maps (ensure_gat_aux)
        self.gat_attention = None  # GAT's structure (models/gat.py::attention_structure)
        self._norm_adj_selfloops = None
        self._ui_adj_host = data.ui_adj  # norm_adj_selfloops', at first access
        if self.backend != "dense":
            return
        # Dense R̂: the bipartite adjacency is [[0, R̂], [R̂ᵀ, 0]], so one
        # propagation round is R̂ · I and R̂ᵀ · U.
        deg_u = np.asarray(mat.sum(axis=1)).flatten()
        deg_i = np.asarray(mat.sum(axis=0)).flatten()
        du = np.where(deg_u > 0, deg_u ** -0.5, 0.0).astype(np.float32)
        di = np.where(deg_i > 0, deg_i ** -0.5, 0.0).astype(np.float32)
        r_hat = mat.multiply(du[:, None]).multiply(di[None, :])
        self.interaction_norm_dense = _row_aligned(
            torch.from_numpy(np.asarray(r_hat.todense(), dtype=np.float32)), torch.float32, dev)
        if compute_dtype == "bfloat16":
            self.interaction_norm_bf16 = _row_aligned(self.interaction_norm_dense,
                                                      torch.bfloat16, dev)

    @property
    def norm_adj(self) -> DeviceAdj:
        """The normalized bipartite adjacency D^-1/2 A D^-1/2 over the U + I
        nodes as a ``DeviceAdj``: built with the graph on the bucketed
        backend, whose chain every model runs through it, and uploaded at
        first access on the dense one, where only the square-adjacency
        models (DirectAU, BUIR, GCL's evaluation, BGRL) read it."""
        if self._norm_adj is None:
            self._norm_adj = self._upload_norm_adj()
        return self._norm_adj

    def _upload_norm_adj(self) -> DeviceAdj:
        adj = from_scipy(self._norm_adj_host, backend=self.backend,
                         compute_dtype=self.compute_dtype, device=self.device)
        self._norm_adj_host = None
        return adj

    @property
    def propagation_matrix(self) -> torch.Tensor:
        """R̂ in the compute dtype: what the dense layer chain multiplies by.
        Only the dense backend has R̂ (the others propagate through
        ``norm_adj``)."""
        if self.backend != "dense":
            raise NotImplementedError(
                f"the {self.backend} backend has no dense R̂: the dense layer chain (kernels "
                "K1-K4) reads it; the models on this backend propagate through norm_adj "
                "(ROADMAP queue 1: the social models, item 11, are still to come to it)")
        if self.interaction_norm_bf16 is not None:
            return self.interaction_norm_bf16
        return self.interaction_norm_dense

    @property
    def norm_adj_selfloops(self) -> DeviceAdj:
        """D̃^-1/2 (A + I) D̃^-1/2 over the U + I nodes (GCNConv's operator,
        GRACE's and G-BT's), built at first access: on the segment backend
        where the graph is bucketed, as the JAX package puts it
        (`graph/device.py:263-273`: those encoders do not target the
        large-graph regime, so it skips the two bucketed table builds),
        else on the graph's backend."""
        if self._norm_adj_selfloops is None:
            mat = normalize_graph_mat(self._ui_adj_host + sp.eye(self.n_nodes, dtype=np.float32))
            backend = "segment" if self.backend == "bucketed" else self.backend
            self._norm_adj_selfloops = from_scipy(mat, backend=backend,
                                                  compute_dtype=self.compute_dtype,
                                                  device=self.device)
            self._ui_adj_host = None
        return self._norm_adj_selfloops

    def bipartite_views(self) -> tuple[SegmentCSR, SegmentCSR]:
        """The segment views of the static bipartite pattern over the
        [2·E_pad] positions (rows ``[u; i + U]``, cols ``[i + U; u]``, the
        order of ``normalized_bipartite``'s values and of
        ``bidirectional_edges``): sorted by the rows (``normalized_bipartite``'s
        ``seg``; each node's out-edges as a source) and by the columns (its
        ``seg_t``; each node's in-edges as a destination). Built on the
        device at the first call (two stable sorts) and kept."""
        if self._bipartite_views is None:
            u = self.edge_users.long()
            i = self.edge_items.long() + self.n_users
            rows, cols = torch.cat([u, i]), torch.cat([i, u])
            self._bipartite_views = (segment_csr(rows, cols, self.n_nodes, self.n_nodes),
                                     segment_csr(cols, rows, self.n_nodes, self.n_nodes))
        return self._bipartite_views

    def ensure_gat_aux(self):
        """The bucketed GAT's static slot maps over ``norm_adj``'s tables
        (``graph/bucketed.py::slot_maps``: ``pos_map``, ``slot_node``,
        ``node_of_row``) and ``tpos``, the forward slot of each transpose
        slot (dead slots 0), built once on the host and kept on the graph
        (never in a checkpoint). None on the other backends, whose GAT runs
        over ``bipartite_views``."""
        if self.gat_aux is not None or self.backend != "bucketed":
            return self.gat_aux
        adj = self.norm_adj
        if adj.pull_t is not None:
            pos_map, slot_node, node_of_row = slot_maps(adj.pull)
            pm = pos_map.cpu().numpy()
            tpos = pm[np.maximum(adj.pull_t.edge.cpu().numpy(), 0)].astype(np.int32)
            self.gat_aux = {"pos_map": pos_map, "slot_node": slot_node,
                            "node_of_row": node_of_row,
                            "tpos": torch.from_numpy(tpos).to(self.device)}
        return self.gat_aux

    def _bipartite_templates(self) -> tuple[BucketedCSR, BucketedCSR]:
        """Structure-only bucketed tables over the static bipartite pattern
        (rows [u; i + U], cols [i + U; u], slot→edge maps into the [2·E_pad]
        values of ``normalized_bipartite``) and their mirrored transpose,
        built on the host at the first call and kept."""
        if self._bipartite_tpl is None:
            users = self.edge_users.cpu().numpy()
            items = self.edge_items.cpu().numpy() + self.n_users
            e_pad = len(users)
            tpl = build_bucketed(np.concatenate([users, items]), np.concatenate([items, users]),
                                 None, self.n_nodes, self.n_nodes,
                                 edge_ids=np.arange(2 * e_pad, dtype=np.int32),
                                 device=self.device)
            # the pattern is a mirror (its second half swaps the first), so
            # the transpose's tables are the forward's, the edge map flipped
            self._bipartite_tpl = (tpl, mirrored_transpose(tpl, e_pad))
        return self._bipartite_tpl

    def normalized_bipartite(self, keep_mask: Optional[torch.Tensor] = None) -> DeviceAdj:
        """D^-1/2 (A∘mask) D^-1/2 over the U + I nodes, on the device.

        ``keep_mask`` is f32[E_pad] in {0, 1} over the interaction edges;
        both directions of a kept edge survive, and the degrees count the
        kept edges. The values are [2·E_pad]: the edges user→item, then
        item→user. Dense backend: the (U+I)² matrix is built from them at
        first access (each coordinate holds one real value; the padding
        adds exact zeros). Bucketed backend: the templates' pull tables
        refreshed with them, sharing one row space (``sym_rowspace``).
        Segment and pallas backends: the COO (``rows_sorted`` False, as in
        the JAX package) with the pattern's cached views
        (``bipartite_views``), into whose slot order each product gathers
        the values."""
        mask = self.edge_valid if keep_mask is None else self.edge_valid * keep_mask
        u_nodes = self.edge_users.long()
        i_nodes = self.edge_items.long() + self.n_users
        # sums of 0/1 values: exact in any order
        deg = torch.zeros(self.n_nodes, dtype=torch.float32, device=mask.device)
        deg = deg.index_add(0, u_nodes, mask).index_add(0, i_nodes, mask)
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                               torch.zeros_like(deg))
        vals = mask * inv_sqrt[u_nodes] * inv_sqrt[i_nodes]
        both = torch.cat([vals, vals])
        pull = pull_t = seg = seg_t = None
        if self.backend == "bucketed":
            tpl, tpl_t = self._bipartite_templates()
            pull, pull_t = refresh_vals(tpl, both), refresh_vals(tpl_t, both)
        elif self.backend != "dense":
            seg, seg_t = self.bipartite_views()
        return DeviceAdj(rows=torch.cat([u_nodes, i_nodes]).int(),
                         cols=torch.cat([i_nodes, u_nodes]).int(), vals=both,
                         n_rows=self.n_nodes, n_cols=self.n_nodes, backend=self.backend,
                         compute_dtype=self.compute_dtype, pull=pull, pull_t=pull_t,
                         sym_rowspace=pull is not None, seg=seg, seg_t=seg_t)
