"""Bucketed pull-form (gather-only) sparse propagation: the large-graph
backend (counterpart of ``recommendation_tpu/graph/bucketed.py``).

A pull-form CSR: each destination row pulls its neighbour rows and sums
them, with no scatter in either pass. Rows are grouped into buckets by
degree (caps are multiples of ``CAP_STEP`` up to ``CAP_POW2_ABOVE``, powers
of two beyond); a bucket is a padded [rows, cap] table of source indices,
edge values and slot→edge positions, padding slots carrying value 0 and
edge −1. The host build is the JAX package's numpy path, so every table
equals the JAX one bit for bit, and the caps fix the slot layout and with
it the order of every sum.

On the device the buckets are one flat table each (``idx``, ``val``,
``edge``, ``ridx``, bucket after bucket, row-major) with a row pointer
``row_ptr``; ``BucketedCSR.buckets`` gives the [rows, cap] views. Kernel
P1 (``ops/gather.py::gather_sum``) pulls every bucket in one launch, and
kernel K7 (``gather_rows``) does the reorders between node order and the
buckets' concatenated row order:

  * ``pull`` — ``A @ x``: P1 over ``idx``, then K7 by ``gather_pos``;
  * ``pull_rowspace`` — the same in concat-row order, ``[R + 1, d]`` in and
    out with the last row zero, P1 over ``ridx`` (dead slots point at that
    zero row);
  * ``bucketed_chain_mean`` — LightGCN's ``mean([x, Ax, .., A^L x])`` in
    row space: K7 in, L pulls, K7 out, and the mirrored Horner chain through
    the transpose as its backward (``BucketedChainMean``);
  * ``bucketed_matmul`` — ``A @ x`` with the backward ``Aᵀ g`` through the
    prebuilt transpose (``BucketedMatmul``).

Edge values receive no gradient (they are normalization constants).

Kept from the JAX package: the separable fold (when val(dst, src) =
a[dst]·b[src], the pull is a plain sum between two row scalings), and what
its bf16 packing computes: under ``compute_dtype="bfloat16"`` the source
rows are rounded to bf16 exactly where the JAX package packs them
(``packed_words >= 64``, i.e. d >= 127) and the sum stays f32. At d = 64
neither dtype packs, so both run the identical f32 chain. Not ported: the
packing into f32 words itself and the cap schedule's TPU timing rationale
(TPU forms), ``int8`` propagation (ROADMAP queue 1, item 15), the native
C++ builder (the numpy path builds the same tables). The JAX package's
``_bwd_dtype`` differs from the forward's dtype only for int8, so the
backward here pulls in the forward's. ``slot_maps`` gives the bucketed
GAT (``models/gat.py``) its static edge↔slot maps.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recommendation_tpu_torch.device import resolve_device
from recommendation_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_sum,
    gather_sum_plain,
    pull_schedule,
)

MIN_CAP = 4  # smallest bucket width (bounds tiny-row padding)
CAP_STEP = 8  # caps are multiples of this up to CAP_POW2_ABOVE, pow2 beyond
CAP_POW2_ABOVE = 128  # hub rows are few; pow2 caps bound the bucket count


@dataclasses.dataclass
class Bucket:
    """Padded neighbour table of every row whose degree rounds up to ``cap``
    (views into the flat tables of its ``BucketedCSR``)."""

    idx: torch.Tensor  # i32[nb, cap] source-row ids into x (0 where padded)
    val: torch.Tensor  # f32[nb, cap] edge values (0 where padded)
    edge: torch.Tensor  # i32[nb, cap] position in the owning COO values (-1 pad)
    cap: int
    ridx: Optional[torch.Tensor] = None  # i32[nb, cap] row-space sources (square only)


@dataclasses.dataclass
class BucketedCSR:
    """Flat bucket tables on one device.

    ``idx``/``val``/``edge``/``ridx`` are [S] (S padded slots: every
    bucket's table row-major, buckets in ascending cap); ``row_ptr`` i64[R + 2]
    gives concat row r its slots ``[row_ptr[r], row_ptr[r+1])``, and row R,
    the appended zero row, none. ``gather_pos`` i32[n_rows] is each row's
    concat position (degree-0 rows point at the zero row R); ``node_of_row``
    i32[R + 1] its inverse. ``ridx`` (square patterns only) is ``idx``
    translated to concat rows, structurally dead slots (padding and
    build-time zero edges) pointing at the zero row. ``sep_dst`` and
    ``sep_src_row`` f32[R + 1] (zero-row entry 0) are the separable scales
    a[dst], b[src] in concat-row order, when the values factor so. ``work``,
    ``work_start`` and ``n_partials`` are P1's schedule over the rows
    (``ops/gather.py::pull_schedule``)."""

    caps: Tuple[int, ...]
    counts: Tuple[int, ...]  # rows in each bucket
    idx: torch.Tensor
    val: torch.Tensor
    edge: torch.Tensor
    ridx: Optional[torch.Tensor]
    row_ptr: torch.Tensor
    work: torch.Tensor
    work_start: torch.Tensor
    n_partials: int
    gather_pos: torch.Tensor
    node_of_row: torch.Tensor
    n_rows: int
    n_cols: int
    sep_dst: Optional[torch.Tensor] = None
    sep_src_row: Optional[torch.Tensor] = None

    @property
    def schedule(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        return self.work, self.work_start, self.n_partials

    @functools.cached_property
    def fold_scales(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a⊙b, 1/b) per concat row for the separable fold, the zero row's
        inverse kept at 0: every concat row has degree >= 1, so its source
        scale is > 0. Computed once per table (a new table, as
        ``refresh_vals`` makes, computes its own)."""
        b = self.sep_src_row
        inv_b = torch.where(b > 0, 1.0 / b, torch.zeros((), device=b.device))
        return self.sep_dst * b, inv_b

    @property
    def total_rows(self) -> int:
        return sum(self.counts)

    @property
    def n_slots(self) -> int:
        return int(self.idx.shape[0])

    @property
    def buckets(self) -> Tuple[Bucket, ...]:
        out, s = [], 0
        for cap, nb in zip(self.caps, self.counts):
            def view(t, s=s, nb=nb, cap=cap):
                return None if t is None else t[s:s + nb * cap].view(nb, cap)

            out.append(Bucket(idx=view(self.idx), val=view(self.val), edge=view(self.edge),
                              cap=cap, ridx=view(self.ridx)))
            s += nb * cap
        return tuple(out)


# -- host-side build ------------------------------------------------------------


def _host_ridx(gather_pos: np.ndarray, idx: np.ndarray, total_rows: int, n_rows: int,
               n_cols: int, dead: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Row-space translation of one bucket's index table (square patterns
    only). ``dead`` slots (padding and build-time zero edges) point at the
    zero row ``total_rows``. Contract: ``refresh_vals`` never resurrects a
    build-time zero edge."""
    if n_rows != n_cols:
        return None
    r = np.minimum(np.asarray(gather_pos)[np.asarray(idx)], max(total_rows - 1, 0))
    if dead is not None:
        r = np.where(dead, total_rows, r)
    return r.astype(np.int32)


def _detect_separable(rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
                      n_rows: int, n_cols: int) -> Optional[tuple]:
    """(a, b) with val(dst, src) == a[dst] * b[src] over nonzero edges, or
    None: the symmetric D_r^-1/2 A D_c^-1/2 and the one-sided D_r^-1 A."""
    if vals is None or n_rows != n_cols or len(rows) == 0:
        return None
    v = np.asarray(vals, dtype=np.float64)
    nz = v != 0
    if not nz.any():
        return None
    rr = np.asarray(rows)[nz].astype(np.int64)
    cc = np.asarray(cols)[nz].astype(np.int64)
    vv = v[nz]
    if not (vv > 0).all():
        return None
    rc = np.maximum(np.bincount(rr, minlength=n_rows), 1).astype(np.float64)
    ccnt = np.maximum(np.bincount(cc, minlength=n_cols), 1).astype(np.float64)
    for a, b in (
        (1.0 / np.sqrt(rc), 1.0 / np.sqrt(ccnt)),  # symmetric norm
        (1.0 / rc, np.ones(n_cols)),  # one-sided row norm
    ):
        if np.allclose(vv, a[rr] * b[cc], rtol=1e-5, atol=0.0):
            return a.astype(np.float32), b.astype(np.float32)
    return None


def _sep_row_vectors(sep, node_of_row: np.ndarray, total_rows: int):
    """(sep_dst, sep_src_row) in concat-row order, zero-row entry 0."""
    if sep is None:
        return None, None
    a, b = sep
    nor = np.asarray(node_of_row)[: total_rows + 1]
    sd = a[nor].astype(np.float32)
    ss = b[nor].astype(np.float32)
    sd[total_rows] = 0.0
    ss[total_rows] = 0.0
    return sd, ss


def _cap_for_degree(deg: np.ndarray, minimum: int) -> np.ndarray:
    """Bucket cap per row: multiples of CAP_STEP up to CAP_POW2_ABOVE, pow2
    beyond."""
    d = np.maximum(deg, minimum)
    stepped = (np.ceil(d / CAP_STEP) * CAP_STEP).astype(np.int64)
    pow2 = (2 ** np.ceil(np.log2(np.maximum(d, 1)))).astype(np.int64)
    return np.where(d <= CAP_POW2_ABOVE, stepped, pow2)


def _flat(parts, dtype) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype)
    return np.concatenate([p.reshape(-1) for p in parts]).astype(dtype)


def build_bucketed(rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
                   n_rows: int, n_cols: int, edge_ids: Optional[np.ndarray] = None,
                   min_cap: int = MIN_CAP, device="cuda") -> BucketedCSR:
    """Host-side one-shot build from COO arrays (any order; zero-valued
    padding edges welcome), uploaded once to ``device``.

    ``edge_ids[k]`` is the position edge ``k`` occupies in the COO values
    vector that ``refresh_vals`` re-gathers from (default ``k``). ``vals``
    None builds a structure-only template (values zero). Raises if an
    index is out of range: the kernels do not check indices."""
    dev = resolve_device(device)
    e = len(rows)
    if edge_ids is None:
        edge_ids = np.arange(e, dtype=np.int32)
    rows = np.asarray(rows, dtype=np.int64)
    if e and not (rows.min() >= 0 and rows.max() < n_rows and np.min(cols) >= 0
                  and np.max(cols) < n_cols):
        raise ValueError(f"build_bucketed: an edge lies outside the {n_rows} x {n_cols} shape")
    # CSR-derived COO is already row-sorted: the O(E) check skips the argsort
    if e == 0 or np.all(rows[:-1] <= rows[1:]):
        r = rows
        c = np.asarray(cols, dtype=np.int32)
        v = None if vals is None else np.asarray(vals, np.float32)
        eid = np.asarray(edge_ids, dtype=np.int32)
    else:
        order = np.argsort(rows, kind="stable")
        r = rows[order]
        c = np.asarray(cols, dtype=np.int32)[order]
        v = None if vals is None else np.asarray(vals, np.float32)[order]
        eid = np.asarray(edge_ids, dtype=np.int32)[order]

    deg = np.bincount(r, minlength=n_rows).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    caps_per_row = _cap_for_degree(deg, min_cap)

    buckets = []
    total_rows = 0
    gather_pos = np.zeros(n_rows, dtype=np.int64)
    nonzero = deg > 0
    for cap in np.unique(caps_per_row[nonzero]):
        cap = int(cap)
        rows_in = np.where(nonzero & (caps_per_row == cap))[0]
        nb = len(rows_in)
        lens = deg[rows_in]
        starts = indptr[rows_in]
        total = int(lens.sum())
        # flat (bucket-row, slot) coordinates for every real edge
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(starts, lens) + offs
        dst_row = np.repeat(np.arange(nb, dtype=np.int64), lens)

        idx = np.zeros((nb, cap), dtype=np.int32)
        val = np.zeros((nb, cap), dtype=np.float32)
        edge = np.full((nb, cap), -1, dtype=np.int32)
        idx[dst_row, offs] = c[src]
        if v is not None:
            val[dst_row, offs] = v[src]
        edge[dst_row, offs] = eid[src]
        buckets.append((idx, val, edge, cap))
        gather_pos[rows_in] = total_rows + np.arange(nb)
        total_rows += nb
    gather_pos[~nonzero] = total_rows  # the appended zeros row
    node_of_row = np.zeros(total_rows + 1, dtype=np.int64)
    node_of_row[gather_pos] = np.arange(n_rows)
    sep = _detect_separable(r, c, v, n_rows, n_cols)
    sd, ss = _sep_row_vectors(sep, node_of_row, total_rows)

    ridx = [
        _host_ridx(gather_pos, idx, total_rows, n_rows, n_cols,
                   dead=(edge < 0) | (val == 0) if v is not None else (edge < 0))
        for idx, val, edge, _ in buckets
    ]
    caps = tuple(cap for *_, cap in buckets)
    counts = tuple(b[0].shape[0] for b in buckets)
    starts = np.concatenate([[0], np.cumsum([nb * cap for nb, cap in zip(counts, caps)])])
    row_ptr = np.concatenate(
        [s + np.arange(nb, dtype=np.int64) * cap for s, nb, cap in zip(starts, counts, caps)]
        + [[starts[-1], starts[-1]]]
    ).astype(np.int64)

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    work, work_start, n_partials = pull_schedule(torch.from_numpy(row_ptr))
    return BucketedCSR(
        caps=caps,
        counts=counts,
        idx=put(_flat([b[0] for b in buckets], np.int32)),
        val=put(_flat([b[1] for b in buckets], np.float32)),
        edge=put(_flat([b[2] for b in buckets], np.int32)),
        ridx=None if n_rows != n_cols else put(_flat(ridx, np.int32)),
        row_ptr=put(row_ptr),
        work=work.to(dev),
        work_start=work_start.to(dev),
        n_partials=n_partials,
        gather_pos=put(gather_pos.astype(np.int32)),
        node_of_row=put(node_of_row.astype(np.int32)),
        n_rows=n_rows,
        n_cols=n_cols,
        sep_dst=put(sd),
        sep_src_row=put(ss),
    )


def mirrored_transpose(csr: BucketedCSR, e_half: int) -> BucketedCSR:
    """Transpose of a BucketedCSR built over a mirror-layout COO (its second
    half swaps the first's coordinates, as the bipartite templates are):
    the tables are the forward's with the slot→edge map flipped by
    ``e_half``; the separable scales are dropped, as in the JAX package."""
    e = csr.edge
    flipped = torch.where(e >= 0, torch.where(e < e_half, e + e_half, e - e_half), -1)
    return dataclasses.replace(csr, edge=flipped.to(torch.int32), n_rows=csr.n_cols,
                               n_cols=csr.n_rows, sep_dst=None, sep_src_row=None)


def slot_maps(csr: BucketedCSR):
    """Static edge↔slot maps for the scatter-free backward over per-slot
    data (the bucketed GAT's, ``models/gat.py``), built on the host once,
    as the JAX package's, bit for bit. Returns i32 tensors on the tables'
    device:

      * ``pos_map[e]``: the flat slot of COO edge ``e`` in these tables;
      * ``slot_node[s]``: the destination node of flat slot ``s``;
      * ``node_of_row[r]``: the node of concat row ``r`` (``gather_pos``'s
        inverse; degree-0 nodes share the trailing zero row)."""
    flat_edge = csr.edge.cpu().numpy().astype(np.int64)
    rowof = np.repeat(np.arange(csr.total_rows, dtype=np.int64),
                      np.repeat(np.asarray(csr.caps, np.int64), csr.counts))
    valid = flat_edge >= 0
    n_coo = int(flat_edge[valid].max()) + 1 if valid.any() else 1
    pos_map = np.zeros(n_coo, dtype=np.int64)
    pos_map[flat_edge[valid]] = np.nonzero(valid)[0]
    node_of_row = csr.node_of_row.cpu().numpy().astype(np.int64)
    slot_node = node_of_row[rowof]
    dev = csr.idx.device
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (pos_map, slot_node, node_of_row))


def refresh_vals(csr: BucketedCSR, coo_vals: torch.Tensor) -> BucketedCSR:
    """New BucketedCSR with values re-gathered from a COO values vector on
    the device (the augmentation path); the index structure is shared, the
    separable scales are dropped (refreshed values take the value path).

    Contract: refreshed values never resurrect a build-time zero edge
    (``ridx`` routes it to the zero row for good). With the environment
    variable ``RECTPU_DEBUG_CHECKS`` set, this is checked (a host sync)."""
    n = coo_vals.shape[0]
    safe = torch.clamp(csr.edge, 0, n - 1).long()
    val = torch.where(csr.edge >= 0, coo_vals[safe], torch.zeros((), dtype=coo_vals.dtype,
                                                                 device=coo_vals.device))
    if os.environ.get("RECTPU_DEBUG_CHECKS") and csr.ridx is not None:
        bad = int(((csr.edge >= 0) & (csr.ridx == csr.total_rows) & (val != 0)).sum())
        if bad > 0:
            raise RuntimeError(
                f"refresh_vals: {bad} build-time-zero edge slot(s) refreshed to a NONZERO "
                "value. ridx routes such slots to the shared zero row, so the row-space "
                "chain would drop these edges. Rebuild the structure instead."
            )
    return dataclasses.replace(csr, val=val.to(torch.float32), sep_dst=None, sep_src_row=None)


def map_vals(csr: BucketedCSR, fn) -> BucketedCSR:
    """Apply ``fn`` to the value table (e.g. binarization); padding stays 0."""
    val = torch.where(csr.edge >= 0, fn(csr.val), torch.zeros((), device=csr.val.device))
    return dataclasses.replace(csr, val=val.to(torch.float32), sep_dst=None, sep_src_row=None)


# -- propagation --------------------------------------------------------------------


class Ops(NamedTuple):
    """The two primitives the pulls are built from: the kernels' wrappers,
    or (``PLAIN``) their plain versions, which autograd can differentiate."""

    rows: callable
    gsum: callable


KERNELS = Ops(gather_rows, gather_sum)
PLAIN = Ops(gather_rows_plain, gather_sum_plain)


def packs_bf16(compute_dtype: str, d: int) -> bool:
    """Whether the JAX package packs the gathered rows as bf16 at this
    width (``_effective_packer``: only where the packed row keeps >= 64
    f32 words). int8 propagation is not ported."""
    if compute_dtype == "int8":
        raise NotImplementedError(
            "int8 propagation on the bucketed backend is not ported yet "
            "(ROADMAP queue 1, item 15)")
    return compute_dtype == "bfloat16" and -(-d // 2) >= 64


def _source(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """The rows the pull gathers: rounded to bf16 where the JAX package
    packs, else f32."""
    return x.to(torch.bfloat16) if packs_bf16(compute_dtype, x.shape[1]) else x.float()


def pull(csr: BucketedCSR, x: torch.Tensor, compute_dtype: str = "float32",
         ops: Ops = KERNELS) -> torch.Tensor:
    """Node-space ``A @ x`` (f32 [n_rows, d]): P1 over the buckets into
    concat rows plus the zero row, then K7 by ``gather_pos`` (``PLAIN``: their
    plain versions, which autograd can differentiate)."""
    concat = ops.gsum(_source(x, compute_dtype).contiguous(), csr.idx, csr.row_ptr,
                      val=csr.val, schedule=csr.schedule)
    return ops.rows(concat, csr.gather_pos)


def pull_rowspace(csr: BucketedCSR, xp: torch.Tensor, compute_dtype: str = "float32",
                  add: Optional[torch.Tensor] = None, ops: Ops = KERNELS) -> torch.Tensor:
    """Row-space pull of ``xp + add`` (``add`` optional): input and output
    are [R + 1, d] in concat-row order with the last row zero. Separable
    values become two row scalings around a plain sum (the source scaled
    by ``sep_src_row``, the sum by ``sep_dst``); otherwise each slot is
    weighted by its value. ``add`` rides into the kernel unless the sum is
    scaled or rounded before the gather."""
    if csr.ridx is None:
        raise ValueError("pull_rowspace needs a square pattern's row-space tables (ridx)")
    sep = csr.sep_dst is not None
    packed = packs_bf16(compute_dtype, xp.shape[1])
    if add is not None and (sep or packed):
        xp, add = xp + add, None
    if sep:
        xp = xp * csr.sep_src_row[:, None]
    return ops.gsum(_source(xp, compute_dtype).contiguous(), csr.ridx, csr.row_ptr,
                    val=None if sep else csr.val, post=csr.sep_dst if sep else None, add=add,
                    skip=csr.total_rows, schedule=csr.schedule)


def _gather_sum_rowspace(csr: BucketedCSR, y: torch.Tensor, post: Optional[torch.Tensor] = None,
                         ops: Ops = KERNELS, **epilogue):
    """``post ⊙ G(y)``: the plain row-space gather + sum (no values) that
    the separable chain folds its scalings around, with P1's epilogue
    (``acc``, ``final``, ``keep_y``: ``ops/gather.py::gather_sum``)."""
    return ops.gsum(y, csr.ridx, csr.row_ptr, post=post, skip=csr.total_rows,
                    schedule=csr.schedule, **epilogue)


def _folds(csr: BucketedCSR, compute_dtype: str, d: int) -> bool:
    return csr.sep_dst is not None and not packs_bf16(compute_dtype, d)


def _to_rowspace(csr: BucketedCSR, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """[R + 1, d] f32: x's rows in concat-row order (K7), then the zero row."""
    moved = ops.rows(x.contiguous(), csr.node_of_row[: csr.total_rows]).float()
    return torch.cat([moved, moved.new_zeros((1, x.shape[1]))])


def _chain_forward(n_layers: int, compute_dtype: str, fwd: BucketedCSR, x: torch.Tensor,
                   ops: Ops) -> torch.Tensor:
    xp = _to_rowspace(fwd, x, ops)
    if _folds(fwd, compute_dtype, x.shape[1]):
        # y_l = b ⊙ x_l: both scalings fold into one a⊙b per layer,
        # y_l = (a⊙b) ⊙ G(y_{l-1}), unscaled once at the end. The running
        # sum acc_y + y_l and the last scaling by 1/b are P1's epilogue.
        ab, inv_b = fwd.fold_scales
        y = xp * fwd.sep_src_row[:, None]
        acc_y = None  # the first layer's 0 + y_1 is y_1
        for _ in range(n_layers - 1):
            if acc_y is None:
                y = acc_y = _gather_sum_rowspace(fwd, y, post=ab, ops=ops)
            else:
                y, acc_y = _gather_sum_rowspace(fwd, y, post=ab, ops=ops, acc=acc_y,
                                                keep_y=True)
        acc = (torch.zeros_like(xp) if n_layers == 0 else
               _gather_sum_rowspace(fwd, y, post=ab, ops=ops, acc=acc_y, final=inv_b))
    else:
        acc = torch.zeros_like(xp)
        cur = xp
        for _ in range(n_layers):
            cur = pull_rowspace(fwd, cur, compute_dtype, ops=ops)
            acc = acc + cur
    # gather_pos sends degree-0 nodes to the zero row R
    restored = ops.rows(acc, fwd.gather_pos)
    return (x + restored) / (n_layers + 1.0)


def _chain_backward(n_layers: int, compute_dtype: str, fwd: BucketedCSR, bwd: BucketedCSR,
                    g: torch.Tensor) -> torch.Tensor:
    """The cotangent of x: the mirrored Horner chain through ``bwd``,
    Σ_{l=1..L} (Aᵀ)^l gp = Aᵀ(gp + Aᵀ(gp + ...))."""
    gp = _to_rowspace(fwd, g, KERNELS)
    if _folds(bwd, compute_dtype, g.shape[1]):
        # Horner in the fold: z_l = ab ⊙ G(z_{l-1} + gp_b), z_0 = 0. Each
        # pull's epilogue writes the next one's source w = gp_b + z (the
        # first is gp_b itself) and the last pull's the scaling by 1/b.
        ab, inv_b = bwd.fold_scales
        gp_b = gp * bwd.sep_src_row[:, None]
        w = gp_b
        for _ in range(n_layers - 1):
            w = _gather_sum_rowspace(bwd, w, post=ab, acc=gp_b)
        s = (torch.zeros_like(gp) if n_layers == 0 else
             _gather_sum_rowspace(bwd, w, post=ab, final=inv_b))
    else:
        s = torch.zeros_like(gp)
        for _ in range(n_layers):
            s = pull_rowspace(bwd, s, compute_dtype, add=gp)
    restored = gather_rows(s, fwd.gather_pos)
    return ((g + restored) / (n_layers + 1.0)).to(g.dtype)


class BucketedChainMean(torch.autograd.Function):
    """``mean([x, Ax, .., A^L x])`` with a gradient (the JAX package's
    ``custom_vjp``): K7 in, L P1 pulls, K7 out, both ways; the cotangent
    pulls through the transpose ``bwd``. Only ``x`` gets a gradient."""

    @staticmethod
    def forward(ctx, x, n_layers, compute_dtype, fwd, bwd):
        ctx.args = (n_layers, compute_dtype, fwd, bwd)
        return _chain_forward(n_layers, compute_dtype, fwd, x, KERNELS)

    @staticmethod
    def backward(ctx, g):
        n_layers, compute_dtype, fwd, bwd = ctx.args
        dx = _chain_backward(n_layers, compute_dtype, fwd, bwd, g.contiguous())
        return dx, None, None, None, None


def bucketed_chain_mean(n_layers: int, compute_dtype: str, fwd: BucketedCSR, bwd: BucketedCSR,
                        x: torch.Tensor) -> torch.Tensor:
    """Fused ``mean([x, Ax, .., A^L x])`` (f32 [n, d]) in permuted row
    space. Requires ``fwd`` and ``bwd`` to share ``gather_pos``
    (``DeviceAdj.sym_rowspace``)."""
    return BucketedChainMean.apply(x, n_layers, compute_dtype, fwd, bwd)


def bucketed_chain_mean_plain(n_layers: int, compute_dtype: str, fwd: BucketedCSR,
                              x: torch.Tensor) -> torch.Tensor:
    """The same forward chain through the plain versions of K7 and P1, on
    any device; autograd differentiates it (the reference for the kernels
    and for ``BucketedChainMean``'s backward)."""
    return _chain_forward(n_layers, compute_dtype, fwd, x, PLAIN)


class BucketedMatmul(torch.autograd.Function):
    """``A @ x`` with ``Aᵀ g`` as its backward: ``pull`` through ``fwd``,
    then through ``bwd``, in the same dtype. Only ``x`` gets a gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, compute_dtype):
        ctx.args = (bwd, compute_dtype)
        return pull(fwd, x, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        bwd, compute_dtype = ctx.args
        return pull(bwd, g.contiguous(), compute_dtype).to(g.dtype), None, None, None


def bucketed_matmul(fwd: BucketedCSR, bwd: BucketedCSR, x: torch.Tensor,
                    compute_dtype: str = "float32") -> torch.Tensor:
    """``A @ x`` where ``fwd`` encodes A and ``bwd`` encodes Aᵀ."""
    return BucketedMatmul.apply(x, fwd, bwd, compute_dtype)
