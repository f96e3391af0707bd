"""Segment views and the segment kernels S1, S2 and S3, with their plain
versions (the segment backend and the neighbour models' sums).

The JAX package sums over edges with XLA's ``segment_sum`` and
``segment_max`` (``recommendation_tpu/ops/spmm.py:34-99``,
``models/gat.py:35-60``, ``models/graphsage.py:36-40``). On the card those
would be scatters with float atomics, whose sums change from run to run.
The port sums over a **row-sorted view** instead: ``SegmentCSR`` is one
static COO structure sorted by its rows with a stable sort, so row r owns
the slots ``[row_ptr[r], row_ptr[r+1])`` in the COO's order, and every sum
over a row has one fixed order. ``perm`` maps a slot to its COO position,
so per-edge values and masks given in the JAX package's edge order are put
in slot order by one gather. A view is built once per structure; its
transpose view (sorted by the columns) is built the same way, and
``transpose_map`` pairs the two views' slots.

Kernels, ``csrc/segment.cu`` (built for ``sm_90a`` at first use):

  * S1 ``weighted_pull(x, w, idx, row_ptr, schedule)``:
    ``y[r, h, :] = Σ_s w[s, h] · x[idx[s], h, :]``, the multi-head pull
    (GAT's aggregation);
  * S1 with the head dot ``weighted_pull_dot(g, w, idx, row_ptr, fpos,
    hsrc, node, schedule)``: the same pull over a transpose view with the
    weights read at each slot's forward slot ``fpos`` (GAT's ``dh``), and
    S3 folded in: ``dot[fpos[t], h] = g[idx[t], h] · hsrc[node(r), h]``,
    S1's weight gradient, each gathered row dotted with its row's source
    row as it arrives;
  * S2 ``attention_softmax(a_src, a_dst, idx, dst, row_ptr, live,
    neg_slope, schedule, keep)``: GAT's logits ``LeakyReLU(a_src[idx] +
    a_dst[dst])`` and the softmax of each row's live slots per head, with
    ``att · keep`` beside it; ``attention_softmax_bwd``: its backward,
    ``att · (datt·keep − Σ_row att · datt·keep)`` times the LeakyReLU's
    slope, 0 at dead slots. ``segment_softmax_rows`` / ``_bwd`` are the
    same kernels on given logits (no gather, no slope): the softmax and
    ``att · (g − Σ_row att · g)``. Each runs on the rows' work list
    (``pull_schedule``): one launch, and a second over the split rows'
    pieces where a row is split.

``segment_dot(a, ia, b, ib)`` (``out[s, h] = a[ia[s], h] · b[ib[s], h]``)
stays as the reference of the folded dot: it runs on CPU tensors only.

The single-head sums over a view (the segment matmul, the masked mean, the
per-row and per-source sums of GAT's logit gradients) are kernel P2,
``csrc/segment_sum.cu``:

  * P2 ``segment_sum(src, view, val, post, idx)``: ``y[r] = post[r] ·
    Σ_{s ∈ row r} val[s] · src[idx[s]]``, P1's function (``ops/gather.py::
    gather_sum``; its plain version ``gather_sum_plain`` is P2's too) over
    the view's rows, whose lengths mix. It runs on a work list of its own,
    ``sum_schedule``: runs of consecutive rows of at most ``CHUNK`` slots
    and ``SUM_ROWS`` rows together, and the ``CHUNK``-slot pieces of longer
    rows, counted from each row's first slot as P1 counts them, so P2
    equals P1 over the same view bit for bit, and a row sums alike in a
    whole view and in its cuts (``row_range_view``, ``rows_transpose_view``).
    P1 stays the bucket rows' pull.

For CUDA tensors each kernel's wrapper launches its kernel or raises; CPU
tensors run the plain version. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recommendation_tpu_torch.ops.gather import (
    CHUNK,
    _check_device,
    _ptr,
    check_schedule,
    gather_sum_plain,
    pull_schedule,
)

SUM_ROWS = 32  # rows a P2 work item holds at most (csrc/segment_sum.cu's MAX_ROWS)


def sum_schedule(row_ptr) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """P2's work list for the rows of ``row_ptr`` (int64, on the device the
    kernel runs on): i32 [W, 4] items and i64 [W + 1] each item's first slot
    (the items cover the slots in order, so item w ends where w + 1 starts),
    and the number of partial sums the split rows need. An item is a run of
    consecutive rows of at most ``CHUNK`` slots and ``SUM_ROWS`` rows
    together, empty rows included: (its first row, its rows, -1, 0); or one
    ``CHUNK``-slot piece of a longer row, counted from the row's first slot:
    (the row, the piece, the row's first partial, the row's pieces), the
    partials numbered as ``pull_schedule`` numbers them. A run is taken
    greedily from its first row. Built on the host (it reads ``row_ptr``)."""
    ptr = row_ptr.cpu().numpy().astype(np.int64)
    n = len(ptr) - 1
    lens = np.diff(ptr)
    split = lens > CHUNK
    pieces = np.where(split, -(-lens // CHUNK), 0)
    first = np.cumsum(pieces) - pieces
    # a run from row r ends at the row that would take it past CHUNK slots
    # (a split row does), or at row r + SUM_ROWS
    run_end = np.minimum(np.searchsorted(ptr, ptr[:-1] + CHUNK, side="right") - 1,
                         np.arange(n) + SUM_ROWS)
    heads, r = [], 0
    while r < n:  # one step a run or a split row
        heads.append(r)
        r = r + 1 if split[r] else int(run_end[r])
    heads = np.asarray(heads, dtype=np.int64)
    is_run = ~split[heads]
    count = np.where(is_run, 1, pieces[heads])  # items a step gives
    rows = np.repeat(heads, count)
    piece = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
    ends = np.append(heads[1:], n)
    run = np.repeat(is_run, count)
    work = np.stack([rows, np.where(run, np.repeat(ends - heads, count), piece),
                     np.where(run, -1, first[rows]), np.where(run, 0, pieces[rows])], axis=1)
    starts = np.append(ptr[rows] + np.where(run, 0, piece * CHUNK), ptr[-1]).astype(np.int64)
    dev = row_ptr.device
    return (torch.from_numpy(work.astype(np.int32).reshape(-1, 4)).to(dev),
            torch.from_numpy(starts).to(dev), int(pieces.sum()))


@dataclasses.dataclass
class SegmentCSR:
    """A COO structure sorted by its rows (a stable sort: equal rows keep
    their COO order). ``row_ptr`` i64 [n_rows + 1]; ``idx`` i32 [S] the
    column (source) of each slot; ``slot_row`` i32 [S] the row of each
    slot; ``perm`` i64 [S] each slot's COO position; ``work``,
    ``work_start`` and ``n_partials`` are S1's and S2's schedule over the
    rows (``ops/gather.py::pull_schedule``); ``sums`` is P2's
    (``sum_schedule``)."""

    row_ptr: torch.Tensor
    idx: torch.Tensor
    slot_row: torch.Tensor
    perm: torch.Tensor
    work: torch.Tensor
    work_start: torch.Tensor
    n_partials: int
    sums: Tuple[torch.Tensor, torch.Tensor, int]
    n_rows: int
    n_cols: int

    @property
    def schedule(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        return self.work, self.work_start, self.n_partials

    @property
    def n_slots(self) -> int:
        return int(self.idx.shape[0])

    @functools.cached_property
    def ident(self) -> torch.Tensor:
        """i32 [S] 0, 1, .., S − 1: P2 over these sums per-slot rows by row."""
        return torch.arange(self.n_slots, dtype=torch.int32, device=self.idx.device)


def segment_csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int, n_cols: int) -> SegmentCSR:
    """The row-sorted view of the COO (rows, cols) on their device: a
    stable sort by row, then the row pointers from the row counts (integer
    sums) and the kernels' schedules (a host read of the row pointers)."""
    rows = rows.long()
    perm = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=n_rows)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    work, work_start, n_partials = pull_schedule(row_ptr)
    return SegmentCSR(row_ptr=row_ptr, idx=cols[perm].to(torch.int32).contiguous(),
                      slot_row=rows[perm].to(torch.int32).contiguous(), perm=perm, work=work,
                      work_start=work_start, n_partials=n_partials,
                      sums=sum_schedule(row_ptr), n_rows=n_rows, n_cols=n_cols)


def row_cut(row_ptr: torch.Tensor, parts: int) -> Tuple[Tuple[int, int], ...]:
    """``parts`` contiguous row ranges ``(lo, hi)`` that cover a view's rows
    in order, each of about S / parts slots: the k-th cut is the row
    boundary nearest k·S / parts (the lower on a tie, the first of equal
    boundaries), so a range's slots are within one row's slots of
    S / parts. Read on the host from ``row_ptr``: every rank computes the
    same cut."""
    if parts < 1:
        raise ValueError(f"row_cut: parts must be at least 1, got {parts}")
    ptr = row_ptr.cpu().numpy()
    total = int(ptr[-1])
    bounds = [0]
    for k in range(1, parts):
        j = int(np.searchsorted(ptr * parts, k * total))  # the first boundary at the target or past
        if j > 0 and k * total - int(ptr[j - 1]) * parts <= int(ptr[j]) * parts - k * total:
            j = int(np.searchsorted(ptr, ptr[j - 1]))  # the lower one: its first boundary
        bounds.append(max(j, bounds[-1]))
    bounds.append(len(ptr) - 1)
    ranges = tuple(zip(bounds[:-1], bounds[1:]))
    check_row_cut(ranges, row_ptr)
    return ranges


def check_row_cut(ranges, row_ptr: torch.Tensor) -> None:
    """Raise unless ``ranges`` cover the rows of ``row_ptr`` exactly once,
    in order (each range starts where the last ended, the first at row 0,
    the last ends at the last row), and so every slot exactly once."""
    n_rows = row_ptr.shape[0] - 1
    at = 0
    for part, (lo, hi) in enumerate(ranges):
        if lo != at or hi < lo:
            raise ValueError(f"row cut {list(ranges)}: range {part} is [{lo}, {hi}), where rows "
                             f"from {at} on were due: a row is in no range or in two")
        at = hi
    if at != n_rows:
        raise ValueError(f"row cut {list(ranges)} ends at row {at} of {n_rows}")


def row_range_view(view: SegmentCSR, lo: int, hi: int) -> SegmentCSR:
    """Rows ``[lo, hi)`` of ``view`` as a view of their own (row r − lo of
    it is row r), their slots in the same order, with its own schedules.
    P2 sums each of its rows as it sums that row of ``view``: a row's
    pieces depend on its length and ``CHUNK`` only."""
    ptr = view.row_ptr.cpu()
    s0, s1 = int(ptr[lo]), int(ptr[hi])
    row_ptr = (view.row_ptr[lo:hi + 1] - s0).contiguous()
    work, work_start, n_partials = pull_schedule(row_ptr)
    return SegmentCSR(row_ptr=row_ptr, idx=view.idx[s0:s1].clone(),
                      slot_row=(view.slot_row[s0:s1] - lo).to(torch.int32),
                      perm=view.perm[s0:s1].clone(), work=work, work_start=work_start,
                      n_partials=n_partials, sums=sum_schedule(row_ptr), n_rows=hi - lo,
                      n_cols=view.n_cols)


def rows_transpose_view(view_t: SegmentCSR, lo: int, hi: int) -> SegmentCSR:
    """The slots of the transpose view ``view_t`` whose forward row (their
    ``idx``) lies in ``[lo, hi)``, in their order, that index rebased to
    ``lo``: the transpose of ``row_range_view(view, lo, hi)``, every row of
    ``view_t`` kept (most of them shorter), with its own schedules. P2
    over it pulls rows ``[lo, hi)`` of a gradient back to all of
    ``view_t``'s rows."""
    keep = (view_t.idx >= lo) & (view_t.idx < hi)
    rows = view_t.slot_row[keep].long()
    counts = torch.bincount(rows, minlength=view_t.n_rows)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    work, work_start, n_partials = pull_schedule(row_ptr)
    return SegmentCSR(row_ptr=row_ptr, idx=(view_t.idx[keep] - lo).to(torch.int32),
                      slot_row=rows.to(torch.int32), perm=view_t.perm[keep], work=work,
                      work_start=work_start, n_partials=n_partials, sums=sum_schedule(row_ptr),
                      n_rows=view_t.n_rows, n_cols=hi - lo)


def transpose_map(fwd: SegmentCSR, bwd: SegmentCSR) -> torch.Tensor:
    """i64 [S]: for each slot of ``bwd`` (the transpose view of the same
    COO), the slot of ``fwd`` that holds the same COO position."""
    inv = torch.empty_like(fwd.perm)
    inv[fwd.perm] = torch.arange(fwd.n_slots, device=fwd.perm.device)
    return inv[bwd.perm]


def slot_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    """i64 [S]: the row of each slot of a CSR row pointer."""
    n_rows = row_ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n_rows, device=row_ptr.device),
                                   torch.diff(row_ptr))


# -- plain versions (autograd differentiates them; any float type) -----------------


def weighted_pull_plain(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                        row_ptr: torch.Tensor, schedule=None) -> torch.Tensor:
    """S1 in plain torch: the [S, H, D] messages ``w · x[idx]`` added into
    their rows (``index_add``)."""
    del schedule
    heads = w.shape[1]
    xh = x.reshape(x.shape[0], heads, -1)
    msgs = xh[idx.long()] * w[:, :, None]
    out = torch.zeros((row_ptr.shape[0] - 1,) + tuple(xh.shape[1:]), dtype=msgs.dtype,
                      device=x.device)
    return out.index_add(0, slot_rows(row_ptr), msgs)


def segment_softmax_rows_plain(e: torch.Tensor, row_ptr: torch.Tensor,
                               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S2's forward in plain torch (the JAX package's masked segment
    softmax: the max over live slots, 0 where none is live, exp, the sum,
    the division with + 1e-16; dead slots 0). The max is a constant shift
    and takes no gradient."""
    rows = slot_rows(row_ptr)
    n_rows = row_ptr.shape[0] - 1
    live_b = (torch.ones(e.shape[0], dtype=torch.bool, device=e.device) if live is None
              else live.bool())[:, None]
    masked = torch.where(live_b, e, torch.full_like(e, float("-inf")))
    m = torch.full((n_rows, e.shape[1]), float("-inf"), dtype=e.dtype,
                   device=e.device).scatter_reduce(
        0, rows[:, None].expand_as(e), masked.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.where(live_b, torch.exp(e - m[rows]), torch.zeros_like(e))
    denom = torch.zeros((n_rows, e.shape[1]), dtype=e.dtype, device=e.device).index_add(
        0, rows, ex)
    return ex / (denom[rows] + 1e-16)


def segment_softmax_rows_bwd_plain(att: torch.Tensor, g: torch.Tensor,
                                   row_ptr: torch.Tensor) -> torch.Tensor:
    """S2's backward in plain torch: ``att · (g − Σ_row att · g)``."""
    rows = slot_rows(row_ptr)
    dot = torch.zeros((row_ptr.shape[0] - 1, att.shape[1]), dtype=att.dtype,
                      device=att.device).index_add(0, rows, att * g)
    return att * (g - dot[rows])


def logits_plain(a_src: torch.Tensor, a_dst: torch.Tensor, idx: torch.Tensor,
                 dst: torch.Tensor, neg_slope: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAT's per-slot logits in plain torch: ``z = a_src[idx] + a_dst[dst]``
    and ``e = LeakyReLU(z, neg_slope)``, [S, H] each."""
    z = a_src[idx.long()] + a_dst[dst.long()]
    return z, F.leaky_relu(z, neg_slope)


def attention_softmax_plain(a_src: torch.Tensor, a_dst: torch.Tensor, idx: torch.Tensor,
                            dst: torch.Tensor, row_ptr: torch.Tensor,
                            live: Optional[torch.Tensor], neg_slope: float, schedule=None,
                            keep: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S2's fused forward in plain torch: ``logits_plain``, then
    ``segment_softmax_rows_plain``; ``(att, w)`` with ``w = att · keep``
    (``att`` itself where ``keep`` is None)."""
    del schedule
    _, e = logits_plain(a_src, a_dst, idx, dst, neg_slope)
    att = segment_softmax_rows_plain(e, row_ptr, live)
    return att, att if keep is None else att * keep


def attention_softmax_bwd_plain(att: torch.Tensor, datt: torch.Tensor, a_src: torch.Tensor,
                                a_dst: torch.Tensor, idx: torch.Tensor, dst: torch.Tensor,
                                row_ptr: torch.Tensor, live: Optional[torch.Tensor],
                                neg_slope: float, schedule=None,
                                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S2's fused backward in plain torch: the cotangent of the logits' sum
    ``z`` given ``att`` and its cotangent ``datt``: ``g = datt · keep``,
    ``de = att · (g − Σ_row att · g)``, ``dz = live ? de · (z ≥ 0 ? 1 :
    neg_slope) : 0`` with ``z`` recomputed from ``a_src`` and ``a_dst``."""
    del schedule
    g = datt if keep is None else datt * keep
    de = segment_softmax_rows_bwd_plain(att, g, row_ptr)
    z, _ = logits_plain(a_src, a_dst, idx, dst, neg_slope)
    slope = torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, neg_slope))
    if live is None:
        return de * slope
    return torch.where(live.bool()[:, None], de * slope, torch.zeros_like(de))


def segment_dot_plain(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """S3 in plain torch: the [S, H, D] gathers multiplied and summed."""
    ah = a.reshape(a.shape[0], heads, -1)
    bh = b.reshape(b.shape[0], heads, -1)
    return torch.sum(ah[ia.long()] * bh[ib.long()], dim=2)


def weighted_pull_dot_plain(g: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                            row_ptr: torch.Tensor, fpos: torch.Tensor, hsrc: torch.Tensor,
                            node: Optional[torch.Tensor] = None, schedule=None):
    """S1 with the head dot in plain torch: ``weighted_pull_plain`` with the
    weights gathered at ``fpos`` (0 where it is -1), and ``segment_dot_plain``
    of each slot's gathered row with its row's node's ``hsrc`` row, written
    at ``fpos`` where the slot is live (every other forward slot 0)."""
    del schedule
    live = fpos >= 0
    at = fpos.long().clamp(min=0)
    wt = torch.where(live[:, None], w[at], torch.zeros((), dtype=w.dtype, device=w.device))
    dh = weighted_pull_plain(g, wt, idx, row_ptr)
    rows = slot_rows(row_ptr)
    nodes = rows if node is None else node.long()[rows]
    d = segment_dot_plain(g, idx, hsrc, nodes, w.shape[1])
    dot = torch.zeros(w.shape, dtype=d.dtype, device=d.device)
    dot[at[live]] = d[live]
    return dh, dot


# -- the kernels' wrappers ----------------------------------------------------------


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("segment")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pull = [ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] + [ptr]
        lib.segment_pull.argtypes = pull + [ptr]
        lib.segment_pull_dot.argtypes = pull + [ptr] * 4 + [i64, ptr]
        f32 = ctypes.c_float
        lib.segment_softmax_fwd.argtypes = ([ptr] * 2 + [i32] * 2 + [ptr] * 6 + [f32]
                                            + [ptr] * 6 + [i32, ptr])
        lib.segment_softmax_bwd.argtypes = ([ptr] * 2 + [i32] * 2 + [ptr] * 8 + [f32]
                                            + [ptr] * 4 + [i32, ptr])
        for fn in (lib.segment_pull, lib.segment_pull_dot, lib.segment_softmax_fwd,
                   lib.segment_softmax_bwd):
            fn.restype = i32
        lib.segment_error_string.argtypes = [i32]
        lib.segment_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name, fn, *args):
    lib = _kernel_lib()
    code = getattr(lib, fn)(*args)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.segment_error_string(code).decode()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_f32(name, **tensors):
    for k, t in tensors.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 {k}, got {t.dtype}")


def _check_row_ptr(name, row_ptr):
    if row_ptr.dtype != torch.int64:
        raise TypeError(f"{name} takes an int64 row_ptr, got {row_ptr.dtype}")


def weighted_pull(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, row_ptr: torch.Tensor,
                  schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
                  ) -> torch.Tensor:
    """S1: f32 [R, H, D], ``y[r, h] = Σ_{s ∈ row r} w[s, h] · x[idx[s], h]``.

    ``x`` [N, H·D] or [N, H, D] float32; ``w`` [S, H] float32; ``idx`` [S]
    int32; ``row_ptr`` [R + 1] int64 from 0 to S; ``schedule`` the work list
    ``pull_schedule(row_ptr)`` (built here, with a host read, when None).
    CUDA tensors run kernel S1 (one launch), CPU tensors
    ``weighted_pull_plain``."""
    if w.dim() != 2 or idx.dim() != 1 or row_ptr.dim() != 1 or w.shape[0] != idx.shape[0]:
        raise ValueError(f"weighted_pull wants w [S, H], idx [S], row_ptr [R + 1], got "
                         f"{tuple(w.shape)}, {tuple(idx.shape)}, {tuple(row_ptr.shape)}")
    heads = w.shape[1]
    if x.shape[0] and x[0].numel() % heads:
        raise ValueError(f"weighted_pull: x rows of {x[0].numel()} do not split into {heads} heads")
    _check_f32("weighted_pull", x=x, w=w)
    if idx.dtype != torch.int32 or row_ptr.dtype != torch.int64:
        raise TypeError("weighted_pull takes int32 idx and int64 row_ptr")
    _check_device("weighted_pull", [x, w, idx, row_ptr])
    if x.device.type == "cpu":
        return weighted_pull_plain(x, w, idx, row_ptr)
    d_head = x[0].numel() // heads if x.shape[0] else 0
    out = torch.empty((row_ptr.shape[0] - 1, heads, d_head), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    _pull("weighted_pull", "segment_pull", x, w, idx, row_ptr, schedule, out)
    weighted_pull.launches += 1
    return out


weighted_pull.launches = 0


def _pull(name, fn, x, w, idx, row_ptr, schedule, out, *extra):
    """One launch of S1 (``fn`` ``segment_pull``, or ``segment_pull_dot``
    with its ``extra`` arguments) into ``out`` [R, H, D], with the split
    rows' scratch."""
    heads, d_head = out.shape[1], out.shape[2]
    work, work_start, n_partials = check_schedule(
        name, pull_schedule(row_ptr) if schedule is None else schedule, x.device)
    partial = count = None
    if n_partials:
        partial = torch.empty((n_partials, heads * d_head), dtype=torch.float32, device=x.device)
        count = torch.empty(n_partials, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(name, fn, x.data_ptr(), w.data_ptr(), idx.data_ptr(), work.data_ptr(),
                work_start.data_ptr(), work.shape[0], heads, d_head,
                None if partial is None else partial.data_ptr(),
                None if count is None else count.data_ptr(), n_partials, out.data_ptr(),
                *extra, _stream(x))


def weighted_pull_dot(g: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                      row_ptr: torch.Tensor, fpos: torch.Tensor, hsrc: torch.Tensor,
                      node: Optional[torch.Tensor] = None,
                      schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S1 over a transpose view with S3 folded in: ``(dh, dot)``.

    ``dh`` f32 [R, H, D]: ``dh[r, h] = Σ_{t ∈ row r, fpos[t] >= 0} w[fpos[t], h]
    · g[idx[t], h]``; ``dot`` f32 [S_f, H]: ``dot[fpos[t], h] = Σ_k g[idx[t], h, k]
    · hsrc[node[r], h, k]`` for every live slot t of row r, 0 at every
    forward slot no live slot reaches. The live slots must map one to one
    onto forward slots (each is written once).

    ``g`` and ``hsrc`` [*, H·D] or [*, H, D] float32; ``w`` [S_f, H]
    float32, the forward weights; ``idx`` [S] int32; ``row_ptr`` [R + 1]
    int64 from 0 to S; ``fpos`` [S] int32, each slot's forward slot, -1
    where it is dead; ``node`` [R] int32, each row's hsrc row (None: the
    row itself); ``schedule`` as ``weighted_pull``'s. CUDA tensors run
    kernel S1's fused variant (one launch), CPU tensors
    ``weighted_pull_dot_plain``."""
    if (w.dim() != 2 or idx.dim() != 1 or row_ptr.dim() != 1 or fpos.shape != idx.shape
            or (node is not None and node.shape != (row_ptr.shape[0] - 1,))):
        raise ValueError(f"weighted_pull_dot wants w [S_f, H], idx and fpos [S], row_ptr "
                         f"[R + 1], node [R], got {tuple(w.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(fpos.shape)}, {tuple(row_ptr.shape)}, "
                         f"{None if node is None else tuple(node.shape)}")
    heads = w.shape[1]
    width = g[0].numel() if g.shape[0] else hsrc[0].numel()
    if width % heads or (g.shape[0] and hsrc.shape[0] and hsrc[0].numel() != width):
        raise ValueError(f"weighted_pull_dot: g rows of {width} and hsrc rows of "
                         f"{hsrc[0].numel() if hsrc.shape[0] else 0} in {heads} heads")
    _check_f32("weighted_pull_dot", g=g, w=w, hsrc=hsrc)
    if (idx.dtype != torch.int32 or fpos.dtype != torch.int32 or row_ptr.dtype != torch.int64
            or (node is not None and node.dtype != torch.int32)):
        raise TypeError("weighted_pull_dot takes int32 idx, fpos and node and int64 row_ptr")
    _check_device("weighted_pull_dot",
                  [t for t in (g, w, idx, row_ptr, fpos, hsrc, node) if t is not None])
    if g.device.type == "cpu":
        return weighted_pull_dot_plain(g, w, idx, row_ptr, fpos, hsrc, node)
    d_head = width // heads
    dh = torch.empty((row_ptr.shape[0] - 1, heads, d_head), dtype=torch.float32,
                     device=g.device)
    dot = torch.empty(w.shape, dtype=torch.float32, device=g.device)
    if dh.numel() == 0 or idx.shape[0] == 0:
        return dh.zero_(), dot.zero_()
    _pull("weighted_pull_dot", "segment_pull_dot", g, w, idx, row_ptr, schedule, dh,
          fpos.data_ptr(), hsrc.data_ptr(), None if node is None else node.data_ptr(),
          dot.data_ptr(), w.shape[0])
    weighted_pull_dot.launches += 1
    return dh, dot


weighted_pull_dot.launches = 0


def _live_u8(live: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The kernel's view of ``live``: one byte a slot, 0 dead (a bool
    tensor as it is)."""
    if live is None:
        return None
    return live.view(torch.uint8) if live.dtype == torch.bool else (live != 0).view(torch.uint8)


def _softmax(name, fn, row_ptr, schedule, heads, device, *operands):
    """One call of S2 (``fn`` ``segment_softmax_fwd`` or ``_bwd`` with its
    ``operands``, pointers and the slope) on the rows' work list, with the
    split rows' scratch: per piece the statistics (the forward's (max,
    sum), the backward's sum) and its work item, and the rows' counters.
    Returns its launches: one, and one more over the split rows' pieces."""
    work, work_start, n_partials = check_schedule(
        name, pull_schedule(row_ptr) if schedule is None else schedule, device)
    stat = count = piece = None
    if n_partials:
        stat = torch.empty((n_partials, 2 * heads), dtype=torch.float32, device=device)
        count = torch.empty(n_partials, dtype=torch.int32, device=device)
        piece = torch.empty(n_partials, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _launch(name, fn, work.data_ptr(), work_start.data_ptr(), work.shape[0], heads,
                *operands, _ptr(stat), _ptr(count), _ptr(piece), n_partials,
                torch.cuda.current_stream(device).cuda_stream)
    return 2 if n_partials else 1


def _check_rows(name, n_slots, row_ptr, live):
    if row_ptr.dim() != 1 or (live is not None and live.shape != (n_slots,)):
        raise ValueError(f"{name} wants row_ptr [R + 1] and live [S] = [{n_slots}], got "
                         f"{tuple(row_ptr.shape)}, {None if live is None else tuple(live.shape)}")
    _check_row_ptr(name, row_ptr)


def segment_softmax_rows(e: torch.Tensor, row_ptr: torch.Tensor,
                         live: Optional[torch.Tensor] = None,
                         schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
                         ) -> torch.Tensor:
    """S2's forward on given logits: f32 [S, H], the softmax of each row's
    live slots per head (``live`` bool [S], None for all), dead slots 0.
    ``schedule`` is the rows' work list ``pull_schedule(row_ptr)`` (built
    here, with a host read, when None). CUDA tensors run kernel S2 without
    its logits (one or two launches), CPU tensors
    ``segment_softmax_rows_plain``."""
    if e.dim() != 2:
        raise ValueError(f"segment_softmax_rows wants e [S, H], got {tuple(e.shape)}")
    _check_rows("segment_softmax_rows", e.shape[0], row_ptr, live)
    _check_f32("segment_softmax_rows", e=e)
    _check_device("segment_softmax_rows", [t for t in (e, row_ptr, live) if t is not None])
    if e.device.type == "cpu":
        return segment_softmax_rows_plain(e, row_ptr, live)
    att = torch.empty_like(e)
    if e.numel() == 0 or row_ptr.shape[0] < 2:
        return att.zero_()
    segment_softmax_rows.launches += _softmax(
        "segment_softmax_rows", "segment_softmax_fwd", row_ptr, schedule, e.shape[1], e.device,
        e.data_ptr(), None, None, None, None, _ptr(_live_u8(live)), 0.0, None, att.data_ptr(),
        None)
    return att


segment_softmax_rows.launches = 0


def segment_softmax_rows_bwd(att: torch.Tensor, g: torch.Tensor, row_ptr: torch.Tensor,
                             schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
                             ) -> torch.Tensor:
    """S2's backward on given logits: f32 [S, H], ``att · (g − Σ_row att ·
    g)``. CUDA tensors run kernel S2's backward without the slope and mask
    (one or two launches), CPU tensors ``segment_softmax_rows_bwd_plain``."""
    if att.dim() != 2 or g.shape != att.shape:
        raise ValueError(f"segment_softmax_rows_bwd wants att and g [S, H], got "
                         f"{tuple(att.shape)}, {tuple(g.shape)}")
    _check_rows("segment_softmax_rows_bwd", att.shape[0], row_ptr, None)
    _check_f32("segment_softmax_rows_bwd", att=att, g=g)
    _check_device("segment_softmax_rows_bwd", [att, g, row_ptr])
    if att.device.type == "cpu":
        return segment_softmax_rows_bwd_plain(att, g, row_ptr)
    de = torch.empty_like(att)
    if att.numel() == 0 or row_ptr.shape[0] < 2:
        return de.zero_()
    segment_softmax_rows_bwd.launches += _softmax(
        "segment_softmax_rows_bwd", "segment_softmax_bwd", row_ptr, schedule, att.shape[1],
        att.device, att.data_ptr(), g.data_ptr(), None, None, None, None, None, None, 0.0,
        de.data_ptr())
    return de


segment_softmax_rows_bwd.launches = 0


def _check_attention(name, a_src, a_dst, idx, dst, row_ptr, live, keep, *slot_values):
    """The fused entries' operands: a_src, a_dst [N, H] f32; idx, dst [S]
    int32; keep and each of ``slot_values`` [S, H] f32; live [S]."""
    n_slots = idx.shape[0] if idx.dim() == 1 else -1
    heads = a_src.shape[1] if a_src.dim() == 2 else -1
    if (a_src.dim() != 2 or a_dst.dim() != 2 or a_dst.shape[1] != heads or idx.dim() != 1
            or dst.shape != idx.shape
            or any(t is not None and t.shape != (n_slots, heads) for t in (keep, *slot_values))):
        raise ValueError(f"{name} wants a_src, a_dst [N, H], idx and dst [S], keep [S, H], got "
                         f"{tuple(a_src.shape)}, {tuple(a_dst.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(dst.shape)}, {None if keep is None else tuple(keep.shape)}")
    _check_rows(name, n_slots, row_ptr, live)
    _check_f32(name, a_src=a_src, a_dst=a_dst, keep=keep,
               **{f"input {k}": t for k, t in enumerate(slot_values)})
    if idx.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 idx and dst, got {idx.dtype}, {dst.dtype}")
    _check_device(name, [t for t in (a_src, a_dst, idx, dst, row_ptr, live, keep, *slot_values)
                         if t is not None])


def attention_softmax(a_src: torch.Tensor, a_dst: torch.Tensor, idx: torch.Tensor,
                      dst: torch.Tensor, row_ptr: torch.Tensor, live: Optional[torch.Tensor],
                      neg_slope: float,
                      schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
                      keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """S2 with GAT's logits: ``(att, w)``, f32 [S, H] each. ``att`` is the
    softmax over each row's live slots of ``LeakyReLU(a_src[idx] +
    a_dst[dst], neg_slope)`` per head, dead slots 0; ``w = att · keep``
    (``att`` itself where ``keep`` is None).

    ``a_src``, ``a_dst`` [N, H] float32; ``idx``, ``dst`` [S] int32 each
    slot's source and destination node; ``row_ptr`` [R + 1] int64 from 0 to
    S; ``live`` bool [S] (None: all live); ``keep`` [S, H] float32, the
    dropout's scale; ``schedule`` as ``segment_softmax_rows``'. CUDA tensors
    run kernel S2 with the logits fused in (one or two launches), CPU
    tensors ``attention_softmax_plain``."""
    _check_attention("attention_softmax", a_src, a_dst, idx, dst, row_ptr, live, keep)
    if a_src.device.type == "cpu":
        return attention_softmax_plain(a_src, a_dst, idx, dst, row_ptr, live, neg_slope,
                                       keep=keep)
    att = torch.empty((idx.shape[0], a_src.shape[1]), dtype=torch.float32, device=a_src.device)
    w = att if keep is None else torch.empty_like(att)
    if att.numel() == 0 or row_ptr.shape[0] < 2:
        return att.zero_(), w.zero_()
    attention_softmax.launches += _softmax(
        "attention_softmax", "segment_softmax_fwd", row_ptr, schedule, att.shape[1],
        att.device, None, a_src.data_ptr(), a_dst.data_ptr(), idx.data_ptr(), dst.data_ptr(),
        _ptr(_live_u8(live)), float(neg_slope), _ptr(keep), att.data_ptr(),
        None if keep is None else w.data_ptr())
    return att, w


attention_softmax.launches = 0


def attention_softmax_bwd(att: torch.Tensor, datt: torch.Tensor, a_src: torch.Tensor,
                          a_dst: torch.Tensor, idx: torch.Tensor, dst: torch.Tensor,
                          row_ptr: torch.Tensor, live: Optional[torch.Tensor], neg_slope: float,
                          schedule: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
                          keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S2's backward with the logits': f32 [S, H], the cotangent of ``z =
    a_src[idx] + a_dst[dst]`` given ``att`` and its cotangent ``datt``:
    ``de = att · (g − Σ_row att · g)`` with ``g = datt · keep``, times the
    LeakyReLU's slope at ``z`` (recomputed from ``a_src`` and ``a_dst``), 0
    at dead slots. Operands as ``attention_softmax``'s. CUDA tensors run
    kernel S2's backward with the slope and mask fused in (one or two
    launches), CPU tensors ``attention_softmax_bwd_plain``."""
    _check_attention("attention_softmax_bwd", a_src, a_dst, idx, dst, row_ptr, live, keep,
                     att, datt)
    if att.device.type == "cpu":
        return attention_softmax_bwd_plain(att, datt, a_src, a_dst, idx, dst, row_ptr, live,
                                           neg_slope, keep=keep)
    dz = torch.empty_like(att)
    if att.numel() == 0 or row_ptr.shape[0] < 2:
        return dz.zero_()
    attention_softmax_bwd.launches += _softmax(
        "attention_softmax_bwd", "segment_softmax_bwd", row_ptr, schedule, att.shape[1],
        att.device, att.data_ptr(), datt.data_ptr(), _ptr(keep), a_src.data_ptr(),
        a_dst.data_ptr(), idx.data_ptr(), dst.data_ptr(), _ptr(_live_u8(live)),
        float(neg_slope), dz.data_ptr())
    return dz


attention_softmax_bwd.launches = 0


def segment_dot(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor,
                heads: int) -> torch.Tensor:
    """S3's reference: f32 [S, H], ``out[s, h] = Σ_k a[ia[s], h, k] · b[ib[s], h, k]``
    for rows of H·D float32 (``a`` and ``b`` [*, H·D] or [*, H, D]) and
    int32 indices, by ``segment_dot_plain``. CPU tensors only: on the card
    the dot runs inside S1's transpose pull (``weighted_pull_dot``)."""
    if ia.dim() != 1 or ib.shape != ia.shape or a.shape[1:] != b.shape[1:]:
        raise ValueError(f"segment_dot wants a, b of one row shape and ia, ib [S], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(ia.shape)}, "
                         f"{tuple(ib.shape)}")
    width = a[0].numel() if a.shape[0] else b[0].numel()
    if width % heads:
        raise ValueError(f"segment_dot: rows of {width} do not split into {heads} heads")
    _check_f32("segment_dot", a=a, b=b)
    if ia.dtype != torch.int32 or ib.dtype != torch.int32:
        raise TypeError("segment_dot takes int32 indices")
    _check_device("segment_dot", [a, ia, b, ib])
    if a.device.type != "cpu":
        raise ValueError("segment_dot has no kernel: on the card the head dot runs inside "
                         "S1's transpose pull, weighted_pull_dot")
    return segment_dot_plain(a, ia, b, ib, heads)


def _sum_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("segment_sum")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum.argtypes = [ptr] * 5 + [i32] + [ptr] * 2 + [i32] + [ptr] * 2 + [i32] + [ptr] * 2
        lib.segment_sum.restype = i32
        lib.segment_sum_error_string.argtypes = [i32]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def segment_sum(src: torch.Tensor, view: SegmentCSR, val: Optional[torch.Tensor] = None,
                post: Optional[torch.Tensor] = None, idx: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """P2: f32 [R, d], ``y[r] = post[r] · Σ_{s ∈ row r of view} val[s] ·
    src[idx[s]]``, each row's slots in slot order.

    ``src`` [N, d] float32; ``view`` the rows (its ``row_ptr`` and P2's work
    list ``sums``); ``idx`` [S] int32, the source row of each of the view's
    slots (None: ``view.idx``); ``val`` [S] and ``post`` [R] float32. CUDA
    tensors run kernel P2 (one launch), CPU tensors ``gather_sum_plain``,
    the same function. P2 takes no other source type and none of P1's
    epilogues (``add``, ``acc``, ``final``, ``requant``)."""
    idx = view.idx if idx is None else idx
    row_ptr = view.row_ptr
    if src.dim() != 2 or idx.shape != (view.n_slots,):
        raise ValueError(f"segment_sum wants src [N, d] and idx [{view.n_slots}], got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}")
    if src.dtype != torch.float32:
        raise TypeError(f"segment_sum takes a float32 source, got {src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"segment_sum takes int32 idx, got {idx.dtype}")
    _check_row_ptr("segment_sum", row_ptr)
    n_out, d = row_ptr.shape[0] - 1, src.shape[1]
    for name, t, shape in (("val", val, (view.n_slots,)), ("post", post, (n_out,))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"segment_sum {name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_device("segment_sum", [t for t in (src, idx, row_ptr, val, post) if t is not None])
    if src.device.type == "cpu":
        return gather_sum_plain(src, idx, row_ptr, val, post)
    out = torch.empty((n_out, d), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    work, work_start, n_partials = check_schedule("segment_sum", view.sums, src.device)
    partial = count = None
    if n_partials:
        partial = torch.empty((n_partials, d), dtype=torch.float32, device=src.device)
        count = torch.empty(n_partials, dtype=torch.int32, device=src.device)
    lib = _sum_lib()
    with torch.cuda.device(src.device):
        code = lib.segment_sum(src.data_ptr(), idx.data_ptr(), row_ptr.data_ptr(),
                               work.data_ptr(), work_start.data_ptr(), work.shape[0], _ptr(val),
                               _ptr(post), d, _ptr(partial), _ptr(count), n_partials,
                               out.data_ptr(), _stream(src))
    if code != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: "
                           f"{lib.segment_sum_error_string(code).decode()}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


# -- autograd over the views ------------------------------------------------------


class SegmentSoftmax(torch.autograd.Function):
    """S2 with its backward: ``segment_softmax_rows(e, row_ptr, live,
    schedule)``."""

    @staticmethod
    def forward(ctx, e, row_ptr, live, schedule=None):
        att = segment_softmax_rows(e.contiguous(), row_ptr, live, schedule)
        ctx.save_for_backward(att, row_ptr)
        ctx.schedule = schedule
        return att

    @staticmethod
    def backward(ctx, g):
        att, row_ptr = ctx.saved_tensors
        return (segment_softmax_rows_bwd(att, g.contiguous(), row_ptr, ctx.schedule), None, None,
                None)


class SegmentPull(torch.autograd.Function):
    """``y[r] = post[r] · Σ_{s ∈ row r} val[s] · x[idx[s]]`` over ``fwd`` (P2),
    with the backward ``dx[n] = Σ_{t ∈ row n of bwd} val_t[t] · post[idx_t[t]]
    · g[idx_t[t]]`` over the transpose view ``bwd`` (P2 again): no scatter.
    ``val`` and ``val_t`` are the same per-edge values in the two views'
    slot orders (None: 1); neither takes a gradient, nor does ``post``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, val, val_t, post):
        ctx.args = (bwd, val_t, post)
        return segment_sum(x.float().contiguous(), fwd, val=val, post=post)

    @staticmethod
    def backward(ctx, g):
        bwd, val_t, post = ctx.args
        g = g.contiguous() if post is None else (g * post[:, None]).contiguous()
        return segment_sum(g, bwd, val=val_t), None, None, None, None, None


def segment_pull(x: torch.Tensor, fwd: SegmentCSR, bwd: SegmentCSR,
                 val: Optional[torch.Tensor] = None, val_t: Optional[torch.Tensor] = None,
                 post: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``SegmentPull``: the view ``fwd``'s weighted row sums of ``x`` with
    the transpose view ``bwd`` as the backward's. ``val``/``val_t``/``post``
    must not require a gradient."""
    for name, t in (("val", val), ("val_t", val_t), ("post", post)):
        if t is not None and t.requires_grad:
            raise ValueError(f"segment_pull's {name} takes no gradient")
    return SegmentPull.apply(x, fwd, bwd, val, val_t, post)


def row_counts(view: SegmentCSR, val: torch.Tensor) -> torch.Tensor:
    """f32 [n_rows]: Σ of ``val`` (in slot order) over each row, exact for
    0/1 values (the masks): a cumulative sum in float64 read at the row
    pointers."""
    c = torch.cat([val.new_zeros(1, dtype=torch.float64), torch.cumsum(val.double(), 0)])
    return (c[view.row_ptr[1:]] - c[view.row_ptr[:-1]]).float()
