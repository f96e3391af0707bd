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
    (GAT's aggregation and its ``dh``);
  * S2 ``segment_softmax_rows`` / ``segment_softmax_rows_bwd``: the
    softmax of each row's live slots per head, and its backward
    ``att · (g − Σ_row att · g)``;
  * S3 ``segment_dot(a, ia, b, ib)``: ``out[s, h] = a[ia[s], h] · b[ib[s], h]``,
    S1's weight gradient, a gather and a dot with no scatter.

The single-head sums (the segment matmul, the masked mean, the per-row and
per-source sums of GAT's logit gradients) are P1 (``ops/gather.py::
gather_sum``) over a view: it sums a row's slots in slot order too.

For CUDA tensors each wrapper launches its kernel or raises; CPU tensors
run the plain version. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from recommendation_tpu_torch.ops.gather import (
    _check_device,
    check_schedule,
    gather_sum,
    pull_schedule,
)


@dataclasses.dataclass
class SegmentCSR:
    """A COO structure sorted by its rows (a stable sort: equal rows keep
    their COO order). ``row_ptr`` i64 [n_rows + 1]; ``idx`` i32 [S] the
    column (source) of each slot; ``slot_row`` i32 [S] the row of each
    slot; ``perm`` i64 [S] each slot's COO position; ``work``,
    ``work_start`` and ``n_partials`` are P1's and S1's schedule over the
    rows (``ops/gather.py::pull_schedule``)."""

    row_ptr: torch.Tensor
    idx: torch.Tensor
    slot_row: torch.Tensor
    perm: torch.Tensor
    work: torch.Tensor
    work_start: torch.Tensor
    n_partials: int
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
        """i32 [S] 0, 1, .., S − 1: P1 over these sums per-slot rows by row."""
        return torch.arange(self.n_slots, dtype=torch.int32, device=self.idx.device)


def segment_csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int, n_cols: int) -> SegmentCSR:
    """The row-sorted view of the COO (rows, cols) on their device: a
    stable sort by row, then the row pointers from the row counts (integer
    sums) and P1's schedule (a host read of the row pointers)."""
    rows = rows.long()
    perm = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=n_rows)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    work, work_start, n_partials = pull_schedule(row_ptr)
    return SegmentCSR(row_ptr=row_ptr, idx=cols[perm].to(torch.int32).contiguous(),
                      slot_row=rows[perm].to(torch.int32).contiguous(), perm=perm, work=work,
                      work_start=work_start, n_partials=n_partials, n_rows=n_rows,
                      n_cols=n_cols)


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


def segment_dot_plain(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """S3 in plain torch: the [S, H, D] gathers multiplied and summed."""
    ah = a.reshape(a.shape[0], heads, -1)
    bh = b.reshape(b.shape[0], heads, -1)
    return torch.sum(ah[ia.long()] * bh[ib.long()], dim=2)


# -- the kernels' wrappers ----------------------------------------------------------


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("segment")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segment_pull.argtypes = [ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] + [ptr] * 2
        lib.segment_softmax_fwd.argtypes = [ptr] * 3 + [i64, i32] + [ptr] * 2
        lib.segment_softmax_bwd.argtypes = [ptr] * 3 + [i64, i32] + [ptr] * 2
        lib.segment_dot.argtypes = [ptr] * 4 + [i64, i32, i32] + [ptr] * 2
        for fn in (lib.segment_pull, lib.segment_softmax_fwd, lib.segment_softmax_bwd,
                   lib.segment_dot):
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


def _check_heads(name, heads):
    if heads < 1 or 32 % heads:
        raise ValueError(f"{name}'s kernel takes a head count that divides 32, got {heads}")


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
    n_rows = row_ptr.shape[0] - 1
    out = torch.empty((n_rows, heads, d_head), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    work, work_start, n_partials = check_schedule(
        "weighted_pull", pull_schedule(row_ptr) if schedule is None else schedule, x.device)
    partial = count = None
    if n_partials:
        partial = torch.empty((n_partials, heads * d_head), dtype=torch.float32, device=x.device)
        count = torch.empty(n_partials, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("weighted_pull", "segment_pull", x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                work.data_ptr(), work_start.data_ptr(), work.shape[0], heads, d_head,
                None if partial is None else partial.data_ptr(),
                None if count is None else count.data_ptr(), n_partials, out.data_ptr(),
                _stream(x))
    weighted_pull.launches += 1
    return out


weighted_pull.launches = 0


def segment_softmax_rows(e: torch.Tensor, row_ptr: torch.Tensor,
                         live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S2's forward: f32 [S, H], the softmax of each row's live slots per
    head (``live`` bool [S], None for all), dead slots 0. CUDA tensors run
    kernel S2 (one launch; H must divide 32), CPU tensors
    ``segment_softmax_rows_plain``."""
    if e.dim() != 2 or row_ptr.dim() != 1 or (live is not None and live.shape != e.shape[:1]):
        raise ValueError(f"segment_softmax_rows wants e [S, H], row_ptr [R + 1], live [S], got "
                         f"{tuple(e.shape)}, {tuple(row_ptr.shape)}")
    _check_f32("segment_softmax_rows", e=e)
    _check_row_ptr("segment_softmax_rows", row_ptr)
    _check_device("segment_softmax_rows", [t for t in (e, row_ptr, live) if t is not None])
    if e.device.type == "cpu":
        return segment_softmax_rows_plain(e, row_ptr, live)
    _check_heads("segment_softmax_rows", e.shape[1])
    att = torch.empty_like(e)
    n_rows = row_ptr.shape[0] - 1
    if e.numel() == 0 or n_rows == 0:
        return att.zero_()
    live_u8 = None if live is None else live.to(torch.uint8).contiguous()
    with torch.cuda.device(e.device):
        _launch("segment_softmax_rows", "segment_softmax_fwd", e.data_ptr(),
                None if live_u8 is None else live_u8.data_ptr(), row_ptr.data_ptr(), n_rows,
                e.shape[1], att.data_ptr(), _stream(e))
    segment_softmax_rows.launches += 1
    return att


segment_softmax_rows.launches = 0


def segment_softmax_rows_bwd(att: torch.Tensor, g: torch.Tensor,
                             row_ptr: torch.Tensor) -> torch.Tensor:
    """S2's backward: f32 [S, H], ``att · (g − Σ_row att · g)``. CUDA
    tensors run kernel S2's backward (one launch), CPU tensors
    ``segment_softmax_rows_bwd_plain``."""
    if att.dim() != 2 or g.shape != att.shape or row_ptr.dim() != 1:
        raise ValueError(f"segment_softmax_rows_bwd wants att and g [S, H], got "
                         f"{tuple(att.shape)}, {tuple(g.shape)}")
    _check_f32("segment_softmax_rows_bwd", att=att, g=g)
    _check_row_ptr("segment_softmax_rows_bwd", row_ptr)
    _check_device("segment_softmax_rows_bwd", [att, g, row_ptr])
    if att.device.type == "cpu":
        return segment_softmax_rows_bwd_plain(att, g, row_ptr)
    _check_heads("segment_softmax_rows_bwd", att.shape[1])
    de = torch.empty_like(att)
    n_rows = row_ptr.shape[0] - 1
    if att.numel() == 0 or n_rows == 0:
        return de.zero_()
    with torch.cuda.device(att.device):
        _launch("segment_softmax_rows_bwd", "segment_softmax_bwd", att.data_ptr(), g.data_ptr(),
                row_ptr.data_ptr(), n_rows, att.shape[1], de.data_ptr(), _stream(att))
    segment_softmax_rows_bwd.launches += 1
    return de


segment_softmax_rows_bwd.launches = 0


def segment_dot(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor,
                heads: int) -> torch.Tensor:
    """S3: f32 [S, H], ``out[s, h] = Σ_k a[ia[s], h, k] · b[ib[s], h, k]``
    for rows of H·D float32 (``a`` and ``b`` [*, H·D] or [*, H, D]) and
    int32 indices. CUDA tensors run kernel S3 (one launch), CPU tensors
    ``segment_dot_plain``."""
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
    if a.device.type == "cpu":
        return segment_dot_plain(a, ia, b, ib, heads)
    out = torch.empty((ia.shape[0], heads), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        _launch("segment_dot", "segment_dot", a.data_ptr(), ia.data_ptr(), b.data_ptr(),
                ib.data_ptr(), ia.shape[0], heads, width // heads, out.data_ptr(), _stream(a))
    segment_dot.launches += 1
    return out


segment_dot.launches = 0


# -- autograd over the views ------------------------------------------------------


class SegmentSoftmax(torch.autograd.Function):
    """S2 with its backward: ``segment_softmax_rows(e, row_ptr, live)``."""

    @staticmethod
    def forward(ctx, e, row_ptr, live):
        att = segment_softmax_rows(e.contiguous(), row_ptr, live)
        ctx.save_for_backward(att, row_ptr)
        return att

    @staticmethod
    def backward(ctx, g):
        att, row_ptr = ctx.saved_tensors
        return segment_softmax_rows_bwd(att, g.contiguous(), row_ptr), None, None


class SegmentPull(torch.autograd.Function):
    """``y[r] = post[r] · Σ_{s ∈ row r} val[s] · x[idx[s]]`` over ``fwd`` (P1),
    with the backward ``dx[n] = Σ_{t ∈ row n of bwd} val_t[t] · post[idx_t[t]]
    · g[idx_t[t]]`` over the transpose view ``bwd`` (P1 again): no scatter.
    ``val`` and ``val_t`` are the same per-edge values in the two views'
    slot orders (None: 1); neither takes a gradient, nor does ``post``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, val, val_t, post):
        ctx.args = (bwd, val_t, post)
        return gather_sum(x.float().contiguous(), fwd.idx, fwd.row_ptr, val=val, post=post,
                          schedule=fwd.schedule)

    @staticmethod
    def backward(ctx, g):
        bwd, val_t, post = ctx.args
        g = g.contiguous() if post is None else (g * post[:, None]).contiguous()
        dx = gather_sum(g, bwd.idx, bwd.row_ptr, val=val_t, schedule=bwd.schedule)
        return dx, None, None, None, None, None


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
