"""Row gather (kernel K7), bucket pull (kernel P1) and row quantizer
(kernel Q1) of the bucketed backend, with their plain versions.

``gather_rows(x, idx)`` is ``x[idx]`` for a 2-D f32 or bf16 table and i32
indices: the counterpart of the TPU row-DMA gather
``tools/probe_gather_ceiling.py::kernel`` (K7), used by the bucketed chain
for its node→row and row→node reorders and by ``pull`` for its last step.

``gather_sum(src, idx, row_ptr, val, post, add, skip, schedule, acc,
final)`` is the bucket pull over the flat slot tables of a ``BucketedCSR``
(``graph/bucketed.py``)::

    y[r] = post[r] · Σ_{s ∈ [row_ptr[r], row_ptr[r+1])} val[s] · (src[idx[s]] + add[idx[s]])

in f32 for every row r < len(row_ptr) − 1, with ``val``, ``post`` and
``add`` optional and ``src`` f32, bf16 or int8 codes with their row
``scale`` (``add`` only with an f32 ``src``; an int8 source reads as
``float(code) · scale[row]``, each product rounded once). It stands for the per-bucket ``jnp.sum(x[b.idx] · val, axis=1)``
of ``recommendation_tpu/graph/bucketed.py`` (``pull`` :472-486,
``pull_rowspace`` :588-607, ``_gather_sum_rowspace`` :610-616), which the
JAX package leaves to XLA; the variants are the separable fold (no value,
``post`` the row scale), the value path, the bf16 source, and the value
path's Horner backward with ``s + gp`` as ``add``. Slots whose index equals ``skip`` may
be left out by the kernel: callers pass the row that is zero in ``src`` and
``add``. The epilogue takes the separable chain's elementwise work between
its pulls (``graph/bucketed.py:654-655,687-688`` in the JAX package): the
call returns ``(acc + y) · final`` (the running sum, the last layer's
scaling, or the next Horner step's source) in place of ``y``, or beside it
with ``keep_y``, each product and sum rounded once as the plain
elementwise operations round them. With an int8 source the epilogue is the
int8 chain's layer (``graph/bucketed.py:658-661`` in the JAX package):
``acc + y`` and, with ``requant``, the next layer's codes and scale of ``y
· pre`` as ``quantize_rows`` computes them, in the one launch, ``y`` not
written.

The kernel runs a schedule (``pull_schedule``): one item per row and one
per ``CHUNK``-slot piece of a longer row, with each item's slot range; a
row's pieces write partial sums that the row's last piece adds in order,
so the hub rows of a power-law graph do not hold the launch up. A
``BucketedCSR`` builds its schedule once.

``quantize_rows(x, pre)`` is the JAX package's ``_pack_int8_rows``
(``graph/bucketed.py:507-519``) with the separable pull's source scaling
(``:591``) as its optional ``pre``: each row of ``x · pre`` as int8 codes
``clip(round(x / scale), -127, 127)`` with ``scale = max(max|x|, 1e-12) ·
f32(1/127)`` (the reciprocal's product, as XLA computes the jitted
division; the codes a true division, rounded half to even), so codes and
scales equal the jitted JAX function's bit for bit. Where JAX packs four
codes into an f32 word for the TPU's gather, the port keeps them as an
int8 table whose rows are padded to 16 bytes (the padding codes 0), so P1
loads 16 codes at once, beside an f32 scale a row: ``codes`` is the [N, d]
view of that [N, d_pad] table.

For CUDA tensors each wrapper launches its kernel from
``csrc/gather.cu`` or raises; CPU tensors run the plain version. Each
counts its launches in ``.launches`` (P1's with an int8 source also in
``gather_sum.launches_int8``, and those with the int8 chain's epilogue in
``gather_sum.launches_fused``). Indices are not checked per call:
``build_bucketed`` validates the tables once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 128  # slots per piece of a split row (csrc/gather.cu's CHUNK)
CODE_ALIGN = 16  # int8 code rows are padded to a multiple of this many codes (16 bytes)
_INV127 = torch.tensor(1 / 127, dtype=torch.float32)  # XLA's reciprocal of the jitted division


def pull_schedule(row_ptr) -> tuple[torch.Tensor, torch.Tensor, int]:
    """P1's work list for the rows of ``row_ptr`` (int64, on the device
    the kernel runs on): i32 [W, 4] of (row, piece, the row's first partial
    or -1, the row's pieces), one item per row and one per ``CHUNK``-slot
    piece of a longer row; i64 [W + 1], each item's first slot (the items
    cover the slots in order, so item w ends where w + 1 starts); and the
    number of partial sums the split rows need. Built on the host (it reads
    ``row_ptr``)."""
    ptr = row_ptr.cpu().numpy()
    lens = np.diff(ptr)
    pieces = np.maximum(1, -(-lens // CHUNK))
    split = np.where(pieces > 1, pieces, 0)
    first = np.where(pieces > 1, np.cumsum(split) - split, -1)
    rows = np.repeat(np.arange(len(lens)), pieces)
    piece = np.arange(int(pieces.sum())) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    work = np.stack([rows, piece, np.repeat(first, pieces), np.repeat(pieces, pieces)], axis=1)
    starts = np.append(ptr[rows] + piece * CHUNK, ptr[-1]).astype(np.int64)
    dev = row_ptr.device
    return (torch.from_numpy(work.astype(np.int32)).to(dev), torch.from_numpy(starts).to(dev),
            int(split.sum()))


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` in plain torch."""
    return x[idx.long()]


def gather_sum_plain(src: torch.Tensor, idx: torch.Tensor, row_ptr: torch.Tensor,
                     val: torch.Tensor | None = None, post: torch.Tensor | None = None,
                     add: torch.Tensor | None = None, skip: int = -1, schedule=None,
                     acc: torch.Tensor | None = None, final: torch.Tensor | None = None,
                     keep_y: bool = False, scale: torch.Tensor | None = None,
                     requant: bool = False, pre: torch.Tensor | None = None):
    """The bucket pull in plain torch, bucket by bucket as the JAX package
    computes it: the rows with one slot count (a bucket's rows; any rows,
    in a segment view) are one [rows, count, d] gather (an int8 source
    dequantized by its row ``scale``), multiplied by the values and summed
    over the count, then the epilogue as elementwise operations
    (``gather_sum``): with ``requant``, ``(acc + y, *quantize_rows_plain(y,
    pre))``. Every slot is summed, ``skip``'s zero row included;
    ``schedule`` is the kernel's."""
    del skip, schedule  # the skipped row is zero: summing it changes nothing
    d = src.shape[1]
    counts = torch.diff(row_ptr)
    out = torch.zeros((len(counts), d), dtype=torch.float32, device=src.device)
    for cap in torch.unique(counts[counts > 0]).tolist():
        rows = torch.nonzero(counts == cap).squeeze(1)
        slots = (row_ptr[rows][:, None] + torch.arange(cap, device=src.device)).reshape(-1)
        ii = idx[slots].long()
        g = src[ii].float()
        if scale is not None:
            g = g * scale[ii][:, None]
        if add is not None:
            g = g + add[ii]
        if val is not None:
            g = g * val[slots, None]
        out = out.index_copy(0, rows, torch.sum(g.view(len(rows), cap, d), dim=1))
    y = out * post[:, None] if post is not None else out
    if requant:
        return (y if acc is None else acc + y, *quantize_rows_plain(y, pre))
    if acc is None and final is None:
        return y
    total = y if acc is None else acc + y
    if final is not None:
        total = total * final[:, None]
    return (y, total) if keep_y else total


def padded_width(d: int) -> int:
    """The int8 code rows' stored width: d rounded up to 16 codes."""
    return -(-d // CODE_ALIGN) * CODE_ALIGN


def quantize_rows_plain(x: torch.Tensor, pre: torch.Tensor | None = None):
    """Q1 in plain torch: the JAX package's ``_pack_int8_rows`` on ``x · pre``
    (module docstring), as (codes int8 [N, d], the view of a [N, d_pad]
    table, scale f32 [N])."""
    xs = x.float() if pre is None else x.float() * pre[:, None]
    scale = torch.clamp(xs.abs().amax(dim=1), min=1e-12) * _INV127.to(xs.device)
    n, d = xs.shape
    codes = torch.zeros((n, padded_width(d)), dtype=torch.int8, device=xs.device)[:, :d]
    codes.copy_(torch.clamp(torch.round(xs / scale[:, None]), -127, 127).to(torch.int8))
    return codes, scale


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.gather_error_string(code).decode()}")


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("gather")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gather_rows.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
        lib.gather_sum.argtypes = ([ptr, i32] + [ptr] * 4 + [i32] + [ptr] * 4
                                  + [i32, i32, ptr, ptr, i32] + [ptr] * 3)
        lib.gather_sum_i8.argtypes = ([ptr, ptr, i32] + [ptr] * 3 + [i32] + [ptr] * 3
                                     + [i32, i32, ptr, ptr, i32] + [ptr] * 7)
        lib.quantize_rows.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
        for fn in (lib.gather_rows, lib.gather_sum, lib.gather_sum_i8, lib.quantize_rows):
            fn.restype = i32
        lib.gather_error_string.argtypes = [i32]
        lib.gather_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_device(name, tensors, strided=()):
    """One device (cuda or cpu) for ``tensors`` and ``strided``; on the card
    every one of ``tensors`` contiguous (``strided`` are checked by the
    caller)."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if any(t.device != dev for t in (*tensors, *strided)):
        raise ValueError(f"{name} inputs on different devices: "
                         f"{[str(t.device) for t in (*tensors, *strided)]}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s kernel takes contiguous tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``: rows of a 2-D float32 or bfloat16 table ``x`` picked by
    the 1-D int32 ``idx``. CUDA tensors run kernel K7, CPU tensors
    ``gather_rows_plain``."""
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows wants x [N, d] and idx [S], got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"gather_rows takes float32 or bfloat16 rows, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 indices, got {idx.dtype}")
    _check_device("gather_rows", [x, idx])
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    shape = (idx.shape[0], x.shape[1])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.gather_rows(x.data_ptr(), idx.data_ptr(), shape[0],
                               shape[1] * x.element_size(), out.data_ptr(), stream)
    _raise_on(lib, code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def check_schedule(name: str, schedule, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``schedule`` = (work, work_start, n_partials) as ``pull_schedule``
    makes it, on ``device``, or a ValueError: the kernels that walk it (P1,
    S1) read it through raw pointers."""
    work, work_start, n_partials = schedule
    if (not isinstance(work, torch.Tensor) or not isinstance(work_start, torch.Tensor)
            or work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 4
            or work_start.dtype != torch.int64 or work_start.shape != (work.shape[0] + 1,)
            or work.device != device or work_start.device != device
            or not work.is_contiguous() or not work_start.is_contiguous()
            or int(n_partials) < 0):
        raise ValueError(f"{name} schedule must be an int32 [W, 4] work list, its int64 "
                         f"[W + 1] slot starts and a partial count >= 0, on {device}")
    return work, work_start, int(n_partials)


def gather_sum(src: torch.Tensor, idx: torch.Tensor, row_ptr: torch.Tensor,
               val: torch.Tensor | None = None, post: torch.Tensor | None = None,
               add: torch.Tensor | None = None, skip: int = -1,
               schedule: tuple[torch.Tensor, torch.Tensor, int] | None = None,
               acc: torch.Tensor | None = None, final: torch.Tensor | None = None,
               keep_y: bool = False, scale: torch.Tensor | None = None,
               requant: bool = False, pre: torch.Tensor | None = None):
    """The bucket pull (module docstring): f32 ``y`` [len(row_ptr) − 1, d];
    with ``acc`` or ``final``, the epilogue's ``(acc + y) · final`` instead
    (either part optional), and ``(y, that)`` with ``keep_y``.

    ``src`` [N, d] float32 or bfloat16, or int8 codes as ``quantize_rows``
    gives them (rows of a multiple of 16 codes, the [N, d] view) with their
    ``scale`` [N] float32 (and then no ``add``, ``final`` or ``keep_y``);
    ``idx`` [S] int32 slot indices into ``src``; ``row_ptr`` [n_out + 1]
    int64, ascending from 0 to S; ``val`` [S] float32; ``post`` [n_out]
    float32; ``add`` [N, d] float32, with a float32 ``src`` only; ``acc``
    [n_out, d] and ``final`` [n_out] float32; ``schedule`` the kernel's
    work list, ``pull_schedule(row_ptr)`` (built here, with a host read,
    when None). CUDA tensors run kernel P1 (one launch), CPU tensors
    ``gather_sum_plain``.

    ``requant`` (an int8 source only) makes the call the int8 chain's
    fused layer: it returns ``(acc + y, codes, scale)`` (``acc`` optional),
    the codes and scale of ``y · pre`` as ``quantize_rows(y, pre)`` gives
    them (``pre`` [n_out] float32, optional), from the kernel's epilogue,
    with ``y`` itself not written."""
    if src.dim() != 2 or idx.dim() != 1 or row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError(f"gather_sum wants src [N, d], idx [S], row_ptr [n_out + 1], got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}, {tuple(row_ptr.shape)}")
    n_out, d = row_ptr.shape[0] - 1, src.shape[1]
    codes = src.dtype == torch.int8
    if src.dtype not in _DTYPES and not codes:
        raise TypeError(f"gather_sum takes a float32, bfloat16 or int8 source, got {src.dtype}")
    if codes != (scale is not None):
        raise TypeError("gather_sum takes a row scale with an int8 source, and only then")
    if idx.dtype != torch.int32 or row_ptr.dtype != torch.int64:
        raise TypeError(f"gather_sum takes int32 idx and int64 row_ptr, got {idx.dtype}, "
                        f"{row_ptr.dtype}")
    for name, t, shape in (("val", val, (idx.shape[0],)), ("post", post, (n_out,)),
                           ("add", add, tuple(src.shape)), ("acc", acc, (n_out, d)),
                           ("final", final, (n_out,)), ("scale", scale, (src.shape[0],)),
                           ("pre", pre, (n_out,))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"gather_sum {name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if add is not None and src.dtype != torch.float32:
        raise TypeError("gather_sum adds a second source to a float32 source only")
    if codes and (add is not None or final is not None or keep_y):
        raise TypeError("gather_sum's int8 source takes no add, final or keep_y")
    if requant and not codes:
        raise TypeError("gather_sum requantizes the layer of an int8 source only")
    if pre is not None and not requant:
        raise TypeError("gather_sum takes pre with requant only")
    tensors = [t for t in (idx, row_ptr, val, post, add, acc, final, scale, pre) if t is not None]
    if codes:
        _check_device("gather_sum", tensors, strided=(src,))
        if src.device.type == "cuda" and (
                src.stride(1) != 1 or src.stride(0) % CODE_ALIGN or src.stride(0) < d
                or src.data_ptr() % 16):
            raise ValueError("gather_sum's int8 source must be quantize_rows' codes: rows of a "
                             "multiple of 16 codes, 16-byte aligned")
    else:
        _check_device("gather_sum", [src, *tensors])
    if src.device.type == "cpu":
        return gather_sum_plain(src, idx, row_ptr, val, post, add, skip, acc=acc, final=final,
                                keep_y=keep_y, scale=scale, requant=requant, pre=pre)
    if codes:
        return _gather_sum_i8(src, scale, idx, row_ptr, schedule, val, post, acc, skip, requant,
                              pre)

    def empty():
        return torch.empty((n_out, d), dtype=torch.float32, device=src.device)

    epilogue = acc is not None or final is not None
    y = empty() if keep_y or not epilogue else None
    total = empty() if epilogue else None
    result = total if y is None else (y if total is None else (y, total))
    if n_out * d == 0:
        return result
    work, work_start, n_partials = check_schedule(
        "gather_sum", pull_schedule(row_ptr) if schedule is None else schedule, src.device)
    partial = count = None
    if n_partials:
        partial = torch.empty((n_partials, d), dtype=torch.float32, device=src.device)
        count = torch.empty(n_partials, dtype=torch.int32, device=src.device)
    lib = _kernel_lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = lib.gather_sum(src.data_ptr(), int(src.dtype == torch.bfloat16), _ptr(add),
                              idx.data_ptr(), work.data_ptr(), work_start.data_ptr(),
                              work.shape[0], _ptr(val), _ptr(post), _ptr(acc), _ptr(final), d,
                              skip, _ptr(partial), _ptr(count), n_partials, _ptr(y),
                              _ptr(total), stream)
    _raise_on(lib, code, "gather_sum")
    gather_sum.launches += 1
    return result


def _gather_sum_i8(codes, scale, idx, row_ptr, schedule, val, post, acc, skip, requant, pre):
    """P1 with an int8 source on the card, ``gather_sum``'s checks done:
    ``y``, or ``acc + y`` streamed where ``acc`` or ``requant`` is given,
    and with ``requant`` the next layer's codes and scale beside it (every
    code of the padded table written by the kernel)."""
    dev, n_out, d, sd = codes.device, row_ptr.shape[0] - 1, codes.shape[1], codes.stride(0)
    fused = acc is not None or requant
    out = torch.empty((n_out, d), dtype=torch.float32, device=dev)
    q_table = q_scale = xs = None
    if requant:
        q_table = torch.empty((n_out, padded_width(d)), dtype=torch.int8, device=dev)
        q_scale = torch.empty(n_out, dtype=torch.float32, device=dev)
        if sd > 32 * CODE_ALIGN:  # a row of more than a warp's chunks takes several passes
            xs = torch.empty((n_out, sd), dtype=torch.float32, device=dev)
    result = (out, q_table[:, :d], q_scale) if requant else out
    if n_out * d == 0:
        return result
    work, work_start, n_partials = check_schedule(
        "gather_sum", pull_schedule(row_ptr) if schedule is None else schedule, dev)
    partial = count = None
    if n_partials:
        partial = torch.empty((n_partials, sd), dtype=torch.float32, device=dev)
        count = torch.empty(n_partials, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gather_sum_i8(codes.data_ptr(), scale.data_ptr(), sd, idx.data_ptr(),
                                 work.data_ptr(), work_start.data_ptr(), work.shape[0],
                                 _ptr(val), _ptr(post), _ptr(acc), d, skip, _ptr(partial),
                                 _ptr(count), n_partials, None if fused else out.data_ptr(),
                                 out.data_ptr() if fused else None, _ptr(q_table),
                                 _ptr(q_scale), _ptr(pre), _ptr(xs), stream)
    _raise_on(lib, code, "gather_sum")
    gather_sum.launches += 1
    gather_sum.launches_int8 += 1
    gather_sum.launches_fused += fused
    return result


gather_sum.launches = 0
gather_sum.launches_int8 = 0  # the launches with an int8 source, counted in ``launches`` too
gather_sum.launches_fused = 0  # of those, the int8 chain's layers (acc or requant given)


def quantize_rows(x: torch.Tensor, pre: torch.Tensor | None = None):
    """Q1: each row of ``x · pre`` (``pre`` [N] float32, optional) as int8
    codes and a row scale (module docstring): (codes int8 [N, d], the view
    of a zero-padded [N, padded_width(d)] table, scale float32 [N]). CUDA
    tensors run kernel Q1 (one launch), CPU tensors
    ``quantize_rows_plain``."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"quantize_rows takes float32 rows [N, d], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if pre is not None and (pre.dtype != torch.float32 or tuple(pre.shape) != (x.shape[0],)):
        raise ValueError(f"quantize_rows pre must be float32 ({x.shape[0]},)")
    _check_device("quantize_rows", [t for t in (x, pre) if t is not None])
    if x.device.type == "cpu":
        return quantize_rows_plain(x, pre)
    n, d = x.shape
    codes = torch.empty((n, padded_width(d)), dtype=torch.int8, device=x.device)
    scale = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return codes[:, :d], scale
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.quantize_rows(x.data_ptr(), _ptr(pre), n, d, codes.shape[1], codes.data_ptr(),
                                 scale.data_ptr(), stream)
    _raise_on(lib, code, "quantize_rows")
    quantize_rows.launches += 1
    return codes[:, :d], scale


quantize_rows.launches = 0
