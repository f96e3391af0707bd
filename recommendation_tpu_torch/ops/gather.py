"""Row gather (kernel K7) and bucket pull (kernel P1) of the bucketed
backend, with their plain versions.

``gather_rows(x, idx)`` is ``x[idx]`` for a 2-D f32 or bf16 table and i32
indices: the counterpart of the TPU row-DMA gather
``tools/probe_gather_ceiling.py::kernel`` (K7), used by the bucketed chain
for its node→row and row→node reorders and by ``pull`` for its last step.

``gather_sum(src, idx, row_ptr, val, post, add, skip, schedule, acc,
final)`` is the bucket pull over the flat slot tables of a ``BucketedCSR``
(``graph/bucketed.py``)::

    y[r] = post[r] · Σ_{s ∈ [row_ptr[r], row_ptr[r+1])} val[s] · (src[idx[s]] + add[idx[s]])

in f32 for every row r < len(row_ptr) − 1, with ``val``, ``post`` and
``add`` optional and ``src`` f32 or bf16 (``add`` only with an f32
``src``). It stands for the per-bucket ``jnp.sum(x[b.idx] · val, axis=1)``
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
elementwise operations round them.

The kernel runs a schedule (``pull_schedule``): one item per row and one
per ``CHUNK``-slot piece of a longer row, with each item's slot range; a
row's pieces write partial sums that the row's last piece adds in order,
so the hub rows of a power-law graph do not hold the launch up. A
``BucketedCSR`` builds its schedule once.

For CUDA tensors each wrapper launches its kernel from
``csrc/gather.cu`` or raises; CPU tensors run the plain version. Each
counts its launches in ``.launches``. Indices are not checked per call:
``build_bucketed`` validates the tables once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 128  # slots per piece of a split row (csrc/gather.cu's CHUNK)


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
                     keep_y: bool = False):
    """The bucket pull in plain torch, bucket by bucket as the JAX package
    computes it: the rows with one slot count (a bucket's rows; any rows,
    in a segment view) are one [rows, count, d] gather, multiplied by the
    values and summed over the count, then the epilogue as elementwise
    operations (``gather_sum``). Every slot is summed, ``skip``'s zero row
    included; ``schedule`` is the kernel's."""
    del skip, schedule  # the skipped row is zero: summing it changes nothing
    d = src.shape[1]
    counts = torch.diff(row_ptr)
    out = torch.zeros((len(counts), d), dtype=torch.float32, device=src.device)
    for cap in torch.unique(counts[counts > 0]).tolist():
        rows = torch.nonzero(counts == cap).squeeze(1)
        slots = (row_ptr[rows][:, None] + torch.arange(cap, device=src.device)).reshape(-1)
        ii = idx[slots].long()
        g = src[ii].float()
        if add is not None:
            g = g + add[ii]
        if val is not None:
            g = g * val[slots, None]
        out = out.index_copy(0, rows, torch.sum(g.view(len(rows), cap, d), dim=1))
    y = out * post[:, None] if post is not None else out
    if acc is None and final is None:
        return y
    total = y if acc is None else acc + y
    if final is not None:
        total = total * final[:, None]
    return (y, total) if keep_y else total


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.gather_error_string(code).decode()}")


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("gather")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gather_rows.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
        lib.gather_sum.argtypes = ([ptr, i32] + [ptr] * 4 + [i32] + [ptr] * 4 + [i32, i32]
                                  + [ptr] * 2 + [i32] + [ptr] * 3)
        for fn in (lib.gather_rows, lib.gather_sum):
            fn.restype = i32
        lib.gather_error_string.argtypes = [i32]
        lib.gather_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_device(name, tensors):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} inputs on different devices: {[str(t.device) for t in tensors]}")
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
               keep_y: bool = False):
    """The bucket pull (module docstring): f32 ``y`` [len(row_ptr) − 1, d];
    with ``acc`` or ``final``, the epilogue's ``(acc + y) · final`` instead
    (either part optional), and ``(y, that)`` with ``keep_y``.

    ``src`` [N, d] float32 or bfloat16; ``idx`` [S] int32 slot indices into
    ``src``; ``row_ptr`` [n_out + 1] int64, ascending from 0 to S; ``val``
    [S] float32; ``post`` [n_out] float32; ``add`` [N, d] float32, with a
    float32 ``src`` only; ``acc`` [n_out, d] and ``final`` [n_out] float32;
    ``schedule`` the kernel's work list, ``pull_schedule(row_ptr)`` (built
    here, with a host read, when None). CUDA tensors run kernel P1 (one
    launch), CPU tensors ``gather_sum_plain``."""
    if src.dim() != 2 or idx.dim() != 1 or row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError(f"gather_sum wants src [N, d], idx [S], row_ptr [n_out + 1], got "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}, {tuple(row_ptr.shape)}")
    n_out, d = row_ptr.shape[0] - 1, src.shape[1]
    if src.dtype not in _DTYPES:
        raise TypeError(f"gather_sum takes a float32 or bfloat16 source, got {src.dtype}")
    if idx.dtype != torch.int32 or row_ptr.dtype != torch.int64:
        raise TypeError(f"gather_sum takes int32 idx and int64 row_ptr, got {idx.dtype}, "
                        f"{row_ptr.dtype}")
    for name, t, shape in (("val", val, (idx.shape[0],)), ("post", post, (n_out,)),
                           ("add", add, tuple(src.shape)), ("acc", acc, (n_out, d)),
                           ("final", final, (n_out,))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"gather_sum {name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if add is not None and src.dtype != torch.float32:
        raise TypeError("gather_sum adds a second source to a float32 source only")
    tensors = [t for t in (src, idx, row_ptr, val, post, add, acc, final) if t is not None]
    _check_device("gather_sum", tensors)
    if src.device.type == "cpu":
        return gather_sum_plain(src, idx, row_ptr, val, post, add, skip, acc=acc, final=final,
                                keep_y=keep_y)

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
                              skip, _ptr(partial), _ptr(count), n_partials, _ptr(y), _ptr(total),
                              stream)
    _raise_on(lib, code, "gather_sum")
    gather_sum.launches += 1
    return result


gather_sum.launches = 0
