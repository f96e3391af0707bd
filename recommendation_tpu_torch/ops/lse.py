"""Full-catalog logsumexp: kernels K5 (forward) and K6 (backward), their
plain versions, and the autograd Function over both.

Counterpart of the catalog part of ``recommendation_tpu/ops/pallas_losses.py``
(``catalog_logsumexp``: ``_lse_fwd_kernel`` and ``_lse_bwd_kernel``). NCL's
layer-contrast loss takes its two denominators through it
(``models/ncl.py:171,174``):

    lse[b] = logsumexp_n(q[b] · x[n] / τ)        q [B, d], x [N, d] f32 → [B] f32
    p = exp(q·xᵀ/τ − lse) · g ;  dq = p·x/τ ;  dx = pᵀ·q/τ

``catalog_lse`` launches K5 (``csrc/catalog_lse.cu``) for CUDA tensors and
runs ``catalog_lse_plain`` for CPU tensors. K5 cuts the catalog into
splits of ``w`` 64-row item tiles (``lse_fwd_plan``: the fewest tiles that
keep the grid within one wave of the card), each block writing one (max,
sum) pair per query row and split, and a second launch merges the splits
in split order; ``catalog_lse_split_plain`` is that split arithmetic in
plain torch, for the tests. ``catalog_lse_bwd`` launches K6 in two sides:
blocks that own a query tile and walk a split of item tiles (dq), and
blocks that own an item tile and walk a split of query tiles (dx), each
keeping its output tile on chip across the walk and writing one partial a
split (``lse_bwd_plan`` sizes the splits to one wave,
``lse_bwd_workspace`` counts the partials: splits x (B or N) x d floats, not
B x N x d / 64); a second launch adds the partials in split order. It runs
``catalog_lse_bwd_plain`` for CPU tensors; ``catalog_lse_bwd_split_plain``
is K6's split arithmetic in plain torch, for the tests. There is no
fallback on the card and no size threshold: a CUDA input goes through the
kernel or the call raises. ``catalog_lse.launches`` counts K5's launches and
``catalog_lse_bwd.launches`` K6's; ``.launches_per_call`` says how many a
call makes (2 and 2).
``CatalogLSE`` saves ``(q, x, lse)`` as ``_clse_fwd`` does and recomputes
the scores in the backward.

Not ported, because each is a TPU form and not part of what the function
computes: ``FUSED_MIN_ROWS`` (below 4096 rows the JAX package takes XLA's
logsumexp, a TPU launch-overhead measurement), ``MAX_FUSED_B`` and
``_chunked_lse`` (a sequential sweep over 1024-row query chunks that keeps
the kernel's [B, block_n] score tile inside the TPU's scoped VMEM),
``_auto_block_n`` (the item-block size from that VMEM budget) and
``interpret`` (Pallas's CPU mode; here the CPU runs the plain version). The
H100 kernels stream fixed tiles through shared memory at any B and N.
``uniformity_streaming`` is not a kernel (a ``lax.scan``): it is a loop of
plain products in ``losses.py``.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 64  # csrc/catalog_lse.cu's BT: K5's and K6's query and item rows per block


def catalog_lse_plain(q: torch.Tensor, x: torch.Tensor, tau: float) -> torch.Tensor:
    """logsumexp(q·xᵀ/τ, dim=1) in plain torch, materializing [B, N]."""
    return torch.logsumexp(q @ x.T / tau, dim=1)


def catalog_lse_split_plain(q: torch.Tensor, x: torch.Tensor, tau: float,
                            tiles_per_split: int) -> torch.Tensor:
    """K5's arithmetic in plain torch: the catalog cut into splits of
    ``tiles_per_split`` 64-row item tiles, one (max, sum of exp(s − max))
    pair per query row and split, the pairs merged in split order, then
    max + log(sum). Used by the tests."""
    cols = tiles_per_split * TILE
    m = s = None
    for c0 in range(0, x.shape[0], cols):
        scores = q @ x[c0:c0 + cols].T / tau
        mi = scores.max(dim=1).values
        si = torch.exp(scores - mi[:, None]).sum(dim=1)
        if m is None:
            m, s = mi, si
            continue
        nm = torch.maximum(m, mi)
        s = s * torch.exp(m - nm) + si * torch.exp(mi - nm)
        m = nm
    return m + torch.log(s)


def lse_fwd_plan(b: int, n: int, slots: int) -> tuple[int, int]:
    """(w, splits) of K5 for q [b, d] against x [n, d] on a card that holds
    ``slots`` of its blocks at once: the fewest item tiles per split that
    keep ceil(b/64) x splits blocks within one wave (one split per query
    tile when even that takes more). No split is empty."""
    nq, nx = -(-b // TILE), -(-n // TILE)
    per_tile = max(1, slots // nq)
    w = -(-nx // min(nx, per_tile))
    return w, -(-nx // w)


def catalog_lse_bwd_plain(q: torch.Tensor, x: torch.Tensor, tau: float, lse: torch.Tensor,
                          g: torch.Tensor):
    """(dq, dx) of ``catalog_lse`` given its value ``lse`` and cotangent
    ``g``, in plain torch."""
    p = torch.exp(q @ x.T / tau - lse[:, None]) * g[:, None]
    return p @ x / tau, p.T @ q / tau


def lse_bwd_plan(b: int, n: int, slots: int) -> tuple[int, int, int, int]:
    """(wq, sq, wx, sx) of K6 for q [b, d] against x [n, d] on a card that
    holds ``slots`` of its blocks at once. Each of the 2·nq·nx (query tile,
    item tile) visits belongs to one block; a block walks about
    2·nq·nx / slots of them, so both sides together make about one wave:
    the query side's blocks walk ``wq`` item tiles in each of ``sq``
    splits, the item side's ``wx`` query tiles in each of ``sx`` splits.
    A side whose own tiles already pass the wave takes one split. The
    splits are balanced and none is empty."""
    nq, nx = -(-b // TILE), -(-n // TILE)
    walk = max(1, -(-2 * nq * nx // slots))

    def side(tiles):
        w = -(-tiles // -(-tiles // min(tiles, walk)))
        return w, -(-tiles // w)

    return (*side(nx), *side(nq))


def lse_bwd_workspace(b: int, n: int, d: int, slots: int) -> int:
    """The floats of K6's partials for q [b, d] against x [n, d]: sq x b x d
    of dq and sx x n x d of dx (``lse_bwd_plan``), at most
    max(sq, sx) x (b + n) x d."""
    _, sq, _, sx = lse_bwd_plan(b, n, slots)
    return (sq * b + sx * n) * d


def catalog_lse_bwd_split_plain(q: torch.Tensor, x: torch.Tensor, tau: float, lse: torch.Tensor,
                                g: torch.Tensor, plan: tuple[int, int, int, int]):
    """K6's arithmetic in plain torch: each side's split adds its walked
    64-row tiles' products in tile order into one partial, the partials
    are added in split order, then divided by τ. ``plan`` is
    ``lse_bwd_plan``'s (wq, sq, wx, sx). Used by the tests."""
    wq, _, wx, _ = plan
    p = torch.exp(q @ x.T / tau - lse[:, None]) * g[:, None]

    def side(pt, walked, w):  # pt [own, walked]: sum over walked tiles, split by split
        total = None
        for c0 in range(0, walked.shape[0], w * TILE):
            part = torch.zeros(pt.shape[0], walked.shape[1], dtype=pt.dtype, device=pt.device)
            for t0 in range(c0, min(c0 + w * TILE, walked.shape[0]), TILE):
                part = part + pt[:, t0:t0 + TILE] @ walked[t0:t0 + TILE]
            total = part if total is None else total + part
        return total / tau

    return side(p, x, wq), side(p.T, q, wx)


def _check(name, q, x, *rows):
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"{name} wants q [B, d] and x [N, d], got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    if q.numel() == 0 or x.numel() == 0:
        raise ValueError(f"{name} wants non-empty q and x, got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    for t in rows:
        if t.shape != (q.shape[0],):
            raise ValueError(f"{name} wants [B] = [{q.shape[0]}] vectors, got {tuple(t.shape)}")
    tensors = (q, x, *rows)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 tensors, got {[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} inputs on different devices: {[str(t.device) for t in tensors]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s kernel takes contiguous tensors")


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("catalog_lse")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lse_fwd_f32.argtypes = [ptr, ptr, i32, i32, i32, f32, i32, i32, ptr, ptr, ptr]
        lib.lse_fwd_f32.restype = i32
        lib.lse_fwd_blocks_per_sm.argtypes = [i32]
        lib.lse_fwd_blocks_per_sm.restype = i32
        lib.lse_bwd_f32.argtypes = [ptr] * 4 + [i32, i32, i32, f32] + [i32] * 4 + [ptr] * 5
        lib.lse_bwd_f32.restype = i32
        lib.lse_bwd_blocks_per_sm.argtypes = [i32]
        lib.lse_bwd_blocks_per_sm.restype = i32
        lib.lse_tile.argtypes = []
        lib.lse_tile.restype = i32
        lib.lse_bwd_slabs.argtypes = [i32]
        lib.lse_bwd_slabs.restype = i32
        if lib.lse_tile() != TILE:
            raise RuntimeError(f"catalog_lse.cu's tile {lib.lse_tile()} is not {TILE}")
        lib.lse_error_string.argtypes = [i32]
        lib.lse_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_SLOTS: dict[tuple[str, torch.device, int], int] = {}


def _slots(lib, kernel: str, device: torch.device, d: int) -> int:
    """The blocks of K5 (``kernel`` "fwd") or K6 ("bwd") that the card holds
    at once: its SMs times what one SM holds (``lse_<kernel>_blocks_per_sm``;
    the shared memory grows with d's 64-column slices, K6's up to one slab
    of 512 columns). K6's share for each of its column slabs
    (``lse_bwd_slabs``): the plan then fills one wave with all of them."""
    key = (kernel, device, -(-d // TILE))
    if key not in _SLOTS:
        with torch.cuda.device(device):
            per_sm = getattr(lib, f"lse_{kernel}_blocks_per_sm")(d)
        if per_sm <= 0:
            raise RuntimeError(f"catalog_lse.cu: the runtime gave no occupancy for lse_{kernel}")
        slots = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
        _SLOTS[key] = max(1, slots // lib.lse_bwd_slabs(d)) if kernel == "bwd" else slots
    return _SLOTS[key]


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.lse_error_string(code).decode()}")


def catalog_lse(q: torch.Tensor, x: torch.Tensor, tau: float) -> torch.Tensor:
    """lse f32[B] = logsumexp(q·xᵀ/τ, dim=1) without materializing [B, N].

    ``q`` [B, d] and ``x`` [N, d] are float32, contiguous and on one device.
    CUDA tensors run K5 (two launches: the splits' (max, sum) pairs, then
    their merge in split order); CPU tensors run ``catalog_lse_plain``."""
    _check("catalog_lse", q, x)
    if q.device.type == "cpu":
        return catalog_lse_plain(q, x, tau)
    lib = _kernel_lib()
    (b, d), n = q.shape, x.shape[0]
    w, splits = lse_fwd_plan(b, n, _slots(lib, "fwd", q.device, d))
    lse = torch.empty(b, dtype=torch.float32, device=q.device)
    part = torch.empty(splits * b * 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.lse_fwd_f32(q.data_ptr(), x.data_ptr(), b, n, d, float(tau), w, splits,
                               part.data_ptr(), lse.data_ptr(), stream)
    _raise_on(lib, code, "catalog_lse")
    catalog_lse.launches += catalog_lse.launches_per_call
    return lse


catalog_lse.launches = 0
catalog_lse.launches_per_call = 2  # the splits, then their merge


def catalog_lse_bwd(q: torch.Tensor, x: torch.Tensor, tau: float, lse: torch.Tensor,
                    g: torch.Tensor):
    """(dq f32[B, d], dx f32[N, d]): the cotangents of ``catalog_lse``'s
    inputs given its output ``lse`` and that output's cotangent ``g``.

    CUDA tensors run K6: one launch of both sides' split blocks, each
    recomputing its tiles' scores and writing one partial a split
    (``lse_bwd_plan``), its output columns cut into slabs of 512 (one block
    a slab: any d), and a second launch that adds the partials in split
    order. CPU tensors run ``catalog_lse_bwd_plain``."""
    _check("catalog_lse_bwd", q, x, lse, g)
    if q.device.type == "cpu":
        return catalog_lse_bwd_plain(q, x, tau, lse, g)
    lib = _kernel_lib()
    (b, d), n = q.shape, x.shape[0]
    slots = _slots(lib, "bwd", q.device, d)
    wq, sq, wx, sx = lse_bwd_plan(b, n, slots)
    dq, dx = torch.empty_like(q), torch.empty_like(x)
    # dq's sq partials of [b, d] first, then dx's sx of [n, d]
    parts = torch.empty(lse_bwd_workspace(b, n, d, slots), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.lse_bwd_f32(q.data_ptr(), x.data_ptr(), lse.data_ptr(), g.data_ptr(), b, n, d,
                               float(tau), wq, sq, wx, sx, dq.data_ptr(), dx.data_ptr(),
                               parts.data_ptr(), parts[sq * b * d:].data_ptr(), stream)
    _raise_on(lib, code, "catalog_lse_bwd")
    catalog_lse_bwd.launches += catalog_lse_bwd.launches_per_call
    return dq, dx


catalog_lse_bwd.launches = 0
catalog_lse_bwd.launches_per_call = 2  # both sides' split blocks, then the combine


class CatalogLSE(torch.autograd.Function):
    """``catalog_lse`` with a gradient to ``q`` and ``x``: K5 forward, K6
    backward on the card, the plain versions on the CPU. ``tau`` gets None."""

    @staticmethod
    def forward(ctx, q, x, tau):
        q, x = q.contiguous(), x.contiguous()
        lse = catalog_lse(q, x, tau)
        ctx.save_for_backward(q, x, lse)
        ctx.tau = tau
        return lse

    @staticmethod
    def backward(ctx, g):
        q, x, lse = ctx.saved_tensors
        dq, dx = catalog_lse_bwd(q, x, ctx.tau, lse, g.contiguous())
        return dq, dx, None
