"""Dense bipartite LightGCN layer chain: kernels K1 (forward) and K2
(backward), their plain versions, and the autograd Function over both.

Counterpart of ``recommendation_tpu/ops/pallas_prop.py::dense_chain_mean``
(``_chain_kernel(forward=True)`` and, through ``_chain_bwd``,
``forward=False``). The forward functions compute

    u_{k+1} = R̂ · i_k ;  i_{k+1} = R̂ᵀ · u_k          (k = 0 .. L-1)
    (mean of u_0..u_L, mean of i_0..i_L)

with f32 accumulation. When R̂ is bf16 the running table is rounded to bf16
right before each product, as the JAX chain's ``astype`` does.

``chain_mean`` launches the hand-written CUDA kernel
(``csrc/chain_mean.cu``, one launch per layer) for CUDA tensors and takes
``chain_mean_plain`` only for CPU tensors. There is no fallback from the
kernel to the plain version on the card: a CUDA input goes through the
kernel or raises. ``chain_mean.launches`` counts the kernel's launches.

The backward functions compute the JAX kernel's Horner chain: with the
cotangents prescaled to su = gu/(L+1), si = gi/(L+1),

    au' = su + R̂ · ai ;  ai' = si + R̂ᵀ · au          (L rounds from au=su, ai=si)

from the old au, ai, with the same rounding of the operand as the forward.
``chain_mean_bwd`` launches K2 (the same CUDA source, one launch per round)
for CUDA tensors and runs ``chain_mean_bwd_plain`` for CPU tensors;
``chain_mean_bwd.launches`` counts K2's launches.

``ChainMean`` is the ``torch.autograd.Function`` that training goes
through, on both devices: its forward is ``chain_mean`` and its backward
``chain_mean_bwd``. ``chain_mean`` alone writes its outputs through
ctypes, so on the card it carries no gradient; ``ChainMean`` is what
gives it one. R̂ is never a parameter: its cotangent is None.

NCL's forward needs the mean and one layer of the chain. ``chain_mean_layer``
(kernel K3, counterpart of ``dense_chain_mean_layer``'s
``_chain_layer_fwd_kernel``) returns ``(mean_u, mean_i, u_k, i_k)`` for
``1 <= k <= L``; ``chain_mean_layer_bwd`` (K4, ``_chain_layer_bwd_kernel``)
runs K2's rounds with layer k's cotangent added after round ``j == k``;
``ChainMeanLayer`` is the autograd Function over both, with gradients to
``u0``/``i0`` from all four outputs. ``k == 0`` (the input itself) has no
kernel: the model takes ``ChainMean`` then, as ``ncl.py:118-140`` does.
Each has its plain version and its own launch counter.

All four run one CUDA body (``chain_layer``), one launch per layer, with
the reduction cut into slices across blocks: ``chain_plan`` picks the
shortest slice whose blocks the card still holds at once (one wave),
and a call allocates the slices' partial sums (``_Chain``) and uses one
counter per output tile (``_counters``, zeroed once for each device and
stream, so calls on two streams never share one); the last slice of a
tile to finish adds the partials in slice order and zeroes its counter, so
a call repeats bit for bit. A call's layers after the first are launched
so that each may overlap the previous one's tail (programmatic dependent
launch; the kernel waits for the previous layer before it reads anything
but R̂). R̂ on the card may have padded rows (the dense ``DeviceGraph``
aligns them to 16 bytes); its row stride goes to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_DTYPES = (torch.float32, torch.bfloat16)
# csrc/chain_mean.cu's tile: TM output rows, TK reduction depth, TN columns
TILE_ROWS, TILE_DEPTH, TILE_COLS = 64, 32, 64
K1, K2, K3, K4 = 1, 2, 3, 4  # chain_layer's kernel argument


def _cast_like(r):
    """The rounding the product applies to the running table: to bf16 and
    back when R̂ is bf16, none when it is f32."""
    if r.dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def chain_mean_plain(r: torch.Tensor, u0: torch.Tensor, i0: torch.Tensor, n_layers: int):
    """The chain in plain torch, on any device.

    Reproduces ``preferred_element_type=f32``: ``torch.matmul`` of two bf16
    tensors returns bf16, so the bf16 regime widens R̂ and the rounded table
    to f32 before the product (every bf16 x bf16 product is exact in f32)."""
    rf, cast = r.float(), _cast_like(r)
    u, i = u0.float(), i0.float()
    acc_u, acc_i = u, i
    for _ in range(n_layers):
        u, i = rf @ cast(i), rf.T @ cast(u)
        acc_u, acc_i = acc_u + u, acc_i + i
    inv = 1.0 / (n_layers + 1.0)
    return acc_u * inv, acc_i * inv


def chain_mean_bwd_plain(r: torch.Tensor, gu: torch.Tensor, gi: torch.Tensor, n_layers: int):
    """The backward Horner chain in plain torch, on any device: the
    cotangents of (u0, i0) given those of the two means, in f32."""
    rf, cast = r.float(), _cast_like(r)
    inv = 1.0 / (n_layers + 1.0)
    su, si = gu.float() * inv, gi.float() * inv
    au, ai = su, si
    for _ in range(n_layers):
        au, ai = su + rf @ cast(ai), si + rf.T @ cast(au)
    return au, ai


def chain_mean_layer_plain(r: torch.Tensor, u0: torch.Tensor, i0: torch.Tensor,
                           n_layers: int, k: int):
    """(mean_u, mean_i, u_k, i_k) of the chain in plain torch, on any device."""
    _check_k(n_layers, k)
    rf, cast = r.float(), _cast_like(r)
    u, i = u0.float(), i0.float()
    acc_u, acc_i = u, i
    uk = ik = None
    for layer in range(1, n_layers + 1):
        u, i = rf @ cast(i), rf.T @ cast(u)
        acc_u, acc_i = acc_u + u, acc_i + i
        if layer == k:
            uk, ik = u, i
    inv = 1.0 / (n_layers + 1.0)
    return acc_u * inv, acc_i * inv, uk, ik


def chain_mean_layer_bwd_plain(r: torch.Tensor, gau: torch.Tensor, gai: torch.Tensor,
                               gku: torch.Tensor, gki: torch.Tensor, n_layers: int, k: int):
    """(du0, di0) given the cotangents of the four outputs of
    ``chain_mean_layer``, in plain torch: K2's chain with ``gku``/``gki``
    added to the tables after round ``j == k`` (before the first round when
    ``k == L``)."""
    _check_k(n_layers, k)
    rf, cast = r.float(), _cast_like(r)
    inv = 1.0 / (n_layers + 1.0)
    su, si = gau.float() * inv, gai.float() * inv
    au, ai = su, si
    if k == n_layers:
        au, ai = au + gku, ai + gki
    for j in range(n_layers - 1, -1, -1):
        au, ai = su + rf @ cast(ai), si + rf.T @ cast(au)
        if j == k:
            au, ai = au + gku, ai + gki
    return au, ai


def _check_k(n_layers, k):
    if not (isinstance(k, int) and isinstance(n_layers, int) and 1 <= k <= n_layers):
        raise ValueError(f"the layer k must be an int in [1, n_layers={n_layers}], got {k!r}")


def _check(name, r, u0, i0, n_layers):
    if r.dim() != 2 or u0.dim() != 2 or i0.dim() != 2:
        raise ValueError(f"{name} wants 2-D tensors, got {r.dim()}, {u0.dim()}, {i0.dim()}")
    n_users, n_items = r.shape
    if u0.shape[0] != n_users or i0.shape[0] != n_items or u0.shape[1] != i0.shape[1]:
        raise ValueError(
            f"{name} shapes disagree: r {tuple(r.shape)}, {tuple(u0.shape)}, {tuple(i0.shape)}"
        )
    if r.dtype not in _DTYPES:
        raise TypeError(f"{name} takes r in float32 or bfloat16, got {r.dtype}")
    if u0.dtype != torch.float32 or i0.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tables, got {u0.dtype}, {i0.dtype}")
    if not (r.device == u0.device == i0.device):
        raise ValueError(f"{name} inputs on different devices: {r.device}, {u0.device}, {i0.device}")
    if not isinstance(n_layers, int) or n_layers < 0:
        raise ValueError(f"n_layers must be an int >= 0, got {n_layers!r}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {r.device}")
    if r.device.type == "cuda" and not (
        _rows_contiguous(r) and u0.is_contiguous() and i0.is_contiguous()
    ):
        raise ValueError(f"{name}'s kernel takes contiguous tensors (R̂'s rows may be padded)")


def _rows_contiguous(r):
    """R̂ laid out row after row: unit column stride, a row stride of at
    least a row (the dense DeviceGraph pads it to a multiple of 8)."""
    return r.stride(1) == 1 and r.stride(0) >= max(r.shape[1], 1)


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.chain_error_string(code).decode()}")


def _kernel_lib():
    from recommendation_tpu_torch.ops.build import load

    lib = load("chain_mean")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.chain_layer.argtypes = ([i32, i32, ptr, i64] + [ptr] * 10
                                    + [i32, i32, i32, f32, i32, i32, i32, ptr, ptr, ptr])
        lib.chain_layer.restype = i32
        for fn in (lib.chain_tile, lib.chain_blocks_per_sm):
            fn.argtypes = [i32]
            fn.restype = i32
        lib.chain_error_string.argtypes = [i32]
        lib.chain_error_string.restype = ctypes.c_char_p
        tiles = tuple(lib.chain_tile(w) for w in range(3))
        if tiles != (TILE_ROWS, TILE_DEPTH, TILE_COLS):
            raise RuntimeError(f"chain_mean.cu tiles {tiles} differ from the plan's "
                               f"{(TILE_ROWS, TILE_DEPTH, TILE_COLS)}")
        lib._typed = True
    return lib


def _cdiv(a, b):
    return -(-a // b)


class ChainPlan(NamedTuple):
    """How one layer launch is cut (``csrc/chain_mean.cu``): the reduction
    slice in TK-deep tiles, the blocks, the output tiles (one counter each),
    the slices on each side and the partial sums' workspace in floats (0
    when every tile has one slice)."""

    slice_tiles: int
    blocks: int
    tiles: int
    slices_u: int
    slices_i: int
    partial_floats: int


@functools.lru_cache(maxsize=256)
def chain_plan(n_users: int, n_items: int, d: int, slots: int) -> ChainPlan:
    """The shortest reduction slice (most blocks) whose layer still fits in
    ``slots`` resident blocks, one wave; the whole reduction in one slice
    when even that takes more than a wave."""
    nbu, nbi, ndt = _cdiv(n_users, TILE_ROWS), _cdiv(n_items, TILE_ROWS), _cdiv(d, TILE_COLS)
    ku, ki = _cdiv(n_items, TILE_DEPTH), _cdiv(n_users, TILE_DEPTH)

    def blocks(q):
        return ndt * (nbu * _cdiv(ku, q) + nbi * _cdiv(ki, q))

    longest = max(ku, ki)
    q = next((q for q in range(1, longest + 1) if blocks(q) <= slots), longest)
    su, si = _cdiv(ku, q), _cdiv(ki, q)
    partial = ndt * (nbu * su + nbi * si) * TILE_ROWS * TILE_COLS if max(su, si) > 1 else 0
    return ChainPlan(q, blocks(q), ndt * (nbu + nbi), su, si, partial)


_SLOTS: dict[tuple[torch.device, bool], int] = {}


def _slots(lib, device: torch.device, bf16: bool) -> int:
    """Blocks of a layer launch that the card holds at once: its SMs times
    what one SM holds of the kernel (``chain_blocks_per_sm``)."""
    key = (device, bf16)
    if key not in _SLOTS:
        with torch.cuda.device(device):
            per_sm = lib.chain_blocks_per_sm(int(bf16))
        if per_sm <= 0:
            raise RuntimeError("chain_mean.cu: the runtime gave no occupancy for the layer kernel")
        _SLOTS[key] = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return _SLOTS[key]


_COUNTS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """``n`` tile counters on ``device`` for the calls on ``stream`` (its
    ``cuda_stream`` handle), zero. Zeroed once and shared by every call on
    that stream: each layer's last blocks set their counters back to zero,
    so the next launch on the stream finds them so. Another stream gets
    buffers of its own, so two streams' launches never race on a counter."""
    key = (device, stream)
    count = _COUNTS.get(key)
    if count is None or count.numel() < n:
        count = _COUNTS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return count


class _Chain:
    """One call's launches of ``chain_layer``: the plan, its workspace (the
    slices' partial sums and the tile counters) and the stream."""

    def __init__(self, lib, kernel, r, d, name):
        self.lib, self.kernel, self.r, self.d, self.name = lib, kernel, r, d, name
        n_users, n_items = r.shape
        self.plan = chain_plan(n_users, n_items, d,
                               _slots(lib, r.device, r.dtype == torch.bfloat16))
        self.stream = torch.cuda.current_stream(r.device).cuda_stream
        self.partial = self.count = None
        if self.plan.partial_floats:
            self.partial = torch.empty(self.plan.partial_floats, dtype=torch.float32,
                                       device=r.device)
            self.count = _counters(r.device, self.stream, self.plan.tiles)
        self.chained = 0  # the first layer follows some other launch

    def layer(self, src, dst, acc_in, acc_out=(None, None), inj=(None, None), scale=1.0,
              write_next=1):
        r = self.r
        code = self.lib.chain_layer(
            self.kernel, int(r.dtype == torch.bfloat16), r.data_ptr(), r.stride(0),
            *(_ptr(t) for t in (*src, *dst, *acc_in, *acc_out, *inj)),
            r.shape[0], r.shape[1], self.d, scale, write_next, self.plan.slice_tiles,
            self.chained, _ptr(self.partial), _ptr(self.count), self.stream,
        )
        _raise_on(self.lib, code, self.name)
        self.chained = 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def chain_mean(r: torch.Tensor, u0: torch.Tensor, i0: torch.Tensor, n_layers: int):
    """(mean_u f32[U, d], mean_i f32[I, d]) of the layer chain over R̂ [U, I].

    ``r`` is float32 or bfloat16; ``u0`` and ``i0`` are float32. All three are
    contiguous and on one device. CUDA tensors run the kernel; CPU tensors
    run ``chain_mean_plain``."""
    _check("chain_mean", r, u0, i0, n_layers)
    if r.device.type == "cpu":
        return chain_mean_plain(r, u0, i0, n_layers)
    d = u0.shape[1]
    out_u = torch.empty_like(u0)
    out_i = torch.empty_like(i0)
    if n_layers == 0:  # no product to run: the mean of layer 0 alone
        return out_u.copy_(u0), out_i.copy_(i0)
    # ping-pong buffers for the running layer tables; the readout
    # accumulates into the outputs in place
    bufs = [(torch.empty_like(u0), torch.empty_like(i0)) for _ in range(min(n_layers - 1, 2))]
    inv = 1.0 / (n_layers + 1.0)
    src, acc = (u0, i0), (u0, i0)
    with torch.cuda.device(r.device):
        chain = _Chain(_kernel_lib(), K1, r, d, "chain_mean")
        for layer in range(n_layers):
            last = layer == n_layers - 1
            dst = src if last else bufs[layer % 2]
            chain.layer(src, dst, acc, (out_u, out_i), scale=inv if last else 1.0,
                        write_next=0 if last else 1)
            chain_mean.launches += 1
            src, acc = dst, (out_u, out_i)
    return out_u, out_i


chain_mean.launches = 0


def chain_mean_bwd(r: torch.Tensor, gu: torch.Tensor, gi: torch.Tensor, n_layers: int):
    """(du0 f32[U, d], di0 f32[I, d]): the cotangents of ``chain_mean``'s
    inputs given ``gu``, ``gi``, those of its two outputs.

    CUDA tensors run kernel K2, one launch per round; CPU tensors run
    ``chain_mean_bwd_plain``. The prescale by 1/(L+1) happens here, before
    the first round, as in ``_chain_bwd``: the bf16 rounding of the first
    round's operand then matches the JAX kernel's."""
    _check("chain_mean_bwd", r, gu, gi, n_layers)
    if r.device.type == "cpu":
        return chain_mean_bwd_plain(r, gu, gi, n_layers)
    inv = 1.0 / (n_layers + 1.0)
    seed_u, seed_i = gu * inv, gi * inv
    if n_layers == 0:
        return seed_u, seed_i
    # round k writes ``out`` when L-1-k is even, else ``tmp``, so the last
    # round lands in ``out`` and no round writes the tables it reads
    out = (torch.empty_like(seed_u), torch.empty_like(seed_i))
    tmp = (torch.empty_like(seed_u), torch.empty_like(seed_i)) if n_layers > 1 else None
    src = (seed_u, seed_i)
    with torch.cuda.device(r.device):
        chain = _Chain(_kernel_lib(), K2, r, gu.shape[1], "chain_mean_bwd")
        for layer in range(n_layers):
            dst = out if (n_layers - 1 - layer) % 2 == 0 else tmp
            chain.layer(src, dst, (seed_u, seed_i))
            chain_mean_bwd.launches += 1
            src = dst
    return out


chain_mean_bwd.launches = 0


class ChainMean(torch.autograd.Function):
    """``chain_mean`` with a gradient: K1 forward, K2 backward on the card,
    the two plain versions on the CPU. Gradients flow to ``u0`` and ``i0``;
    R̂ and ``n_layers`` get None."""

    @staticmethod
    def forward(ctx, r, u0, i0, n_layers):
        ctx.save_for_backward(r)
        ctx.n_layers = n_layers
        return chain_mean(r, u0, i0, n_layers)

    @staticmethod
    def backward(ctx, gu, gi):
        (r,) = ctx.saved_tensors
        du, di = chain_mean_bwd(r, gu.contiguous(), gi.contiguous(), ctx.n_layers)
        return None, du, di, None


def chain_mean_layer(r: torch.Tensor, u0: torch.Tensor, i0: torch.Tensor, n_layers: int, k: int):
    """(mean_u, mean_i, u_k, i_k), all f32: the layer-mean readout and
    layer ``k`` (1 <= k <= L) of the chain over R̂ [U, I].

    CUDA tensors run kernel K3, one launch per layer: layer ``k`` writes its
    tables straight into ``u_k``/``i_k``, which the next layer reads. CPU
    tensors run ``chain_mean_layer_plain``."""
    _check("chain_mean_layer", r, u0, i0, n_layers)
    _check_k(n_layers, k)
    if r.device.type == "cpu":
        return chain_mean_layer_plain(r, u0, i0, n_layers, k)
    out_u, out_i = torch.empty_like(u0), torch.empty_like(i0)
    uk, ik = torch.empty_like(u0), torch.empty_like(i0)
    # the running tables go through ping-pong buffers, except layer k's,
    # which land in the snapshot; no layer writes the tables it reads
    bufs = [(torch.empty_like(u0), torch.empty_like(i0)) for _ in range(2)]
    inv = 1.0 / (n_layers + 1.0)
    src, acc = (u0, i0), (u0, i0)
    with torch.cuda.device(r.device):
        chain = _Chain(_kernel_lib(), K3, r, u0.shape[1], "chain_mean_layer")
        for layer in range(1, n_layers + 1):
            last = layer == n_layers
            dst = (uk, ik) if layer == k else bufs[layer % 2]
            write = layer == k or not last
            chain.layer(src, dst, acc, (out_u, out_i), scale=inv if last else 1.0,
                        write_next=1 if write else 0)
            chain_mean_layer.launches += 1
            src, acc = dst, (out_u, out_i)
    return out_u, out_i, uk, ik


chain_mean_layer.launches = 0


def chain_mean_layer_bwd(r: torch.Tensor, gau: torch.Tensor, gai: torch.Tensor,
                         gku: torch.Tensor, gki: torch.Tensor, n_layers: int, k: int):
    """(du0 f32[U, d], di0 f32[I, d]): the cotangents of
    ``chain_mean_layer``'s inputs given those of its four outputs.

    CUDA tensors run kernel K4, one launch per round. As in
    ``_chain_layer_bwd``, only the mean's cotangents are prescaled by
    1/(L+1); layer k's are added as they are, to the starting tables when
    ``k == L`` and in round ``j == k``'s epilogue otherwise. CPU tensors run
    ``chain_mean_layer_bwd_plain``."""
    _check("chain_mean_layer_bwd", r, gau, gai, n_layers)
    _check("chain_mean_layer_bwd", r, gku, gki, n_layers)
    _check_k(n_layers, k)
    if r.device.type == "cpu":
        return chain_mean_layer_bwd_plain(r, gau, gai, gku, gki, n_layers, k)
    inv = 1.0 / (n_layers + 1.0)
    seed_u, seed_i = gau * inv, gai * inv
    out = (torch.empty_like(seed_u), torch.empty_like(seed_i))
    tmp = (torch.empty_like(seed_u), torch.empty_like(seed_i)) if n_layers > 1 else None
    src = (seed_u + gku, seed_i + gki) if k == n_layers else (seed_u, seed_i)
    with torch.cuda.device(r.device):
        chain = _Chain(_kernel_lib(), K4, r, gau.shape[1], "chain_mean_layer_bwd")
        for layer in range(n_layers):
            j = n_layers - 1 - layer
            dst = out if j % 2 == 0 else tmp
            chain.layer(src, dst, (seed_u, seed_i), inj=(gku, gki) if j == k else (None, None))
            chain_mean_layer_bwd.launches += 1
            src = dst
    return out


chain_mean_layer_bwd.launches = 0


class ChainMeanLayer(torch.autograd.Function):
    """``chain_mean_layer`` with a gradient: K3 forward, K4 backward on the
    card, the plain versions on the CPU. Gradients flow to ``u0`` and ``i0``
    from all four outputs (an unused output's cotangent arrives as zeros);
    R̂, ``n_layers`` and ``k`` get None."""

    @staticmethod
    def forward(ctx, r, u0, i0, n_layers, k):
        ctx.save_for_backward(r)
        ctx.n_layers, ctx.k = n_layers, k
        return chain_mean_layer(r, u0, i0, n_layers, k)

    @staticmethod
    def backward(ctx, gau, gai, gku, gki):
        (r,) = ctx.saved_tensors
        du, di = chain_mean_layer_bwd(r, gau.contiguous(), gai.contiguous(), gku.contiguous(),
                                      gki.contiguous(), ctx.n_layers, ctx.k)
        return None, du, di, None, None
