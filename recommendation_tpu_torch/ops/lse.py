"""Full-catalog logsumexp: kernels K5 (forward) and K6 (backward), their
plain versions, and the autograd Function over both.

Counterpart of the catalog part of ``recommendation_tpu/ops/pallas_losses.py``
(``catalog_logsumexp``: ``_lse_fwd_kernel`` and ``_lse_bwd_kernel``). NCL's
layer-contrast loss takes its two denominators through it
(``models/ncl.py:171,174``):

    lse[b] = logsumexp_n(q[b] · x[n] / τ)        q [B, d], x [N, d] f32 → [B] f32
    p = exp(q·xᵀ/τ − lse) · g ;  dq = p·x/τ ;  dx = pᵀ·q/τ

``catalog_lse`` launches K5 (``csrc/catalog_lse.cu``) for CUDA tensors and
runs ``catalog_lse_plain`` for CPU tensors; ``catalog_lse_bwd`` launches
K6 as two kernels, one for dq and one for dx, and runs
``catalog_lse_bwd_plain`` for CPU tensors. There is no fallback on the card
and no size threshold: a CUDA input goes through the kernel or the call
raises. ``catalog_lse.launches`` counts K5's launches (one per call) and
``catalog_lse_bwd.launches`` K6's (two per call). ``CatalogLSE`` saves
``(q, x, lse)`` as ``_clse_fwd`` does and recomputes the scores in the
backward.

Not ported, because each is a TPU form and not part of what the function
computes: ``FUSED_MIN_ROWS`` (below 4096 rows the JAX package takes XLA's
logsumexp, a TPU launch-overhead measurement), ``MAX_FUSED_B`` and
``_chunked_lse`` (a sequential sweep over 1024-row query chunks that keeps
the kernel's [B, block_n] score tile inside the TPU's scoped VMEM),
``_auto_block_n`` (the item-block size from that VMEM budget) and
``interpret`` (Pallas's CPU mode; here the CPU runs the plain version). The
H100 kernels stream fixed tiles through shared memory at any B and N.
``uniformity_streaming`` is not a kernel (a ``lax.scan``); it comes with
DirectAU.
"""

from __future__ import annotations

import ctypes

import torch


def catalog_lse_plain(q: torch.Tensor, x: torch.Tensor, tau: float) -> torch.Tensor:
    """logsumexp(q·xᵀ/τ, dim=1) in plain torch, materializing [B, N]."""
    return torch.logsumexp(q @ x.T / tau, dim=1)


def catalog_lse_bwd_plain(q: torch.Tensor, x: torch.Tensor, tau: float, lse: torch.Tensor,
                          g: torch.Tensor):
    """(dq, dx) of ``catalog_lse`` given its value ``lse`` and cotangent
    ``g``, in plain torch."""
    p = torch.exp(q @ x.T / tau - lse[:, None]) * g[:, None]
    return p @ x / tau, p.T @ q / tau


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
        lib.lse_fwd_f32.argtypes = [ptr, ptr, i32, i32, i32, f32, ptr, ptr]
        lib.lse_fwd_f32.restype = i32
        for fn in (lib.lse_bwd_dq_f32, lib.lse_bwd_dx_f32):
            fn.argtypes = [ptr] * 4 + [i32, i32, i32, f32, ptr, ptr]
            fn.restype = i32
        lib.lse_max_d.argtypes = []
        lib.lse_max_d.restype = i32
        lib.lse_error_string.argtypes = [i32]
        lib.lse_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launchable(name, lib, q):
    if q.shape[1] > lib.lse_max_d():
        raise ValueError(f"{name}'s kernel takes d <= {lib.lse_max_d()}, got {q.shape[1]}")


def _raise_on(lib, code, name):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.lse_error_string(code).decode()}")


def catalog_lse(q: torch.Tensor, x: torch.Tensor, tau: float) -> torch.Tensor:
    """lse f32[B] = logsumexp(q·xᵀ/τ, dim=1) without materializing [B, N].

    ``q`` [B, d] and ``x`` [N, d] are float32, contiguous and on one device.
    CUDA tensors run K5 (one launch); CPU tensors run ``catalog_lse_plain``."""
    _check("catalog_lse", q, x)
    if q.device.type == "cpu":
        return catalog_lse_plain(q, x, tau)
    lib = _kernel_lib()
    _launchable("catalog_lse", lib, q)
    (b, d), n = q.shape, x.shape[0]
    lse = torch.empty(b, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.lse_fwd_f32(q.data_ptr(), x.data_ptr(), b, n, d, float(tau), lse.data_ptr(),
                               stream)
    _raise_on(lib, code, "catalog_lse")
    catalog_lse.launches += 1
    return lse


catalog_lse.launches = 0


def catalog_lse_bwd(q: torch.Tensor, x: torch.Tensor, tau: float, lse: torch.Tensor,
                    g: torch.Tensor):
    """(dq f32[B, d], dx f32[N, d]): the cotangents of ``catalog_lse``'s
    inputs given its output ``lse`` and that output's cotangent ``g``.

    CUDA tensors run K6: one launch over query tiles for dq and one over
    item tiles for dx, both recomputing the scores (two launches a call).
    CPU tensors run ``catalog_lse_bwd_plain``."""
    _check("catalog_lse_bwd", q, x, lse, g)
    if q.device.type == "cpu":
        return catalog_lse_bwd_plain(q, x, tau, lse, g)
    lib = _kernel_lib()
    _launchable("catalog_lse_bwd", lib, q)
    (b, d), n = q.shape, x.shape[0]
    dq, dx = torch.empty_like(q), torch.empty_like(x)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for fn, out in ((lib.lse_bwd_dq_f32, dq), (lib.lse_bwd_dx_f32, dx)):
            code = fn(q.data_ptr(), x.data_ptr(), lse.data_ptr(), g.data_ptr(), b, n, d,
                      float(tau), out.data_ptr(), stream)
            _raise_on(lib, code, "catalog_lse_bwd")
            catalog_lse_bwd.launches += 1
    return dq, dx


catalog_lse_bwd.launches = 0


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
