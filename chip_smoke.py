#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and check them.

    python3 chip_smoke.py

What it does, in order (any failed phase exits non-zero):
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the paths from ``recommendation_tpu_torch/csrc``,
     one ``nvcc`` per source, all at once;
  3. kernel phase: holds each kernel against its plain PyTorch version on
     the card and times the kernel, the plain version and the nearest
     library calls: K1 ``chain_mean`` and K2 ``chain_mean_bwd`` at the
     serving shape and at an unaligned one; K3 ``chain_mean_layer`` and K4
     ``chain_mean_layer_bwd`` at the bench shape and at 37x53x8 for (L, k)
     in (3,1), (3,2), (3,3), (1,1); K5 ``catalog_lse`` and K6
     ``catalog_lse_bwd`` at NCL's two step shapes and a ragged one;
  4. one-step checks: one LightGCN step's loss and gradients through
     ``ChainMean`` (K1 + K2) against autograd through the plain chain; one
     NCL step through K3-K6 against the plain path, for the full loss, the
     layer contrast alone at unit weight and ProtoNCE alone, each bound
     also rejecting zero gradients; at the bench shape;
  5. serve phase: synthetic ML-100K (the ``bench.py`` configuration),
     LightGCN d=64 L=3 with seeded random weights, saved and reloaded
     through ``weights``; ``cli.build_service`` on ``cuda``; 320 requests
     from 16 client threads through the MicroBatcher and one ``GET
     /recommend`` over HTTP, each answer held against the plain path's on
     the card. It runs in bf16 (``bench.py``'s default) and in f32 (the
     CLI's default);
  6. train phase: ``GraphRecommender`` on ``cuda`` at the bench shape
     (B=2048, Adam 1e-3) for TRAIN_EPOCHS epochs with an evaluation after
     each, then a few requests from ``RecommenderService.from_recommender``.
     The mean loss must fall, Recall@20 must beat the most-popular list
     (and come within 0.005 of it with train positives masked),
     K1 and K2 must launch 3 times a step (plus K1 for each evaluation),
     and a ``torch.profiler`` window of 20 steps says where the step's time
     goes. In bf16 and in f32;
  7. NCL train phase: the same for NCL at its defaults (d=64, L=3, context
     layer 2, tau 0.1, 24 user and 42 item clusters, an E-step per epoch):
     K3 and K4 launch 3 times a step, K5 twice, K6 four times (two
     launches a call), K1 3 times per E-step and per evaluation, K2 never;
     after each E-step every assignment lies in [0, k) and the k-means
     inertia is no higher than at the initial centroids;
  8. prints the serving line, the training line, the NCL line, the kernels
     line and, last, the device line.

Launch counts are reset just before each main path and read just after it.
Exits non-zero without printing a result where no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from recommendation_tpu_torch.cli import build_service
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
from recommendation_tpu_torch.evalx.metrics import ranking_metrics
from recommendation_tpu_torch.evalx.ranking import evaluate_ranking
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.ops import build as kernels
from recommendation_tpu_torch.ops.lse import (
    catalog_lse,
    catalog_lse_bwd,
    catalog_lse_bwd_plain,
    catalog_lse_plain,
)
from recommendation_tpu_torch.ops.prop import (
    ChainMean,
    chain_mean,
    chain_mean_bwd,
    chain_mean_bwd_plain,
    chain_mean_layer,
    chain_mean_layer_bwd,
    chain_mean_layer_bwd_plain,
    chain_mean_layer_plain,
    chain_mean_plain,
)
from recommendation_tpu_torch.ops.topk import topk_agree
from recommendation_tpu_torch.sampling import (
    PairwiseBatch,
    epoch_batches,
    epoch_words,
    popularity_baseline_topk,
)
from recommendation_tpu_torch.serve.http import serve_http
from recommendation_tpu_torch.serve.service import RecommenderService
from recommendation_tpu_torch.train.loop import run_steps
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import load_params, save_params

# H100 SXM data sheet peaks (dense): the least time any kernel could take
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_SHAPE = dict(n_users=943, n_items=1682, n_interactions=100_000, seed=7)
EMB, LAYERS, K = 64, 3, 10
# kernel vs plain: the JAX kernel's own test bounds (tests/test_pallas_prop.py),
# on values and on gradients (a training step's gradients: see grads_agree)
TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 2e-3)}  # (rtol, atol)
GRAD_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (3e-2, 3e-3)}
N_CLIENTS, REQS_PER_CLIENT = 16, 20
# training: bench.py's batch and rate; epochs enough for the loss to fall
# and Recall@20 to pass the popularity baseline, few enough to stay short
BATCH, LR, TRAIN_EPOCHS, PROFILE_STEPS = 2048, 1e-3, 5, 20
# NCL: its defaults; the context layer of hyper_layers 1 is k = 2
NCL_K, TAU = 2, 0.1
LAYER_CASES = ((3, 1), (3, 2), (3, 3), (1, 1))
# K5/K6 against plain on l2-normalized rows (what NCL feeds them), tau 0.1:
# scores within +-10. The two sum each score's d products in another order,
# which moves a score by about 1e-6 and exp(s - lse) by as much relatively;
# dq and dx sum N or B such terms and keep that relative size.
LSE_TOL = (1e-5, 1e-5)  # (rtol, atol) on lse
LSE_GRAD_TOL = (1e-4, 1e-5)  # on dq, dx
COUNTERS = (chain_mean, chain_mean_bwd, chain_mean_layer, chain_mean_layer_bwd, catalog_lse,
            catalog_lse_bwd)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` with a cold L2 (a 64 MB write between
    runs): the chain runs once per model load, so R̂ is not cached."""
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def chain_bound(r, d, n_layers, tables=2):
    """(bound_ms, bound_by): bytes = R̂ + ``tables`` f32 [U+I, d] tables
    moved, each once (K1, K2: the tables in, the means out; K3 adds the
    snapshot written, K4 the layer cotangent read); operations = 2L products
    of 2·U·I·d at R̂'s type's peak."""
    n_users, n_items = r.shape
    nbytes = r.numel() * r.element_size() + tables * (n_users + n_items) * d * 4
    flops = 2 * n_layers * 2 * n_users * n_items * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[r.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_chain(r, u0, i0, n_layers):
    """The same chain as 2L cuBLAS matmuls in R̂'s type: a yardstick only."""
    u, i = u0.to(r.dtype), i0.to(r.dtype)
    for _ in range(n_layers):
        u, i = torch.matmul(r, i), torch.matmul(r.T, u)
    return u, i


def library_chain_bwd(r, gu, gi, n_layers):
    """K2's Horner chain as 2L cuBLAS matmuls in R̂'s type: a yardstick only."""
    inv = 1.0 / (n_layers + 1.0)
    su, si = (gu * inv).to(r.dtype), (gi * inv).to(r.dtype)
    au, ai = su, si
    for _ in range(n_layers):
        au, ai = su + torch.matmul(r, ai), si + torch.matmul(r.T, au)
    return au, ai


def lse_bound(shapes, products):
    """(bound_ms, bound_by) of ``products`` f32 products of 2·B·N·d over the
    (B, N, d) shapes, at the f32 FFMA peak, against the bytes of q, x and
    the [B] vectors read and the outputs written once. K5: 1 product,
    reads q, x, writes lse; K6: 3 products (the scores, dq, dx), reads q, x,
    lse, g, writes dq, dx."""
    flops = sum(products * 2 * b * n * d for b, n, d in shapes)
    if products == 1:
        nbytes = sum((b * d + n * d + b) * 4 for b, n, d in shapes)
    else:
        nbytes = sum((2 * (b * d + n * d) + 2 * b) * 4 for b, n, d in shapes)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_chain_layer(r, u0, i0, n_layers, k):
    """K3's chain as 2L cuBLAS matmuls in R̂'s type, keeping layer k: a
    yardstick only."""
    u, i = u0.to(r.dtype), i0.to(r.dtype)
    uk = ik = None
    for layer in range(1, n_layers + 1):
        u, i = torch.matmul(r, i), torch.matmul(r.T, u)
        if layer == k:
            uk, ik = u, i
    return u, i, uk, ik


def library_chain_layer_bwd(r, gu, gi, gku, gki, n_layers, k):
    """K4's chain as 2L cuBLAS matmuls in R̂'s type, with layer k's
    cotangent injected: a yardstick only."""
    inv = 1.0 / (n_layers + 1.0)
    su, si = (gu * inv).to(r.dtype), (gi * inv).to(r.dtype)
    gku, gki = gku.to(r.dtype), gki.to(r.dtype)
    au, ai = (su + gku, si + gki) if k == n_layers else (su, si)
    for j in range(n_layers - 1, -1, -1):
        au, ai = su + torch.matmul(r, ai), si + torch.matmul(r.T, au)
        if j == k:
            au, ai = au + gku, ai + gki
    return au, ai


def library_lse_bwd(q, x, tau, g):
    """K6's gradient from a softmax and two cuBLAS matmuls: a yardstick only."""
    p = torch.softmax(q @ x.T / tau, dim=1) * g[:, None]
    return torch.matmul(p, x) / tau, torch.matmul(p.T, q) / tau


def compare(name, got, want, dtype, tol=TOL):
    rtol, atol = tol[dtype]
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not (torch.isfinite(g).all() and torch.allclose(g, w, rtol=rtol, atol=atol)):
            raise RuntimeError(f"{name}: kernel disagrees with plain (max abs err {err})")
    return err


def grads_agree(got, want, dtype) -> bool:
    """Gradients against the plain ones at GRAD_TOL, its atol taken relative
    to the reference's largest entry: the JAX bounds are for O(1)
    cotangents, and a batch-mean loss has gradients of order 1/B."""
    rtol, atol = GRAD_TOL[dtype]
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        if not (scale > 0 and torch.isfinite(g).all()
                and torch.allclose(g, w, rtol=rtol, atol=atol * scale)):
            return False
    return True


def kernel_phase(graphs, params):
    rows = {}
    rng = np.random.default_rng(0)
    for dtype, graph in graphs.items():
        r = graph.propagation_matrix
        u0, i0 = params["user_emb"], params["item_emb"]
        err = compare(f"chain_mean {dtype} serve shape",
                      chain_mean(r, u0, i0, LAYERS), chain_mean_plain(r, u0, i0, LAYERS), dtype)
        # unaligned shape, O(1) values, as the JAX kernel's test
        for n_layers in (1, 3):
            ru = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32) * 0.1)
            ru = ru.to("cuda", dtype)
            uu = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).cuda()
            iu = torch.from_numpy(rng.normal(size=(53, 8)).astype(np.float32)).cuda()
            compare(f"chain_mean {dtype} 37x53x8 L={n_layers}", chain_mean(ru, uu, iu, n_layers),
                    chain_mean_plain(ru, uu, iu, n_layers), dtype)
        torch.cuda.synchronize()
        ms = time_ms(lambda: chain_mean(r, u0, i0, LAYERS))
        plain_ms = time_ms(lambda: chain_mean_plain(r, u0, i0, LAYERS))
        library_ms = time_ms(lambda: library_chain(r, u0, i0, LAYERS))
        bound_ms, bound_by = chain_bound(r, EMB, LAYERS)
        rows[dtype] = {
            "name": "chain_mean",
            "dtype": str(dtype).replace("torch.", ""),
            "route": "cuda",
            "source": "recommendation_tpu_torch/csrc/chain_mean.cu",
            "replaces": "recommendation_tpu/ops/pallas_prop.py:66",
            "shape": [r.shape[0], r.shape[1], EMB, LAYERS],
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
    return rows


def kernel_phase_bwd(graphs, params):
    """K2 against chain_mean_bwd_plain: at the serve shape on the graph's R̂
    with O(1) cotangents, and at 37x53x8 on random O(1) inputs, L in {1, 3}."""
    rows = {}
    rng = np.random.default_rng(1)
    n_users, n_items = graphs[torch.float32].propagation_matrix.shape
    gu = torch.from_numpy(rng.normal(size=(n_users, EMB)).astype(np.float32)).cuda()
    gi = torch.from_numpy(rng.normal(size=(n_items, EMB)).astype(np.float32)).cuda()
    for dtype, graph in graphs.items():
        r = graph.propagation_matrix
        err = compare(f"chain_mean_bwd {dtype} serve shape", chain_mean_bwd(r, gu, gi, LAYERS),
                      chain_mean_bwd_plain(r, gu, gi, LAYERS), dtype, GRAD_TOL)
        for n_layers in (1, 3):
            ru = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32) * 0.1)
            ru = ru.to("cuda", dtype)
            gu_s = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).cuda()
            gi_s = torch.from_numpy(rng.normal(size=(53, 8)).astype(np.float32)).cuda()
            compare(f"chain_mean_bwd {dtype} 37x53x8 L={n_layers}",
                    chain_mean_bwd(ru, gu_s, gi_s, n_layers),
                    chain_mean_bwd_plain(ru, gu_s, gi_s, n_layers), dtype, GRAD_TOL)
        torch.cuda.synchronize()
        ms = time_ms(lambda: chain_mean_bwd(r, gu, gi, LAYERS))
        plain_ms = time_ms(lambda: chain_mean_bwd_plain(r, gu, gi, LAYERS))
        library_ms = time_ms(lambda: library_chain_bwd(r, gu, gi, LAYERS))
        bound_ms, bound_by = chain_bound(r, EMB, LAYERS)  # the same work as K1
        rows[dtype] = {
            "name": "chain_mean_bwd",
            "dtype": str(dtype).replace("torch.", ""),
            "route": "cuda",
            "source": "recommendation_tpu_torch/csrc/chain_mean.cu",
            "replaces": "recommendation_tpu/ops/pallas_prop.py:66",
            "shape": [r.shape[0], r.shape[1], EMB, LAYERS],
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
    return rows


def kernel_phase_layer(graphs, params):
    """K3 and K4 against their plain versions: at the bench shape on the
    graph's R̂ (xavier tables, O(1) cotangents) and at 37x53x8 on random
    O(1) inputs, for each (L, k) of LAYER_CASES; timed at NCL's (3, 2)."""
    rows, bwd_rows = {}, {}
    rng = np.random.default_rng(2)
    n_users, n_items = graphs[torch.float32].propagation_matrix.shape
    gu, gi, gku, gki = (torch.from_numpy(rng.normal(size=(n, EMB)).astype(np.float32)).cuda()
                        for n in (n_users, n_items, n_users, n_items))
    u0, i0 = params["user_emb"], params["item_emb"]
    for dtype, graph in graphs.items():
        r = graph.propagation_matrix
        err = err_b = 0.0
        for n_layers, k in LAYER_CASES:
            e = compare(f"chain_mean_layer {dtype} bench shape L={n_layers} k={k}",
                        chain_mean_layer(r, u0, i0, n_layers, k),
                        chain_mean_layer_plain(r, u0, i0, n_layers, k), dtype)
            e_b = compare(f"chain_mean_layer_bwd {dtype} bench shape L={n_layers} k={k}",
                          chain_mean_layer_bwd(r, gu, gi, gku, gki, n_layers, k),
                          chain_mean_layer_bwd_plain(r, gu, gi, gku, gki, n_layers, k),
                          dtype, GRAD_TOL)
            if (n_layers, k) == (LAYERS, NCL_K):
                err, err_b = e, e_b
            ru = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32) * 0.1)
            ru = ru.to("cuda", dtype)
            uu, gus, gkus = (torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).cuda()
                             for _ in range(3))
            iu, gis, gkis = (torch.from_numpy(rng.normal(size=(53, 8)).astype(np.float32)).cuda()
                             for _ in range(3))
            compare(f"chain_mean_layer {dtype} 37x53x8 L={n_layers} k={k}",
                    chain_mean_layer(ru, uu, iu, n_layers, k),
                    chain_mean_layer_plain(ru, uu, iu, n_layers, k), dtype)
            compare(f"chain_mean_layer_bwd {dtype} 37x53x8 L={n_layers} k={k}",
                    chain_mean_layer_bwd(ru, gus, gis, gkus, gkis, n_layers, k),
                    chain_mean_layer_bwd_plain(ru, gus, gis, gkus, gkis, n_layers, k),
                    dtype, GRAD_TOL)
        torch.cuda.synchronize()
        bound_ms, bound_by = chain_bound(r, EMB, LAYERS, tables=3)
        for out, name, err_, fns in (
            (rows, "chain_mean_layer", err, (
                lambda: chain_mean_layer(r, u0, i0, LAYERS, NCL_K),
                lambda: chain_mean_layer_plain(r, u0, i0, LAYERS, NCL_K),
                lambda: library_chain_layer(r, u0, i0, LAYERS, NCL_K))),
            (bwd_rows, "chain_mean_layer_bwd", err_b, (
                lambda: chain_mean_layer_bwd(r, gu, gi, gku, gki, LAYERS, NCL_K),
                lambda: chain_mean_layer_bwd_plain(r, gu, gi, gku, gki, LAYERS, NCL_K),
                lambda: library_chain_layer_bwd(r, gu, gi, gku, gki, LAYERS, NCL_K))),
        ):
            ms, plain_ms, library_ms = (time_ms(f) for f in fns)
            out[dtype] = {
                "name": name,
                "dtype": str(dtype).replace("torch.", ""),
                "route": "cuda",
                "source": "recommendation_tpu_torch/csrc/chain_mean.cu",
                "replaces": ("recommendation_tpu/ops/pallas_prop.py:203" if out is rows
                             else "recommendation_tpu/ops/pallas_prop.py:240"),
                "shape": [r.shape[0], r.shape[1], EMB, LAYERS, NCL_K],
                "launches": 0,
                "max_abs_err": err_,
                "ms": ms,
                "kernel_ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_us": bound_ms * 1e3,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
    return rows, bwd_rows


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).cuda()


def kernel_phase_lse(n_users, n_items):
    """K5 and K6 against their plain versions on l2-normalized rows at NCL's
    two step shapes (B against the user and the item catalog) and at a
    ragged one. Timed as one step uses them: a call on each catalog."""
    rng = np.random.default_rng(3)
    step_shapes = [(BATCH, n_users, EMB), (BATCH, n_items, EMB)]
    inputs = []
    err = err_b = 0.0
    for b, n, d in step_shapes + [(37, 700, 24)]:
        q, x = unit_rows(rng, b, d), unit_rows(rng, n, d)
        g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).cuda()
        lse = catalog_lse(q, x, TAU)
        want = catalog_lse_plain(q, x, TAU)
        err = max(err, compare(f"catalog_lse {b}x{n}x{d}", [lse], [want], torch.float32,
                               {torch.float32: LSE_TOL}))
        err_b = max(err_b, compare(f"catalog_lse_bwd {b}x{n}x{d}",
                                   catalog_lse_bwd(q, x, TAU, lse, g),
                                   catalog_lse_bwd_plain(q, x, TAU, want, g), torch.float32,
                                   {torch.float32: LSE_GRAD_TOL}))
        if (b, n, d) in step_shapes:
            inputs.append((q, x, g, want))
    torch.cuda.synchronize()

    def both(fn):
        return lambda: [fn(*args) for args in inputs]

    rows = []
    for name, err_, products, fns, source_line in (
        ("catalog_lse", err, 1, (lambda q, x, g, l: catalog_lse(q, x, TAU),
                                 lambda q, x, g, l: catalog_lse_plain(q, x, TAU),
                                 lambda q, x, g, l: torch.logsumexp(q @ x.T / TAU, 1)), 45),
        ("catalog_lse_bwd", err_b, 3, (lambda q, x, g, l: catalog_lse_bwd(q, x, TAU, l, g),
                                       lambda q, x, g, l: catalog_lse_bwd_plain(q, x, TAU, l, g),
                                       lambda q, x, g, l: library_lse_bwd(q, x, TAU, g)), 102),
    ):
        ms, plain_ms, library_ms = (time_ms(both(f)) for f in fns)
        bound_ms, bound_by = lse_bound(step_shapes, products)
        rows.append({
            "name": name,
            "dtype": "float32",
            "route": "cuda",
            "source": "recommendation_tpu_torch/csrc/catalog_lse.cu",
            "replaces": f"recommendation_tpu/ops/pallas_losses.py:{source_line}",
            "shape": [list(s) for s in step_shapes],
            "timed": "one call on each catalog (a step's pair)",
            "launches_per_call": 1 if products == 1 else 2,
            "launches": 0,
            "max_abs_err": err_,
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return rows


class PlainLightGCN(LightGCN):
    """LightGCN with the plain chain (autograd through torch ops) in place
    of ChainMean: the reference a training step is held against."""

    def propagate(self, params, graph):
        return chain_mean_plain(graph.propagation_matrix, params["user_emb"],
                                params["item_emb"], self.n_layers)


def plain_step(model, params, batch, graph):
    """Loss and (user, item) grads by autograd through the plain chain."""
    q = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss, _ = model.loss(q, {}, batch, graph)
    return loss, torch.autograd.grad(loss, [q["user_emb"], q["item_emb"]])


def one_step_check(graphs, params):
    """One step's loss and grads through ChainMean (K1 + K2, the model's
    path) against autograd through chain_mean_plain, on the same batch. The
    bound must also reject zero gradients and those of a shorter chain."""
    config = default_config(**{"embedding.size": EMB, "LightGCN.n_layers": LAYERS})
    model, plain = build("lightgcn", config), PlainLightGCN(config)
    # a chain one layer short: its gradient must fail the bound, as must zeros
    short = PlainLightGCN(default_config(**{"embedding.size": EMB,
                                            "LightGCN.n_layers": LAYERS - 1}))
    out = {}
    for dtype, graph in graphs.items():
        users, items, negs, weights, _ = epoch_batches(
            epoch_words(torch.Generator().manual_seed(3), graph, BATCH), graph, BATCH)
        batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        k1, k2 = chain_mean.launches, chain_mean_bwd.launches
        u_all, i_all = ChainMean.apply(graph.propagation_matrix, p["user_emb"], p["item_emb"],
                                       LAYERS)
        if u_all.grad_fn is None or i_all.grad_fn is None:
            raise RuntimeError("ChainMean's outputs carry no gradient on the card")
        loss, _ = model.loss(p, {}, batch, graph)
        grads = torch.autograd.grad(loss, [p["user_emb"], p["item_emb"]])
        torch.cuda.synchronize()
        if chain_mean.launches - k1 != 2 * LAYERS or chain_mean_bwd.launches - k2 != LAYERS:
            raise RuntimeError("the step did not run through K1 and K2")
        plain_loss, plain_grads = plain_step(plain, params, batch, graph)
        if not grads_agree(grads, plain_grads, dtype):
            raise RuntimeError(f"one-step grads {dtype}: kernel disagrees with plain")
        wrong = {"zero": [torch.zeros_like(g) for g in plain_grads],
                 "one layer short": plain_step(short, params, batch, graph)[1]}
        for what, g in wrong.items():
            if grads_agree(g, plain_grads, dtype):
                raise RuntimeError(f"one-step bound {dtype} passes the {what} gradient")
        err = max((g - w).abs().max().item() for g, w in zip(grads, plain_grads))
        loss_err = abs(loss.item() - plain_loss.item())
        rtol, atol = TOL[dtype]
        if not (math.isfinite(loss.item()) and loss_err <= atol + rtol * abs(plain_loss.item())):
            raise RuntimeError(f"one-step loss {loss.item()} != plain {plain_loss.item()}")
        out[str(dtype).replace("torch.", "")] = {
            "loss": loss.item(), "loss_abs_err": loss_err, "grad_max_abs_err": err,
            "grad_max_abs": [w.abs().max().item() for w in plain_grads],
        }
    return out


class PlainNCL(NCL):
    """NCL with the plain chain and the plain logsumexp (autograd through
    torch ops) in place of ChainMeanLayer (K3/K4) and CatalogLSE (K5/K6)."""

    def _chain_layer(self, r, u0, i0, k):
        return chain_mean_layer_plain(r, u0, i0, self.n_layers, k)

    def _catalog_lse(self, q, x):
        return catalog_lse_plain(q, x, self.ssl_temp)


def ncl_term(term, model, p, state, batch, graph):
    """NCL's full loss, its layer contrast alone or its ProtoNCE alone.
    ProtoNCE reads layer 0, the parameters themselves, and no kernel."""
    if term == "loss":
        return model.loss(p, state, batch, graph)[0]
    initial = (p["user_emb"], p["item_emb"])
    if term == "ssl":
        _, _, initial, context = model._forward_ctx(p, graph)
        return model._ssl_layer_loss(context, initial, batch.users, batch.pos_items)
    return model._proto_nce(state, initial, batch.users, batch.pos_items, batch.users.shape[0])


def read_counts():
    return {f.__name__: f.launches for f in COUNTERS}


def ncl_one_step_check(graphs, params):
    """One NCL step's gradients through K3-K6 against the plain path's, on
    the same batch and cluster state: the full loss at NCL's default weights
    (the BPR term dominates it: ssl_reg 1e-8, proto_reg 1e-7), then the
    layer contrast alone at unit weight (K3, K4, K5 and K6 on its path), then
    ProtoNCE alone at unit weight. Each bound must also reject zeros."""
    out = {}
    for dtype, graph in graphs.items():
        default = default_config(**{"embedding.size": EMB})
        unit = default_config(**{"embedding.size": EMB, "NCL.ssl_reg": 1.0,
                                 "NCL.proto_reg": 1.0})
        kernel_model = build("ncl", default)
        state = kernel_model.epoch_begin(params, None, graph, torch.Generator().manual_seed(7), 0)
        users, items, negs, weights, _ = epoch_batches(
            epoch_words(torch.Generator().manual_seed(3), graph, BATCH), graph, BATCH)
        batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
        res = {}
        for term, config in (("loss", default), ("ssl", unit), ("proto", unit)):
            got = {}
            for which, model in (("kernel", build("ncl", config)), ("plain", PlainNCL(config))):
                p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
                before = read_counts()
                value = ncl_term(term, model, p, state, batch, graph)
                grads = torch.autograd.grad(value, [p["user_emb"], p["item_emb"]])
                torch.cuda.synchronize()
                counts = {k: v - before[k] for k, v in read_counts().items()}
                got[which] = (value.item(), grads, counts)
            (v_k, g_k, n_k), (v_p, g_p, n_p) = got["kernel"], got["plain"]
            want_k = {"loss": (3, 3, 2, 4), "ssl": (3, 3, 2, 4), "proto": (0, 0, 0, 0)}[term]
            seen = tuple(n_k[f.__name__] for f in COUNTERS[2:])
            if seen != want_k or any(n_p.values()) or n_k["chain_mean_bwd"]:
                raise RuntimeError(f"NCL {term} {dtype} launches {n_k} (plain {n_p})")
            if not (math.isfinite(v_k) and abs(v_k - v_p) <= 1e-5 * abs(v_p) + 1e-6):
                raise RuntimeError(f"NCL {term} {dtype}: {v_k} against plain {v_p}")
            if not grads_agree(g_k, g_p, dtype):
                raise RuntimeError(f"NCL {term} grads {dtype}: kernel disagrees with plain")
            if grads_agree([torch.zeros_like(g) for g in g_p], g_p, dtype):
                raise RuntimeError(f"NCL {term} bound {dtype} passes zero gradients")
            res[term] = {
                "value": v_k, "value_abs_err": abs(v_k - v_p),
                "grad_max_abs_err": max((a - b).abs().max().item() for a, b in zip(g_k, g_p)),
                "grad_max_abs": [w.abs().max().item() for w in g_p],
            }
        out[str(dtype).replace("torch.", "")] = res
    return out


def check_e_steps(records, k_users, k_items):
    """Every recorded E-step: assignments int32 in [0, k), and the inertia
    of the returned (centroids, assignment) no higher than that of the
    initial centroids."""
    rows = []
    for user_all, item_all, draws, state in records:
        row = {}
        for side, x, k in (("user", user_all, k_users), ("item", item_all, k_items)):
            assign, cent = state[f"{side}_2cluster"], state[f"{side}_centroids"]
            if assign.dtype != torch.int32 or cent.shape != (k, EMB):
                raise RuntimeError(f"{side} clusters malformed: {assign.dtype} {tuple(cent.shape)}")
            if not bool(((assign >= 0) & (assign < k)).all()):
                raise RuntimeError(f"{side} assignment outside [0, {k})")
            init = x[draws[side][0].to(x.device)]
            start = torch.cdist(x, init).square().min(dim=1).values.sum().item()
            end = (x - cent[assign.long()]).square().sum().item()
            if not end <= start * (1 + 1e-5):
                raise RuntimeError(f"{side} k-means inertia rose: {start} -> {end}")
            row[side] = {"inertia_init": start, "inertia": end,
                         "clusters_used": int(assign.unique().numel())}
        rows.append(row)
    return rows


def ncl_train_phase(compute_dtype, data):
    """NCL's training main path at one compute dtype; returns (launches, stats)."""
    config = default_config(**{
        "embedding.size": EMB, "batch.size": BATCH, "learning.rate": LR, "optimizer": "adam",
        "max.epoch": TRAIN_EPOCHS, "eval.interval": 1, "item.ranking.topN": [20],
        "graph.compute_dtype": compute_dtype,
    })
    model = build("ncl", config)
    records = []
    e_step = model.e_step

    def recording_e_step(user_all, item_all, draws):
        state = e_step(user_all, item_all, draws)
        records.append((user_all.clone(), item_all.clone(), draws, state))
        return state

    model.e_step = recording_e_step
    for f in COUNTERS:
        f.launches = 0
    t0 = time.perf_counter()
    rec = GraphRecommender(model, data, config, log=Log(echo=False), device="cuda")
    metrics = rec.execute()
    service = RecommenderService.from_recommender(rec)
    uids = list(range(0, data.user_num, 97))
    s_got, i_got = service.recommend_ids(uids, K)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    graph = rec.graph
    n_batches = -(-graph.n_edges // BATCH)
    steps = n_batches * TRAIN_EPOCHS
    n_evals = len(rec.history) + 2  # the per-epoch evaluations, the final test, the service
    want = {"chain_mean": LAYERS * (len(records) + n_evals), "chain_mean_bwd": 0,
            "chain_mean_layer": LAYERS * steps, "chain_mean_layer_bwd": LAYERS * steps,
            "catalog_lse": 2 * steps, "catalog_lse_bwd": 4 * steps}
    if len(records) != TRAIN_EPOCHS or launches != want:
        raise RuntimeError(f"NCL {compute_dtype} launches {launches} with {len(records)} "
                           f"E-steps, expected {want}")
    k_users, k_items = model._k_for(graph.n_users), model._k_for(graph.n_items)
    e_steps = check_e_steps(records, k_users, k_items)
    losses = [e["loss"] for e in rec.epoch_stats]
    if len(losses) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"NCL {compute_dtype} epoch losses malformed: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"NCL {compute_dtype} loss did not fall: {losses}")
    pop_top = popularity_recall(data, graph, 20, masked=False)
    pop = popularity_recall(data, graph, 20)
    if not (metrics["Recall@20"] > pop_top and metrics["Recall@20"] >= pop - 0.005):
        raise RuntimeError(f"NCL {compute_dtype} Recall@20 {metrics['Recall@20']} against "
                           f"popularity {pop_top} (masked {pop})")
    plain_u, plain_i = chain_mean_plain(graph.propagation_matrix, rec.params["user_emb"].detach(),
                                        rec.params["item_emb"].detach(), LAYERS)
    s_plain, i_plain = RecommenderService(plain_u, plain_i, data, graph).recommend_ids(uids, K)
    tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
    if not (np.isfinite(s_got).all() and s_got.shape == (len(uids), K)
            and topk_agree(s_got, i_got, s_plain, i_plain, tol)):
        raise RuntimeError(f"NCL {compute_dtype} served answers differ from plain")
    timed = rec.epoch_stats[1:]  # epoch 0 carries the first calls' set-up
    stats = {
        "compute_dtype": compute_dtype,
        "shape": {"users": graph.n_users, "items": graph.n_items, "edges": graph.n_edges,
                  "d": EMB, "layers": LAYERS, "context_layer": NCL_K, "batch": BATCH,
                  "steps_per_epoch": n_batches, "clusters": [k_users, k_items]},
        "epochs": TRAIN_EPOCHS,
        "epoch_losses": losses,
        "epoch_seconds": [e["seconds"] for e in rec.epoch_stats],
        "examples_per_s": n_batches * BATCH * len(timed) / sum(e["seconds"] for e in timed),
        "examples_per_s_by_epoch": [e["examples_per_s"] for e in rec.epoch_stats],
        "recall@20": metrics["Recall@20"],
        "ndcg@20": metrics["NDCG@20"],
        "popularity_recall@20": pop_top,
        "masked_popularity_recall@20": pop,
        "launches": launches,
        "e_steps": e_steps,
        "served_users": len(uids),
        "wall_s": wall_s,
        "profile": profile_steps(rec),
    }
    return launches, stats


def score_tolerance(u_a, i_a, u_b, i_b):
    """A bound on |s_a - s_b| for s = u·i implied by the two embeddings'
    difference, plus f32 rounding of the dot products themselves."""
    du = (u_a - u_b).abs().max().item()
    di = (i_a - i_b).abs().max().item()
    l1_u = u_b.abs().sum(1).max().item()
    l1_i = i_b.abs().sum(1).max().item()
    return du * l1_i + di * l1_u + 1e-6 * l1_u * l1_i + 1e-9


def profile_waves(service, wave: int = 16, n_waves: int = 20):
    """Where one request wave's time goes: torch.profiler over ``n_waves``
    direct device queries of ``wave`` users (the MicroBatcher's typical wave
    at 16 clients). Returns host wall per wave, device time per wave, the
    device's idle share and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    uids = list(range(wave))
    service._recommend_ids_device(uids, K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_waves):
            service._recommend_ids_device(uids, K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        return {"wave_users": wave, "host_us_per_wave": wall_us / n_waves,
                "device_us_per_wave": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "wave_users": wave,
        "host_us_per_wave": wall_us / n_waves,
        "device_us_per_wave": device_us / n_waves,
        "device_idle_share": 1.0 - device_us / wall_us,
        "top_kernels_us_per_wave": {e.key[:60]: e.self_device_time_total / n_waves for e in top},
    }


def serve_phase(compute_dtype, ckpt, train, test):
    """The main path at one compute dtype; returns (launches, stats)."""
    config = default_config(**{
        "embedding.size": EMB, "LightGCN.n_layers": LAYERS, "graph.compute_dtype": compute_dtype,
    })
    chain_mean.launches = 0
    t0 = time.perf_counter()
    service = build_service("lightgcn", ckpt, config, train, test, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    data, graph = service.data, service.graph
    users = list(data.user)
    latencies, answers, errors = [], {}, []
    lock = threading.Lock()
    gate = threading.Barrier(N_CLIENTS)

    def client(c):
        try:
            gate.wait(timeout=60)
            for j in range(REQS_PER_CLIENT):
                uid = data.get_user_id(users[(c * REQS_PER_CLIENT + j) * 7 % len(users)])
                t = time.perf_counter()
                s, i = service.recommend_ids([uid], K)
                dt = time.perf_counter() - t
                with lock:
                    latencies.append(dt)
                    answers[(c, j)] = (uid, s[0], i[0])
        except Exception as e:  # noqa: BLE001 - reported and failed below
            with lock:
                errors.append(repr(e))

    batcher = service.enable_batching()
    server = serve_http(service, port=0, background=True)
    try:
        # one untimed request first: the dispatcher thread's first CUDA
        # calls set up its cuBLAS handle, which is start-up, not serving
        service.recommend_ids([0], K)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serve clients failed: {errors[:3]}")
        http_user = users[1]
        url = f"http://127.0.0.1:{server.server_address[1]}/recommend?user={http_user}&k={K}"
        with urllib.request.urlopen(url, timeout=60) as resp:
            http_items = json.load(resp)["items"]
    finally:
        server.shutdown()
        server.server_close()
        service.disable_batching()
    launches = chain_mean.launches  # read just after the main path

    # the plain path on the card: same graph, same weights, plain chain
    params = load_params(ckpt, "lightgcn", device=graph.device)
    plain_u, plain_i = chain_mean_plain(
        graph.propagation_matrix, params["user_emb"], params["item_emb"], LAYERS
    )
    dtype = graph.propagation_matrix.dtype
    compare(f"serve embeddings {compute_dtype}", (service.user_emb, service.item_emb),
            (plain_u, plain_i), dtype)
    plain = RecommenderService(plain_u, plain_i, data, graph)
    tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
    keys = sorted(answers)
    uids = [answers[key][0] for key in keys]
    s_plain, i_plain = plain.recommend_ids(uids, K)
    s_got = np.stack([answers[key][1] for key in keys])
    i_got = np.stack([answers[key][2] for key in keys])
    if s_got.shape != (len(keys), K) or not np.isfinite(s_got).all():
        raise RuntimeError(f"serve answers malformed: shape {s_got.shape}")
    if not topk_agree(s_got, i_got, s_plain, i_plain, tol):
        raise RuntimeError(f"served answers differ from the plain path's (tol {tol})")
    s_h, i_h = plain.recommend_ids([data.get_user_id(http_user)], K)
    s_http = np.array([[x["score"] for x in http_items]], np.float32)
    i_http = np.array([[data.get_item_id(x["item"]) for x in http_items]])
    if not topk_agree(s_http, i_http, s_h, i_h, tol):
        raise RuntimeError("HTTP answer differs from the plain path's")
    if not (service.user_emb.is_cuda and service.item_emb.is_cuda
            and graph.propagation_matrix.is_cuda and graph.user_positives.is_cuda):
        raise RuntimeError("serving tables are not on the card")
    metrics = evaluate_ranking(service.user_emb, service.item_emb, data, graph, Ns=(20,)).metrics
    plain_metrics = evaluate_ranking(plain_u, plain_i, data, graph, Ns=(20,)).metrics
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"metrics not finite: {metrics}")
    lat_ms = sorted(x * 1e3 for x in latencies)
    stats = {
        "profile": profile_waves(service),
        "compute_dtype": compute_dtype,
        "requests": len(latencies) + 1,
        "clients": N_CLIENTS,
        "k": K,
        "device_calls": batcher.stats["device_calls"],
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "qps": len(latencies) / wall,
        "service_build_s": build_s,
        "score_tol": tol,
        "recall@20": metrics["Recall@20"],
        "plain_recall@20": plain_metrics["Recall@20"],
        "ndcg@20": metrics["NDCG@20"],
    }
    return launches, stats


def popularity_recall(data, graph, n=20, masked=True):
    """Recall@n of the most-popular ranking (``popularity_baseline_topk``):
    the same top-n list for every user, or, ``masked``, with each user's
    train positives taken out first, as tests/test_lightgcn.py scores it."""
    uids = torch.from_numpy(data.test_user_ids().astype(np.int64)).to(graph.device)
    if not masked:
        top = popularity_baseline_topk(graph, n)
        ids = np.broadcast_to(top, (len(uids), n))
    else:
        order = torch.from_numpy(popularity_baseline_topk(graph, graph.n_items)).to(graph.device)
        score = torch.empty(graph.n_items, device=graph.device)
        score[order] = torch.arange(graph.n_items, 0, -1, dtype=torch.float32,
                                    device=graph.device)
        scores = score.expand(len(uids), -1).masked_fill(graph.user_pos_mask[uids] > 0, -math.inf)
        ids = torch.topk(scores, n, dim=1).indices.cpu().numpy()
    return ranking_metrics(ids, data.test_items_by_user(), [n])[f"Recall@{n}"]


def profile_steps(rec):
    """Where one training step's time goes: torch.profiler over
    PROFILE_STEPS steps of the trainer's loop (``train.loop.run_steps``) on the trained
    recommender. Host wall per step, device time per step, the device's idle
    share and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    users, items, negs, weights, n_batches = epoch_batches(
        epoch_words(torch.Generator().manual_seed(11), rec.graph, BATCH), rec.graph, BATCH)
    n_steps = min(PROFILE_STEPS, n_batches)
    window = (users[:n_steps], items[:n_steps], negs[:n_steps], weights[:n_steps], n_steps)
    run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state,
              (users[:1], items[:1], negs[:1], weights[:1], 1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, window)
        float(loss)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events only; the optimizer's ``Optimizer.step#...`` range is a
    # user annotation that spans its kernels and would count them twice
    kernels_ = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels_)
    if device_us <= 0:
        return {"steps": n_steps, "host_us_per_step": wall_us / n_steps,
                "device_us_per_step": "not measured"}
    top = sorted(kernels_, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "steps": n_steps,
        "host_us_per_step": wall_us / n_steps,
        "device_us_per_step": device_us / n_steps,
        "device_idle_share": 1.0 - device_us / wall_us,
        "top_kernels_us_per_step": {e.key[:100]: e.self_device_time_total / n_steps
                                    for e in top},
    }


def train_phase(compute_dtype, data):
    """The training main path at one compute dtype; returns (launches, stats)."""
    config = default_config(**{
        "embedding.size": EMB, "LightGCN.n_layers": LAYERS, "batch.size": BATCH,
        "learning.rate": LR, "optimizer": "adam", "max.epoch": TRAIN_EPOCHS,
        "eval.interval": 1, "item.ranking.topN": [20], "graph.compute_dtype": compute_dtype,
    })
    chain_mean.launches, chain_mean_bwd.launches = 0, 0
    t0 = time.perf_counter()
    rec = GraphRecommender(build("lightgcn", config), data, config, log=Log(echo=False),
                           device="cuda")
    metrics = rec.execute()
    service = RecommenderService.from_recommender(rec)
    uids = list(range(0, data.user_num, 97))
    s_got, i_got = service.recommend_ids(uids, K)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"chain_mean": chain_mean.launches, "chain_mean_bwd": chain_mean_bwd.launches}

    graph = rec.graph
    n_batches = -(-graph.n_edges // BATCH)
    n_evals = len(rec.history) + 2  # the per-epoch evaluations, the final test, the service
    want = {"chain_mean": LAYERS * (n_batches * TRAIN_EPOCHS + n_evals),
            "chain_mean_bwd": LAYERS * n_batches * TRAIN_EPOCHS}
    if launches != want:
        raise RuntimeError(f"{compute_dtype} train launches {launches}, expected {want}")
    losses = [e["loss"] for e in rec.epoch_stats]
    if len(losses) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{compute_dtype} epoch losses malformed: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{compute_dtype} loss did not fall: {losses}")
    # the model must beat the popularity list outright, and come within the
    # JAX package's own 0.005 of the masked one (tests/test_lightgcn.py): on
    # this popularity-shaped synthetic set the masked list is near-optimal
    pop_top = popularity_recall(data, graph, 20, masked=False)
    pop = popularity_recall(data, graph, 20)
    if not (metrics["Recall@20"] > pop_top and metrics["Recall@20"] >= pop - 0.005):
        raise RuntimeError(f"{compute_dtype} Recall@20 {metrics['Recall@20']} against "
                           f"popularity {pop_top} (masked {pop})")
    if service.user_emb.requires_grad or service.item_emb.grad_fn is not None:
        raise RuntimeError("the served tables carry an autograd graph")
    # the served answers against the plain chain's, on the card
    plain_u, plain_i = chain_mean_plain(graph.propagation_matrix, rec.params["user_emb"].detach(),
                                        rec.params["item_emb"].detach(), LAYERS)
    s_plain, i_plain = RecommenderService(plain_u, plain_i, data, graph).recommend_ids(uids, K)
    tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
    if not (np.isfinite(s_got).all() and s_got.shape == (len(uids), K)
            and topk_agree(s_got, i_got, s_plain, i_plain, tol)):
        raise RuntimeError(f"{compute_dtype} served answers after training differ from plain")
    mat = data.interaction_mat
    if any(mat[u, int(i)] != 0 for u, row in zip(uids, i_got) for i in row):
        raise RuntimeError("a train positive was recommended")
    timed = rec.epoch_stats[1:]  # epoch 0 carries the first calls' set-up
    stats = {
        "compute_dtype": compute_dtype,
        "shape": {"users": graph.n_users, "items": graph.n_items, "edges": graph.n_edges,
                  "d": EMB, "layers": LAYERS, "batch": BATCH, "steps_per_epoch": n_batches},
        "epochs": TRAIN_EPOCHS,
        "epoch_losses": losses,
        "epoch_seconds": [e["seconds"] for e in rec.epoch_stats],
        "examples_per_s": n_batches * BATCH * len(timed) / sum(e["seconds"] for e in timed),
        "examples_per_s_by_epoch": [e["examples_per_s"] for e in rec.epoch_stats],
        "recall@20": metrics["Recall@20"],
        "ndcg@20": metrics["NDCG@20"],
        "popularity_recall@20": pop_top,
        "masked_popularity_recall@20": pop,
        "launches": launches,
        "served_users": len(uids),
        "wall_s": wall_s,
        "profile": profile_steps(rec),
    }
    return launches, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {list(kernels.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():  # per entry function: name, spills, registers
            if any(key in line for key in ("entry function", "spill", "registers")):
                print(f"  {name}: {line.strip()}")

    train, test = make_synthetic_dataset(**SERVE_SHAPE)
    data = Interaction(train, test)
    graphs = {
        torch.bfloat16: DeviceGraph(data, compute_dtype="bfloat16", device="cuda"),
        torch.float32: DeviceGraph(data, compute_dtype="float32", device="cuda"),
    }
    model = build("lightgcn", default_config(**{"embedding.size": EMB, "LightGCN.n_layers": LAYERS}))
    params, _ = model.init(torch.Generator().manual_seed(0), graphs[torch.float32])
    print(f"graph U={data.user_num} I={data.item_num} edges={len(data.edge_users)} d={EMB} L={LAYERS}")

    rows = kernel_phase(graphs, params)
    bwd_rows = kernel_phase_bwd(graphs, params)
    layer_rows, layer_bwd_rows = kernel_phase_layer(graphs, params)
    lse_rows = kernel_phase_lse(data.user_num, data.item_num)
    one_step = one_step_check(graphs, params)
    ncl_one_step = ncl_one_step_check(graphs, params)

    serve = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/lightgcn.npz"
        save_params(ckpt, params)
        for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            chain_mean_bwd.launches = 0
            launches, stats = serve_phase(name, ckpt, train, test)
            if launches <= 0:
                raise RuntimeError(f"chain_mean was not launched on the {name} serving path")
            if chain_mean_bwd.launches != 0:
                raise RuntimeError("serving launched the backward kernel")
            rows[dtype]["launches_serve"] = launches
            stats["card"] = card
            serve.append(stats)
            if stats["requests"] < 256:
                raise RuntimeError(f"only {stats['requests']} requests answered")

    training = []
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        launches, stats = train_phase(name, data)
        rows[dtype]["launches"] = launches["chain_mean"]
        rows[dtype]["launches_train"] = launches["chain_mean"]
        bwd_rows[dtype]["launches"] = launches["chain_mean_bwd"]
        bwd_rows[dtype]["launches_train"] = launches["chain_mean_bwd"]
        stats["card"] = card
        training.append(stats)

    ncl = []
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        launches, stats = ncl_train_phase(name, data)
        rows[dtype]["launches_ncl"] = launches["chain_mean"]
        bwd_rows[dtype]["launches_ncl"] = launches["chain_mean_bwd"]
        layer_rows[dtype]["launches"] = launches["chain_mean_layer"]
        layer_bwd_rows[dtype]["launches"] = launches["chain_mean_layer_bwd"]
        for row in lse_rows:  # f32 kernels, launched in both regimes
            row["launches"] += launches[row["name"]]
            row[f"launches_ncl_{name}"] = launches[row["name"]]
        stats["card"] = card
        ncl.append(stats)

    print(json.dumps({"serve": serve}))
    print(json.dumps({"one_step": one_step, "train": training}))
    print(json.dumps({"ncl": {"one_step": ncl_one_step, "train": ncl}}))
    print(json.dumps({"kernels": list(rows.values()) + list(bwd_rows.values())
                      + list(layer_rows.values()) + list(layer_bwd_rows.values()) + lse_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
