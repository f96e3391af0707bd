#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and check them.

    python3 chip_smoke.py

What it does, in order (any failed phase exits non-zero):
  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the paths from ``recommendation_tpu_torch/csrc``,
     one ``nvcc`` per source, all at once;
  3. kernel phase: holds each kernel against its plain PyTorch version on
     the card, and each against itself (two calls equal bit for bit), and
     times the kernel, the plain version and the nearest library calls
     (device time: a spin kernel ahead of each timed run hides the host's
     launch calls): K1 ``chain_mean`` and K2 ``chain_mean_bwd`` at the
     serving shape and at an unaligned one; K3 ``chain_mean_layer`` and K4
     ``chain_mean_layer_bwd`` at the bench shape and at 37x53x8 for (L, k)
     in (3,1), (3,2), (3,3), (1,1); K5 ``catalog_lse`` and K6
     ``catalog_lse_bwd`` at NCL's two step shapes and a ragged one, K5
     against a 100,000-item catalog, and K6 at B = 8192 against it (its
     workspace, read from the caching allocator around one call, held under
     256 MB; timed against its bound and the library call);
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
     K3 and K4 launch 3 times a step (one launch a layer), K5 and K6 four
     times each (two calls, each two launches: K5's splits and their merge,
     K6's tiles and their combine: ``launches_per_call``), K1 3 times per
     E-step and per
     evaluation, K2 never;
     after each E-step every assignment lies in [0, k) and the k-means
     inertia is no higher than at the initial centroids;
  8. large-graph phase, LightGCN on the bucketed backend at ``bench.py
     --large``'s shape (``make_flat_interactions(50_000, 100_000, 1_000_000,
     seed=3)``, 10% held out, d=64, L=3, B=8192, Adam 1e-3, f32): the host
     build of ``DeviceGraph`` (seconds, buckets, padded slots, table bytes);
     K7 ``gather_rows`` against ``x[idx]`` bit for bit at the chain's
     shapes and at the TPU probe's (1.5M rows x d=128, 4096 and 2M rows
     gathered, rows carrying their ids); every P1 ``gather_sum`` variant
     against its plain version at the bench graph (the bf16 source at
     d=128, and the epilogue's running sum and last scaling), each twice to
     show it repeats bit for bit; both timed against their bytes at 3.35
     TB/s, their plain versions and a library call (``torch.index_select``,
     one layer of ``torch.sparse.mm``), P1 also with its indices taken
     modulo 4096 (a source that stays in L2) and with every slot left out
     (no gathers); one step's gradients through
     ``BucketedChainMean`` against the plain chain's; 3 epochs of training
     with K7 4 and P1 6 launches a step and K7 2, P1 3 per evaluation, a
     falling loss, a 20-step profile and a 5-step one by operator and input
     shape; waves of requests through ``RecommenderService``, each answer
     equal to the plain path's and no train positive served;
  9. clustered phase, the sets a quality gate can fail:
     ``make_clustered_interactions(50_000, 100_000, 1_000_000, seed=3)``
     (bench.py --large's shape with genre structure), 10% held out, on the
     bucketed backend (f32, d=64, B=8192), one graph for: one NCL step
     through K5, K6, K7 and P1 against the plain path (the full loss, the
     layer contrast and ProtoNCE alone), one DirectAU step through K7 and
     P1's value path against the plain chain, then LightGCN-BPR, NCL and
     DirectAU at their defaults trained CLUSTERED_EPOCHS epochs each, every
     run's launches counted and its Recall@20 held above the masked
     popularity list's, with the untrained tables below it;
     Then the bucketed zoo on the same graph: one step of SelfCF (K7, P1
     on the separable fold), BUIR and BGRL (K7, P1's value path) against
     the plain bucketed path, each followed by PROFILE_STEPS profiled
     steps (examples/s, host and device time a step, idle share, launches,
     top kernels; no quality gate: the JAX package has no record there);
 10. hard phase: DirectAU on the dense backend on ``make_hard_dataset()``
     in bf16 and f32: one step against the plain bucketed chain (no kernel
     of the port on this path: its products are ``torch.matmul``), then
     HARD_EPOCHS epochs held to the dense sets' gate (above the popularity
     list, within 0.005 of it masked), the untrained tables below it;
 11. the dense-path zoo on the hard set's graphs (d=64, B=2048): SelfCF's
     step through K1/K2 against the plain chain in bf16 and f32; the
     steps of BUIR, SSL4Rec, GCL, GRACE, G-BT and BGRL on the card against
     the port's on the CPU on the same masks (``host_draws``); the dense
     re-normalized bipartite adjacency built twice (bit for bit) and
     against the CPU's; GCL's step
     on the bucketed graph against its plain bucketed path and its loss
     against the dense backend's, and its profiled steps there; then each
     of the seven trained at its defaults (f32) for ZOO_EPOCHS epochs and
     held to its ZOO_GATES gate, launches counted, the served answers
     (width 2d for SelfCF and BUIR) against the plain path's;
 12. the neighbour models and the segment backend: the segment kernels S1
     ``weighted_pull``, S2 ``segment_softmax_rows`` and its backward and
     S3 ``segment_dot`` against their plain versions, twice bit for bit,
     timed beside their bounds and, where one PyTorch call computes the
     same function, ``torch.sparse.mm``, ``torch.sparse.softmax`` and its
     backward (H = 1) and ``torch.sparse.sampled_addmm`` (S3 where the
     rows are the nodes): at the clustered graph's bucket tables and the
     hard set's bidirectional edges, H = 4 and 1, d = 64. On the clustered
     graph: GAT (bucketed attention) and GraphSAGE one step against their
     plain paths (``PlainGAT``: the plain S1 and S2 under autograd, in
     float64), then PROFILE_STEPS
     profiled steps each; a segment graph of the same data, P1 over its
     row-sorted view timed beside ``torch.sparse.mm``, one LightGCN step
     against the plain segment matmul and PROFILE_STEPS profiled steps. On
     the hard set: GraphSAGE and GAT (dense backend, whose sums run the
     segment kernels) one step against their plain paths, then
     NEIGHBOR_EPOCHS epochs held to NEIGHBOR_GATES; LightGCN on the segment
     backend one step against the plain path, then TRAIN_EPOCHS epochs on
     the same batches as the dense backend's run, Recall@20 within
     BACKEND_RECALL_GAP of it; GRACE and G-BT on the bucketed graph (their
     self-loop adjacency on the segment backend) one step against the plain
     path, then PROFILE_STEPS profiled steps;
 13. prints the serving line, the training line, the NCL line, the large
     line, the clustered line, the hard line, the hard_zoo line, the
     bucketed_zoo line, the neighbors line, the kernels line (every kernel
     must have launched on a main path) and, last, the device line.

Launch counts are reset just before each main path and read just after it.
Exits non-zero without printing a result where no CUDA device is present.
"""

from __future__ import annotations

import contextlib
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
from recommendation_tpu_torch.data.synthetic import (
    ArrayInteraction,
    make_clustered_interactions,
    make_flat_interactions,
    make_hard_dataset,
    make_synthetic_dataset,
)
from recommendation_tpu_torch.evalx.metrics import ranking_metrics
from recommendation_tpu_torch.evalx.ranking import evaluate_ranking
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.bucketed import (
    PLAIN,
    bucketed_chain_mean,
    bucketed_chain_mean_plain,
    pull,
)
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.bgrl import PlainBucketedBGRL
from recommendation_tpu_torch.models.buir import PlainBucketedBUIR
from recommendation_tpu_torch.models.directau import PlainBucketedDirectAU
from recommendation_tpu_torch.models.gat import PlainGAT
from recommendation_tpu_torch.models.graphsage import PlainGraphSAGE, bidirectional_edges
from recommendation_tpu_torch.models.gcl import PlainBucketedGCL
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.models.selfcf import PlainSelfCF
from recommendation_tpu_torch.ops import build as kernels
from recommendation_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_sum,
    gather_sum_plain,
)
from recommendation_tpu_torch.ops import lse as lse_ops
from recommendation_tpu_torch.ops import spmm
from recommendation_tpu_torch.ops.lse import (
    catalog_lse,
    catalog_lse_bwd,
    catalog_lse_bwd_plain,
    catalog_lse_plain,
    lse_bwd_workspace,
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
from recommendation_tpu_torch.ops.segment import (
    segment_dot,
    segment_dot_plain,
    segment_softmax_rows,
    segment_softmax_rows_bwd,
    segment_softmax_rows_bwd_plain,
    segment_softmax_rows_plain,
    slot_rows,
    weighted_pull,
    weighted_pull_plain,
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
# time_ms's spin ahead of each timed run: about 3 ms at the H100's 1.98 GHz
# boost clock, longer than the host takes to queue any function timed here
SPIN_CYCLES = 6_000_000
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
LSE_LARGE_N = 100_000  # the large graph's item catalog, which NCL there would take
COUNTERS = (chain_mean, chain_mean_bwd, chain_mean_layer, chain_mean_layer_bwd, catalog_lse,
            catalog_lse_bwd)
# the large-graph phase: bench.py --large's shape (bench.py:245-271), 10% held out
LARGE_SHAPE = dict(n_users=50_000, n_items=100_000, n_interactions=1_000_000, seed=3)
LARGE_BATCH, LARGE_EPOCHS = 8192, 3
# the TPU probe's gather (tools/probe_gather_ceiling.py:130-191): 1.5M rows x d=128
PROBE_ROWS, PROBE_D, PROBE_IDX = 1_500_000, 128, (4096, 2_000_000)
# P1 against its plain version: the two sum a row's slots in another order,
# which moves a result by a few ulps of the row's largest partial sum (hub
# rows hold 10^4 slots here): rtol 1e-5, atol 1e-5 x the table's largest entry
P1_TOL = (1e-5, 1e-5)
L2_PROBE_ROWS = 4096  # P1's L2 probe: live indices modulo this, a 1 MB source
# K6's workspace at B = 8192 against 100,000 items must stay under this
LSE_WORKSPACE_LIMIT = 256 * 2**20
# the sets a quality gate can fail: bench.py --large's shape with genre
# structure (make_clustered_interactions), and the hard ML-100K-shaped set
CLUSTERED_SHAPE = dict(n_users=50_000, n_items=100_000, n_interactions=1_000_000, seed=3)
GATE_MODELS = ("lightgcn", "ncl", "directau")
# epochs of each run, from a measured run on the H100 (PERF.md §4): enough
# to clear the masked popularity list by a third or more on the clustered
# set (LightGCN sits at it for 8 epochs, NCL below it for 4)
CLUSTERED_EPOCHS = {"lightgcn": 14, "ncl": 7, "directau": 3}
HARD_EPOCHS = 3
# the dense sets' gate (the train phases'): above the popularity list and
# within this much of it with train positives masked
MASKED_SLACK = 0.005
# the dense-path zoo on the hard set, f32, each at its defaults, and its
# gate (``check_gate``): "dense" for SelfCF and BUIR (the JAX package
# records 0.4162 and 0.4161 at 30 epochs, BASELINE.md round 2);
# "dense_kept" for GRACE, whose untrained tables already meet the dense
# bars (an untrained GCN over identity features ranks by degree), so the
# run must keep them; "untrained" for SSL4Rec (Recall@20 above the
# untrained tables'); "loss" for G-BT and BGRL, whose untrained tables rank
# above their trained ones in both packages, and for GCL (raw encodings
# rank near random by design). The readings behind each choice:
# tools/zoo_gate_calibration.py, PERF.md §4
ZOO_MODELS = ("selfcf", "buir", "ssl4rec", "gcl", "grace", "gbt", "bgrl")
ZOO_GATES = {"selfcf": "dense", "buir": "dense", "grace": "dense_kept", "ssl4rec": "untrained",
             "gbt": "loss", "bgrl": "loss", "gcl": "loss"}
# epochs of each run, cut from the JAX package's 30 to the fewest that clear
# the gate with a margin in the port's CPU runs of the same set
# (tools/zoo_gate_calibration.py; PERF.md §4)
ZOO_EPOCHS = {"selfcf": 3, "buir": 4, "ssl4rec": 4, "gcl": 3, "grace": 3, "gbt": 3, "bgrl": 3}
# a zoo step on the card against the same step of the port on the CPU
# (same parameters, batch and masks), each gradient by its relative
# Frobenius error: the two sum the products in another order. G-BT's and
# BGRL's gradients are ill-conditioned in f32 (batch norms over the whole
# graph; pre-activations within an f32 rounding of a ReLU's kink, whose
# unit the order of a sum can switch): tests/test_torch_grace_gbt.py and
# test_torch_bgrl.py bound them by the JAX package's own f32 error against
# float64
ZOO_CPU_TOL = {"gbt": 1e-2, "bgrl": 1e-2}
ZOO_CPU_TOL_DEFAULT = 1e-4
# parameters whose exact gradient is 0 (a batch norm or a standardization
# takes their constant shift out): both sides must hold only f32 noise,
# under this share of the step's largest gradient entry
ZERO_GRADS = {"gbt": ("conv1.b", "conv2.b"), "bgrl": ("online.proj.b",)}
ZERO_GRAD_SHARE = 1e-3
# the bucketed zoo: SelfCF, BUIR and BGRL on the clustered graph, GCL on the
# hard set with the backend forced to bucketed
BUCKETED_ZOO = ("selfcf", "buir", "bgrl")
# the neighbour models on the hard set (dense backend: their sums run the
# segment kernels) and their gate: "popularity", Recall@20 above the
# popularity list's with the untrained tables below it (the JAX package's
# 30-epoch records, GAT 0.4071 and GraphSAGE 0.4033 in BASELINE.md round 2,
# stay under the masked list's 0.41561); epochs from
# tools/zoo_gate_calibration.py's CPU runs (PERF.md §4)
NEIGHBOR_MODELS = ("graphsage", "gat")
NEIGHBOR_GATES = {"graphsage": "popularity", "gat": "popularity"}
NEIGHBOR_EPOCHS = {"graphsage": 3, "gat": 3}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` with a cold L2 (a 64 MB write between
    runs): the chain runs once per model load, so R̂ is not cached. A spin
    kernel of about 3 ms runs before each start event, so the host has
    queued all of ``fn``'s launches before the device reaches them: the
    events time the device, not the host's Python and launch calls."""
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def lse_bwd_workspace_bytes(q, x, lse, g):
    """The card memory one ``catalog_lse_bwd`` call takes besides its
    outputs, read from the caching allocator: the peak of allocated bytes
    during the call less the bytes allocated after it, when dq and dx are
    still held and the partials freed. The allocator rounds a block up (to
    512 B, and a large one to the rest of its segment when that is under
    1 MB), so this can pass the partials' floats x 4 by that much."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dq, dx = catalog_lse_bwd(q, x, TAU, lse, g)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del dq, dx
    return torch.cuda.max_memory_allocated() - held


def check_lse_workspace(q, x, lse, g):
    """K6's measured workspace (``lse_bwd_workspace_bytes``): at least the
    partials its plan needs (``lse_bwd_workspace`` floats), and at most
    ``LSE_WORKSPACE_LIMIT``."""
    (b, d), n = q.shape, x.shape[0]
    plan_bytes = lse_bwd_workspace(b, n, d, lse_ops._slots(lse_ops._kernel_lib(), "bwd",
                                                           q.device, d)) * 4
    got = lse_bwd_workspace_bytes(q, x, lse, g)
    if not plan_bytes <= got <= LSE_WORKSPACE_LIMIT:
        raise RuntimeError(f"K6 at {b}x{n}x{d} took {got} bytes of workspace: its plan needs "
                           f"{plan_bytes}, the limit is {LSE_WORKSPACE_LIMIT}")
    return got


def same_bits(name, fn):
    """Run ``fn`` twice; every output of the second call must equal the
    first's bit for bit (the kernels add in a fixed order, no atomics).
    Returns the first call's outputs."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{name}: two calls differ")
    return got


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
                      same_bits("chain_mean", lambda: chain_mean(r, u0, i0, LAYERS)),
                      chain_mean_plain(r, u0, i0, LAYERS), dtype)
        # unaligned shape, O(1) values, as the JAX kernel's test
        for n_layers in (1, 3):
            ru = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32) * 0.1)
            ru = ru.to("cuda", dtype)
            uu = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).cuda()
            iu = torch.from_numpy(rng.normal(size=(53, 8)).astype(np.float32)).cuda()
            compare(f"chain_mean {dtype} 37x53x8 L={n_layers}",
                    same_bits("chain_mean 37x53x8", lambda: chain_mean(ru, uu, iu, n_layers)),
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
        err = compare(f"chain_mean_bwd {dtype} serve shape",
                      same_bits("chain_mean_bwd", lambda: chain_mean_bwd(r, gu, gi, LAYERS)),
                      chain_mean_bwd_plain(r, gu, gi, LAYERS), dtype, GRAD_TOL)
        for n_layers in (1, 3):
            ru = torch.from_numpy(rng.normal(size=(37, 53)).astype(np.float32) * 0.1)
            ru = ru.to("cuda", dtype)
            gu_s = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32)).cuda()
            gi_s = torch.from_numpy(rng.normal(size=(53, 8)).astype(np.float32)).cuda()
            compare(f"chain_mean_bwd {dtype} 37x53x8 L={n_layers}",
                    same_bits("chain_mean_bwd 37x53x8",
                              lambda: chain_mean_bwd(ru, gu_s, gi_s, n_layers)),
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
                        same_bits("chain_mean_layer",
                                  lambda: chain_mean_layer(r, u0, i0, n_layers, k)),
                        chain_mean_layer_plain(r, u0, i0, n_layers, k), dtype)
            e_b = compare(f"chain_mean_layer_bwd {dtype} bench shape L={n_layers} k={k}",
                          same_bits("chain_mean_layer_bwd", lambda: chain_mean_layer_bwd(
                              r, gu, gi, gku, gki, n_layers, k)),
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
                    same_bits("chain_mean_layer 37x53x8",
                              lambda: chain_mean_layer(ru, uu, iu, n_layers, k)),
                    chain_mean_layer_plain(ru, uu, iu, n_layers, k), dtype)
            compare(f"chain_mean_layer_bwd {dtype} 37x53x8 L={n_layers} k={k}",
                    same_bits("chain_mean_layer_bwd 37x53x8", lambda: chain_mean_layer_bwd(
                        ru, gus, gis, gkus, gkis, n_layers, k)),
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
    ragged one, and K5 against a 100,000-item catalog (the large graph's).
    Timed as one step uses them: a call on each catalog."""
    rng = np.random.default_rng(3)
    step_shapes = [(BATCH, n_users, EMB), (BATCH, n_items, EMB)]
    inputs = []
    err = err_b = 0.0
    for b, n, d in step_shapes + [(37, 700, 24)]:
        q, x = unit_rows(rng, b, d), unit_rows(rng, n, d)
        g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).cuda()
        (lse,) = same_bits("catalog_lse", lambda: [catalog_lse(q, x, TAU)])
        want = catalog_lse_plain(q, x, TAU)
        err = max(err, compare(f"catalog_lse {b}x{n}x{d}", [lse], [want], torch.float32,
                               {torch.float32: LSE_TOL}))
        err_b = max(err_b, compare(f"catalog_lse_bwd {b}x{n}x{d}",
                                   same_bits("catalog_lse_bwd",
                                             lambda: catalog_lse_bwd(q, x, TAU, lse, g)),
                                   catalog_lse_bwd_plain(q, x, TAU, want, g), torch.float32,
                                   {torch.float32: LSE_GRAD_TOL}))
        if (b, n, d) in step_shapes:
            inputs.append((q, x, g, want))
    # K5 at the large graph's item catalog
    q, x = unit_rows(rng, BATCH, EMB), unit_rows(rng, LSE_LARGE_N, EMB)
    (lse,) = same_bits("catalog_lse 100k", lambda: [catalog_lse(q, x, TAU)])
    err_large = compare(f"catalog_lse {BATCH}x{LSE_LARGE_N}x{EMB}", [lse],
                        [catalog_lse_plain(q, x, TAU)], torch.float32, {torch.float32: LSE_TOL})
    large = {"shape": [BATCH, LSE_LARGE_N, EMB], "max_abs_err": err_large,
             "ms": time_ms(lambda: catalog_lse(q, x, TAU)),
             "plain_ms": time_ms(lambda: catalog_lse_plain(q, x, TAU)),
             "library_ms": time_ms(lambda: torch.logsumexp(q @ x.T / TAU, 1)),
             "bound_ms": lse_bound([(BATCH, LSE_LARGE_N, EMB)], 1)[0]}
    # K6 at NCL's large step (B = 8192 against the 100,000-item catalog):
    # its workspace, against plain, twice bit for bit, timed
    q, x = unit_rows(rng, LARGE_BATCH, EMB), unit_rows(rng, LSE_LARGE_N, EMB)
    g = torch.from_numpy(rng.normal(size=LARGE_BATCH).astype(np.float32)).cuda()
    lse = catalog_lse_plain(q, x, TAU)
    err_bwd_large = compare(f"catalog_lse_bwd {LARGE_BATCH}x{LSE_LARGE_N}x{EMB}",
                            same_bits("catalog_lse_bwd 100k",
                                      lambda: catalog_lse_bwd(q, x, TAU, lse, g)),
                            catalog_lse_bwd_plain(q, x, TAU, lse, g), torch.float32,
                            {torch.float32: LSE_GRAD_TOL})
    slots = lse_ops._slots(lse_ops._kernel_lib(), "bwd", q.device, EMB)
    large_bwd = {
        "shape": [LARGE_BATCH, LSE_LARGE_N, EMB], "max_abs_err": err_bwd_large,
        "same_bits": True,
        "plan_wq_sq_wx_sx": lse_ops.lse_bwd_plan(LARGE_BATCH, LSE_LARGE_N, slots),
        "workspace_bytes": check_lse_workspace(q, x, lse, g),
        "ms": time_ms(lambda: catalog_lse_bwd(q, x, TAU, lse, g), reps=10),
        "plain_ms": time_ms(lambda: catalog_lse_bwd_plain(q, x, TAU, lse, g), reps=5),
        "library_ms": time_ms(lambda: library_lse_bwd(q, x, TAU, g), reps=5),
        "bound_ms": lse_bound([(LARGE_BATCH, LSE_LARGE_N, EMB)], 3)[0]}
    print(f"K6 at {LARGE_BATCH}x{LSE_LARGE_N}x{EMB}: {json.dumps(large_bwd)}")
    del q, x, lse
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

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
            "launches_per_call": (catalog_lse if products == 1
                                  else catalog_lse_bwd).launches_per_call,
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
    rows[0]["n100k"] = large
    rows[1]["n100k"] = large_bwd
    rows[1]["workspace_bytes"] = [check_lse_workspace(q, x, lse, g) for q, x, g, lse in inputs]
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
            k5 = 2 * catalog_lse.launches_per_call  # two calls a step
            k6 = 2 * catalog_lse_bwd.launches_per_call
            want_k = {"loss": (3, 3, k5, k6), "ssl": (3, 3, k5, k6), "proto": (0, 0, 0, 0)}[term]
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
            "catalog_lse": 2 * catalog_lse.launches_per_call * steps,
            "catalog_lse_bwd": 2 * catalog_lse_bwd.launches_per_call * steps}
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
    the same top-n list for every user, or, ``masked``, each test user's
    first n items of that order that are not train positives, as
    tests/test_lightgcn.py scores it (the order's first n + max_degree
    items always hold n of them)."""
    uids = data.test_user_ids()
    if not masked:
        ids = np.broadcast_to(popularity_baseline_topk(graph, n), (len(uids), n))
    else:
        order = popularity_baseline_topk(graph, min(graph.n_items, n + graph.max_degree))
        keep = data.interaction_mat[uids][:, order].toarray() == 0
        first = keep & (np.cumsum(keep, axis=1) <= n)
        ids = order[np.nonzero(first)[1]].reshape(len(uids), n)
    return ranking_metrics(ids, data.test_items_by_user(), [n])[f"Recall@{n}"]


def profile_steps(rec, batch=BATCH):
    """Where one training step's time goes: torch.profiler over
    PROFILE_STEPS steps of the trainer's loop (``train.loop.run_steps``) on the trained
    recommender. Host wall per step, device time per step, the device's idle
    share and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    users, items, negs, weights, n_batches = epoch_batches(
        epoch_words(torch.Generator().manual_seed(11), rec.graph, batch), rec.graph, batch)
    n_steps = min(PROFILE_STEPS, n_batches)
    window = (users[:n_steps], items[:n_steps], negs[:n_steps], weights[:n_steps], n_steps)
    draws = torch.Generator().manual_seed(12)  # the augmenting models' masks
    run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state,
              (users[:1], items[:1], negs[:1], weights[:1], 1), draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, window,
                            draws)
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
    host_ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    host = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:8]
    return {
        "steps": n_steps,
        "host_us_per_step": wall_us / n_steps,
        "device_us_per_step": device_us / n_steps,
        "device_idle_share": 1.0 - device_us / wall_us,
        "launches_per_step": sum(e.count for e in host_ops
                                 if e.key.startswith("cudaLaunchKernel")) / n_steps,
        "memsets_per_step": sum(e.count for e in host_ops if e.key == "cudaMemsetAsync") / n_steps,
        "top_kernels_us_per_step": {e.key[:100]: e.self_device_time_total / n_steps
                                    for e in top},
        "top_host_ops_us_per_step": {e.key[:60]: [e.self_cpu_time_total / n_steps,
                                                  e.count / n_steps] for e in host},
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


# -- the large-graph phase: LightGCN on the bucketed backend -----------------------


def table_bytes(adj):
    """Bytes of the bucketed tables of both directions on the card."""
    return sum(t.numel() * t.element_size() for csr in (adj.pull, adj.pull_t)
               for t in (csr.idx, csr.val, csr.edge, csr.ridx, csr.row_ptr, csr.gather_pos,
                         csr.node_of_row, csr.sep_dst, csr.sep_src_row) if t is not None)


def large_build():
    """The data and the DeviceGraph at bench.py --large's shape; the host
    build's seconds and the tables' sizes."""
    t0 = time.perf_counter()
    n_users, n_items = LARGE_SHAPE["n_users"], LARGE_SHAPE["n_items"]
    pairs = make_flat_interactions(**LARGE_SHAPE)
    data = ArrayInteraction(pairs, n_users, n_items, test_fraction=0.1)
    t1 = time.perf_counter()
    graph = DeviceGraph(data, backend="auto", compute_dtype="float32", device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adj = graph.norm_adj
    if graph.backend != "bucketed" or not adj.sym_rowspace or adj.pull.sep_dst is None:
        raise RuntimeError(f"large graph on {graph.backend}, sym_rowspace {adj.sym_rowspace}")
    info = {
        "users": n_users, "items": n_items, "train_edges": graph.n_edges,
        "test_pairs": int(len(data.test_pairs)), "nodes": graph.n_nodes,
        "data_s": t1 - t0, "graph_build_s": t2 - t1,
        "buckets": len(adj.pull.caps), "caps": list(adj.pull.caps),
        "rows_R": adj.pull.total_rows, "nnz_padded": int(adj.vals.shape[0]),
        "slots": [adj.pull.n_slots, adj.pull_t.n_slots],
        "live_slots": int((adj.pull.ridx != adj.pull.total_rows).sum()),
        "table_bytes": table_bytes(adj),
        "has_pos_table": graph.has_pos_table, "has_pos_bitmap": graph.has_pos_bitmap,
        "has_pos_mask": graph.has_pos_mask, "max_degree": graph.max_degree,
    }
    print(f"large graph: {json.dumps(info)}")
    return data, graph, info


def bytes_bound(nbytes):
    """(bound_ms, "bytes"): a gather does no arithmetic worth a bound."""
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def gather_bound(idx, d, itemsize):
    """K7: the indices, each distinct row they pick read once, every
    gathered row written once."""
    n = idx.numel()
    rows = torch.unique(idx).numel()
    return bytes_bound(n * 4 + (rows + n) * d * itemsize)


def pull_bound(csr, d, itemsize, val=False, post=True):
    """P1: the slot indices (and values) and row pointers, each distinct
    source row the live slots pick read once, the row scales, the
    [R + 1, d] f32 output written once."""
    live = csr.ridx[csr.ridx != csr.total_rows]
    n_out = csr.total_rows + 1
    nbytes = (csr.n_slots * 4 * (1 + val) + csr.row_ptr.numel() * 8
              + torch.unique(live).numel() * d * itemsize + n_out * 4 * post + n_out * d * 4)
    return bytes_bound(nbytes)


def per_slot_ms(csr, d, itemsize):
    """The separable pull's bytes counted per slot, as bench.py:163-175 does
    (a source row per live slot, an index per slot, the output), at 3.35
    TB/s: what the pull would move without the L2 cache's reuse of rows."""
    live = int((csr.ridx != csr.total_rows).sum())
    n_out = csr.total_rows + 1
    return (csr.n_slots * 4 + live * d * itemsize + n_out * d * 4) / PEAK_BYTES_PER_S * 1e3


def check_gather(name, x, idx):
    """K7 against x[idx] bit for bit, and a second call against the first."""
    got = gather_rows(x, idx)
    again = gather_rows(x, idx)
    torch.cuda.synchronize()
    if not (torch.equal(got, gather_rows_plain(x, idx)) and torch.equal(got, again)):
        raise RuntimeError(f"gather_rows {name}: differs from x[idx]")
    return got


def check_pull(name, src, idx, row_ptr, **kw):
    """One P1 variant against its plain version at P1_TOL, and twice
    bit for bit (each output, where the epilogue gives two)."""
    got = gather_sum(src, idx, row_ptr, **kw)
    again = gather_sum(src, idx, row_ptr, **kw)
    want = gather_sum_plain(src, idx, row_ptr, **kw)
    torch.cuda.synchronize()
    got, again, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, again, want))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"gather_sum {name}: two calls differ")
    rtol, atol = P1_TOL
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not (scale > 0 and len(got) == len(want) and all(torch.isfinite(g).all() for g in got)
            and all(torch.allclose(g, w, rtol=rtol, atol=atol * scale)
                    for g, w in zip(got, want))):
        raise RuntimeError(f"gather_sum {name}: kernel disagrees with plain (max abs err {err})")
    return {"max_abs_err": err, "max_abs": scale}


def large_kernel_phase(data, graph, params):
    """K7 and P1 against their plain versions on the chain's inputs at the
    bench graph and at the TPU probe's shape; timed."""
    adj = graph.norm_adj
    fwd = adj.pull
    r = fwd.total_rows
    ego = torch.cat([params["user_emb"], params["item_emb"]]).contiguous()
    rows = fwd.node_of_row[:r]
    # K7 at the chain's two shapes: node -> row and row -> node
    xp = torch.cat([check_gather("node->row", ego, rows), ego.new_zeros((1, EMB))])
    check_gather("row->node", xp, fwd.gather_pos)
    check_gather("node->row bf16", ego.bfloat16(), rows)
    # K7 at the probe's shape, rows carrying their ids
    x_probe = torch.arange(PROBE_ROWS, dtype=torch.float32, device="cuda")[:, None].repeat(
        1, PROBE_D)
    rng = np.random.default_rng(2)
    probe_idx = {}
    for n in PROBE_IDX:
        idx = torch.from_numpy(rng.integers(0, PROBE_ROWS, n).astype(np.int32)).cuda()
        got = check_gather(f"probe {n}", x_probe, idx)
        if not torch.equal(got[:, 0], idx.float()):
            raise RuntimeError("gather_rows misrouted a probe row")
        probe_idx[n] = idx
    # P1: every variant on the chain's inputs
    ab = fwd.sep_dst * fwd.sep_src_row
    y = xp * fwd.sep_src_row[:, None]
    g_rng = np.random.default_rng(3)
    gp = torch.from_numpy(g_rng.normal(size=(r + 1, EMB)).astype(np.float32) * 1e-3).cuda()
    gp[r] = 0.0
    z = torch.from_numpy(g_rng.normal(size=(r + 1, EMB)).astype(np.float32) * 1e-3).cuda()
    z[r] = 0.0
    x128 = torch.from_numpy(g_rng.normal(size=(r + 1, 128)).astype(np.float32) * 0.05).cuda()
    x128[r] = 0.0
    ridx, ptr, sched = fwd.ridx, fwd.row_ptr, fwd.schedule
    _, inv_b = fwd.fold_scales
    acc = z.abs()  # a running sum: the chain's layers so far
    variants = {
        "separable (chain forward)": check_pull("separable", y, ridx, ptr, post=ab, skip=r,
                                                schedule=sched),
        "separable + add": check_pull("add", z, ridx, ptr, post=ab, add=gp, skip=r,
                                      schedule=sched),
        "value path": check_pull("value", xp, ridx, ptr, val=fwd.val, skip=r, schedule=sched),
        "value path + add": check_pull("value add", z, ridx, ptr, val=fwd.val, add=gp, skip=r,
                                       schedule=sched),
        "node space (pull)": check_pull("node", ego, fwd.idx, ptr, val=fwd.val, schedule=sched),
        "bf16 source d=128": check_pull("bf16", x128.bfloat16(), ridx, ptr, post=fwd.sep_dst,
                                        skip=r, schedule=sched),
        "bf16 source d=128, value path": check_pull("bf16 value", x128.bfloat16(), ridx, ptr,
                                                    val=fwd.val, skip=r, schedule=sched),
        "separable + running sum (chain forward, middle layer)": check_pull(
            "running sum", y, ridx, ptr, post=ab, skip=r, schedule=sched, acc=acc, keep_y=True),
        "separable + running sum, 1/b (chain forward, last layer)": check_pull(
            "last layer", y, ridx, ptr, post=ab, skip=r, schedule=sched, acc=acc, final=inv_b),
        "separable, next source gp_b + z (Horner backward)": check_pull(
            "horner", z, ridx, ptr, post=ab, skip=r, schedule=sched, acc=gp),
        "separable, 1/b (Horner backward, last layer)": check_pull(
            "horner last layer", z, ridx, ptr, post=ab, skip=r, schedule=sched, final=inv_b),
    }
    # the library yardsticks: index_select; one layer of CSR SpMM in node space
    a = data.norm_adj.tocsr()
    a_csr = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                    torch.from_numpy(a.indices.astype(np.int64)),
                                    torch.from_numpy(a.data.astype(np.float32)),
                                    size=a.shape).cuda()
    torch.cuda.synchronize()
    k7_bound = gather_bound(rows, EMB, 4)
    k7 = {
        "name": "gather_rows", "route": "cuda",
        "source": "recommendation_tpu_torch/csrc/gather.cu",
        "replaces": "tools/probe_gather_ceiling.py:130",
        "shape": [graph.n_nodes, r, EMB], "timed": "the chain's node->row gather (f32)",
        "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(lambda: gather_rows(ego, rows)),
        "plain_ms": time_ms(lambda: gather_rows_plain(ego, rows)),
        "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
        "library_ms": time_ms(lambda: torch.index_select(ego, 0, rows)),
    }
    for n, idx in probe_idx.items():
        bound = gather_bound(idx, PROBE_D, 4)
        k7[f"probe_{n}"] = {
            "shape": [PROBE_ROWS, n, PROBE_D],
            "ms": time_ms(lambda: gather_rows(x_probe, idx)),
            "plain_ms": time_ms(lambda: gather_rows_plain(x_probe, idx)),
            "library_ms": time_ms(lambda: torch.index_select(x_probe, 0, idx)),
            "bound_ms": bound[0],
        }
    k7["kernel_ms"] = k7["ms"]
    p1_bound = pull_bound(fwd, EMB, 4)
    # the L2 probe: the same call with every live index taken modulo 4096,
    # a 1 MB source that stays in L2: how fast the L2 serves gathered rows;
    # and with every slot left out: what the pull costs without its gathers
    ridx_l2 = torch.where(ridx == r, ridx, ridx % L2_PROBE_ROWS).to(torch.int32).contiguous()
    ridx_none = torch.full_like(ridx, r)
    p1 = {
        "name": "gather_sum", "route": "cuda",
        "source": "recommendation_tpu_torch/csrc/gather.cu",
        "replaces": "recommendation_tpu/graph/bucketed.py:610 (XLA, not a TPU kernel)",
        "shape": [r, fwd.n_slots, EMB], "timed": "one separable layer of the chain (f32)",
        "launches": 0, "variants": variants,
        "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
        "ms": time_ms(lambda: gather_sum(y, ridx, ptr, post=ab, skip=r, schedule=sched)),
        "plain_ms": time_ms(lambda: gather_sum_plain(y, ridx, ptr, post=ab, skip=r)),
        "bound_ms": p1_bound[0], "bound_by": p1_bound[1],
        "per_slot_ms": per_slot_ms(fwd, EMB, 4),
        "l2_probe_ms": time_ms(lambda: gather_sum(y, ridx_l2, ptr, post=ab, skip=r,
                                                  schedule=sched)),
        "no_gather_ms": time_ms(lambda: gather_sum(y, ridx_none, ptr, post=ab, skip=r,
                                                   schedule=sched)),
        "running_sum_ms": time_ms(lambda: gather_sum(y, ridx, ptr, post=ab, skip=r,
                                                     schedule=sched, acc=acc, keep_y=True)),
        "horner_ms": time_ms(lambda: gather_sum(z, ridx, ptr, post=ab, skip=r, schedule=sched,
                                                acc=gp)),
        "last_layer_ms": time_ms(lambda: gather_sum(y, ridx, ptr, post=ab, skip=r,
                                                    schedule=sched, acc=acc, final=inv_b)),
        "library_ms": time_ms(lambda: torch.sparse.mm(a_csr, ego)),
    }
    p1["kernel_ms"] = p1["ms"]
    bf16_bound = pull_bound(fwd, 128, 2)
    xb = x128.bfloat16()
    p1["bf16_d128"] = {
        "ms": time_ms(lambda: gather_sum(xb, ridx, ptr, post=fwd.sep_dst, skip=r,
                                         schedule=sched)),
        "plain_ms": time_ms(lambda: gather_sum_plain(xb, ridx, ptr, post=fwd.sep_dst, skip=r)),
        "bound_ms": bf16_bound[0], "per_slot_ms": per_slot_ms(fwd, 128, 2),
    }
    del x_probe, probe_idx
    torch.cuda.empty_cache()
    return k7, p1


class PlainBucketedLightGCN(LightGCN):
    """LightGCN with the plain bucketed chain (autograd through torch ops)
    in place of BucketedChainMean: the reference a step is held against."""

    def propagate(self, params, graph):
        n_users = params["user_emb"].shape[0]
        ego = torch.cat([params["user_emb"], params["item_emb"]])
        adj = graph.norm_adj
        mean = bucketed_chain_mean_plain(self.n_layers, adj.compute_dtype, adj.pull, ego)
        return mean[:n_users], mean[n_users:]


def large_one_step_check(graph, params):
    """One step's loss and grads through BucketedChainMean (K7 + P1 both
    ways) against autograd through the plain chain; the bound must reject
    zero gradients and those of a chain one layer short."""
    config = default_config(**{"embedding.size": EMB, "LightGCN.n_layers": LAYERS})
    model, plain = build("lightgcn", config), PlainBucketedLightGCN(config)
    short = PlainBucketedLightGCN(default_config(**{"embedding.size": EMB,
                                                    "LightGCN.n_layers": LAYERS - 1}))
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(3), graph, LARGE_BATCH), graph, LARGE_BATCH)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    adj = graph.norm_adj
    ego = torch.cat([p["user_emb"], p["item_emb"]])
    if bucketed_chain_mean(LAYERS, "float32", adj.pull, adj.pull_t, ego).grad_fn is None:
        raise RuntimeError("BucketedChainMean's output carries no gradient on the card")
    before = gather_rows.launches, gather_sum.launches
    loss, _ = model.loss(p, {}, batch, graph)
    grads = torch.autograd.grad(loss, [p["user_emb"], p["item_emb"]])
    torch.cuda.synchronize()
    counts = (gather_rows.launches - before[0], gather_sum.launches - before[1])
    if counts != (4, 2 * LAYERS):
        raise RuntimeError(f"the large step launched K7, P1 {counts} times, expected 4, 6")
    plain_loss, plain_grads = plain_step(plain, params, batch, graph)
    if not grads_agree(grads, plain_grads, torch.float32):
        raise RuntimeError("large one-step grads: kernels disagree with plain")
    wrong = {"zero": [torch.zeros_like(g) for g in plain_grads],
             "one layer short": plain_step(short, params, batch, graph)[1]}
    for what, g in wrong.items():
        if grads_agree(g, plain_grads, torch.float32):
            raise RuntimeError(f"large one-step bound passes the {what} gradient")
    rtol, atol = TOL[torch.float32]
    loss_err = abs(loss.item() - plain_loss.item())
    if not (math.isfinite(loss.item()) and loss_err <= atol + rtol * abs(plain_loss.item())):
        raise RuntimeError(f"large one-step loss {loss.item()} != plain {plain_loss.item()}")
    return {"loss": loss.item(), "loss_abs_err": loss_err,
            "grad_max_abs_err": max((g - w).abs().max().item() for g, w in zip(grads, plain_grads)),
            "grad_max_abs": [w.abs().max().item() for w in plain_grads]}


def profile_ops(rec, batch, n_steps=5, top=12):
    """The device time of a training step by the operator that launched it
    and its input shapes (``record_shapes``, a separate window from
    ``profile_steps``: recording shapes costs host time): which call site
    each elementwise kernel belongs to."""
    from torch.profiler import ProfilerActivity, profile

    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(12), rec.graph, batch), rec.graph, batch)
    window = (users[:n_steps], items[:n_steps], negs[:n_steps], weights[:n_steps], n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _, loss = run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, window)
        float(loss)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type.name == "CPU" and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [{"op": e.key, "shapes": str(e.input_shapes)[:120],
             "device_us_per_step": e.self_device_time_total / n_steps,
             "calls_per_step": e.count / n_steps} for e in ops[:top]]


def large_train_phase(data, graph):
    """LightGCN's training main path on the bucketed graph, then waves of
    requests from the trained tables; returns (launches, stats)."""
    config = default_config(**{
        "embedding.size": EMB, "LightGCN.n_layers": LAYERS, "batch.size": LARGE_BATCH,
        "learning.rate": LR, "optimizer": "adam", "max.epoch": LARGE_EPOCHS,
        "eval.interval": 1, "item.ranking.topN": [20], "graph.compute_dtype": "float32",
    })
    reset_counts()
    t0 = time.perf_counter()
    rec = GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                           log=Log(echo=False), device="cuda")
    rec.build()
    rec.train()
    metrics = rec.test().metrics
    service = RecommenderService.from_recommender(rec)
    test_users = data.test_user_ids()
    waves = [test_users[i * 16:(i + 1) * 16].tolist() for i in range(20)]
    answers, wave_ms = [], []
    for uids in waves:
        t = time.perf_counter()
        answers.append(service.recommend_ids(uids, K))
        wave_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = all_counts()

    n_batches = -(-graph.n_edges // LARGE_BATCH)
    n_evals = len(rec.history) + 2  # the per-epoch evaluations, the test, the service
    want = expected_launches("lightgcn", graph, LAYERS, n_batches * LARGE_EPOCHS, n_evals)
    if launches != want:
        raise RuntimeError(f"large train launches {launches}, expected {want}")
    losses = [e["loss"] for e in rec.epoch_stats]
    if len(losses) != LARGE_EPOCHS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"large epoch losses malformed: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"large loss did not fall: {losses}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"large metrics not finite: {metrics}")
    # the served answers against the plain chain's, on the card
    with torch.no_grad():
        plain_u, plain_i = PlainBucketedLightGCN(config).propagate(
            {k: v.detach() for k, v in rec.params.items()}, graph)
    plain = RecommenderService(plain_u, plain_i, data, graph)
    tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
    mat = data.interaction_mat
    for uids, (s_got, i_got) in zip(waves, answers):
        s_plain, i_plain = plain.recommend_ids(uids, K)
        if not (np.isfinite(s_got).all() and s_got.shape == (len(uids), K)
                and topk_agree(s_got, i_got, s_plain, i_plain, tol)):
            raise RuntimeError("large served answers differ from the plain path's")
        if any(mat[u, int(i)] != 0 for u, row in zip(uids, i_got) for i in row):
            raise RuntimeError("a train positive was recommended on the large graph")
    timed = rec.epoch_stats[1:]  # epoch 0 carries the first calls' set-up
    stats = {
        "compute_dtype": "float32",
        "shape": {"users": graph.n_users, "items": graph.n_items, "edges": graph.n_edges,
                  "d": EMB, "layers": LAYERS, "batch": LARGE_BATCH, "steps_per_epoch": n_batches},
        "epochs": LARGE_EPOCHS,
        "epoch_losses": losses,
        "epoch_seconds": [e["seconds"] for e in rec.epoch_stats],
        "examples_per_s": n_batches * LARGE_BATCH * len(timed) / sum(e["seconds"] for e in timed),
        "examples_per_s_by_epoch": [e["examples_per_s"] for e in rec.epoch_stats],
        "recall@20": metrics["Recall@20"],
        "ndcg@20": metrics["NDCG@20"],
        "launches": launches,
        "served_waves": len(waves), "wave_users": 16,
        "wave_ms_p50": float(np.percentile(wave_ms, 50)),
        "wave_ms_max": max(wave_ms),
        "score_tol": tol,
        "wall_s": wall_s,
        "sampler_s_per_epoch": sampler_seconds(graph),
        "profile": profile_steps(rec, LARGE_BATCH),
        "ops_by_shape": profile_ops(rec, LARGE_BATCH),
    }
    return launches, stats


def sampler_seconds(graph, reps=3):
    """Host-clock seconds of one epoch's draw and batches
    (``epoch_words`` + ``epoch_batches``), ending in a synchronize."""
    times = []
    for seed in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_batches(epoch_words(torch.Generator().manual_seed(seed), graph, LARGE_BATCH),
                      graph, LARGE_BATCH)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


# -- the sets a quality gate can fail: the clustered large set, the hard set ------

SEGMENT_COUNTERS = (weighted_pull, segment_softmax_rows, segment_softmax_rows_bwd, segment_dot)
ALL_COUNTERS = COUNTERS + (gather_rows, gather_sum) + SEGMENT_COUNTERS


def reset_counts():
    for f in ALL_COUNTERS:
        f.launches = 0


def all_counts():
    return {f.__name__: f.launches for f in ALL_COUNTERS}


def clustered_build():
    """The clustered large set at bench.py --large's shape, 10% held out, on
    the bucketed backend (f32), and its masked popularity Recall@20."""
    t0 = time.perf_counter()
    n_users, n_items = CLUSTERED_SHAPE["n_users"], CLUSTERED_SHAPE["n_items"]
    pairs = make_clustered_interactions(**CLUSTERED_SHAPE)
    data = ArrayInteraction(pairs, n_users, n_items, test_fraction=0.1)
    t1 = time.perf_counter()
    graph = DeviceGraph(data, backend="auto", compute_dtype="float32", device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adj = graph.norm_adj
    if graph.backend != "bucketed" or not adj.sym_rowspace or len(pairs) != 1_000_000:
        raise RuntimeError(f"clustered graph on {graph.backend}, {len(pairs)} pairs")
    info = {"users": n_users, "items": n_items, "pairs": len(pairs),
            "train_edges": graph.n_edges, "test_pairs": int(len(data.test_pairs)),
            "test_users": int(len(data.test_user_ids())), "data_s": t1 - t0,
            "graph_build_s": t2 - t1, "buckets": len(adj.pull.caps),
            "slots": [adj.pull.n_slots, adj.pull_t.n_slots], "max_degree": graph.max_degree,
            "masked_popularity_recall@20": popularity_recall(data, graph),
            "popularity_recall@20": popularity_recall(data, graph, 20, masked=False)}
    print(f"clustered graph: {json.dumps(info)}")
    return data, graph, info


# the models whose dense-backend products are torch.matmul with the (U+I)²
# matrix, or that propagate nothing: no kernel of the port on that path
DENSE_MATMUL_MODELS = ("directau", "buir", "ssl4rec", "gcl", "grace", "gbt", "bgrl")


def bucketed_step_launches(model_name, n_layers):
    """K7 and P1 launches of one training step on the bucketed backend: the
    row-space chain K7 twice and P1 L times each way (LightGCN, DirectAU,
    SelfCF; BUIR adds its target encoder's chain, forward only); an
    ``adj_matmul`` round P1 and K7 once each way (GCL: two views of L
    rounds; BGRL: two views of L rounds online, and the target's forward)."""
    counts = {"buir": (6, 3 * n_layers), "gcl": (4 * n_layers, 4 * n_layers),
              "bgrl": (6 * n_layers, 6 * n_layers)}
    k7, p1 = counts.get(model_name, (4, 2 * n_layers))
    return {"gather_rows": k7, "gather_sum": p1}


def expected_launches(model_name, graph, n_layers, steps, n_evals, e_steps=0):
    """What one run's steps, E-steps and evaluations launch. On the bucketed
    backend: a step as ``bucketed_step_launches`` says, NCL's L
    ``adj_matmul`` rounds P1 and K7 once each way a round with K5 and K6 two
    calls a step, and the no-grad chain (K7 2, P1 L) for each E-step and
    evaluation, L rounds (K7 and P1 L each) for GCL's and BGRL's. On the
    dense backend SelfCF's chain over R̂ is K1 L times a forward, K2 L times
    a backward; the other zoo models and DirectAU reach no kernel of the
    port (their square products are ``torch.matmul``, as the JAX package's
    are XLA's)."""
    want = {f.__name__: 0 for f in ALL_COUNTERS}
    if model_name in NEIGHBOR_MODELS or graph.backend == "segment":
        step, per_eval = neighbor_launches(model_name, graph.backend, n_layers)
        for k in set(step) | set(per_eval):
            want[k] = step.get(k, 0) * steps + per_eval.get(k, 0) * n_evals
        return want
    if graph.backend != "bucketed":
        if model_name in ("selfcf", "lightgcn"):
            want.update(chain_mean=n_layers * (steps + n_evals), chain_mean_bwd=n_layers * steps)
        elif model_name not in DENSE_MATMUL_MODELS:
            raise ValueError(f"no launch model for {model_name} on {graph.backend}")
        return want
    chains = n_evals + e_steps  # the no-grad chain: K7 2, P1 L
    if model_name == "ncl":
        want.update(gather_rows=2 * n_layers * steps + 2 * chains,
                    gather_sum=2 * n_layers * steps + n_layers * chains,
                    catalog_lse=2 * catalog_lse.launches_per_call * steps,
                    catalog_lse_bwd=2 * catalog_lse_bwd.launches_per_call * steps)
    else:
        step = bucketed_step_launches(model_name, n_layers)
        evals = ((n_layers, n_layers) if model_name in ("gcl", "bgrl")
                 else (2, n_layers))
        want.update(gather_rows=step["gather_rows"] * steps + evals[0] * chains,
                    gather_sum=step["gather_sum"] * steps + evals[1] * chains)
    return want


def gate_phase(model_name, data, graph, epochs, batch, pop, gate, plain=None):
    """One model's training main path on a set whose ranking optimum is not
    the popularity list: the untrained tables' Recall@20, then ``epochs``
    epochs with an evaluation after each, the best epoch's tables kept (the
    trainer's model selection), the final test, and a wave of 16 test users
    served by ``RecommenderService`` (finite, no train positive). Launches
    are counted over the whole run. ``pop`` holds the masked and the plain popularity
    list's Recall@20; ``check_gate`` holds the result to ``gate``. With
    ``plain`` (the trained recommender -> the plain path's eval tables on
    the card), the served answers must equal the plain path's."""
    config = default_config(**{
        "embedding.size": EMB, "batch.size": batch, "learning.rate": LR, "optimizer": "adam",
        "max.epoch": epochs, "eval.interval": 1, "item.ranking.topN": [20],
        "graph.compute_dtype": graph.compute_dtype,
    })
    model = build(model_name, config)
    reset_counts()
    t0 = time.perf_counter()
    rec = GraphRecommender(model, data, config, graph=graph, log=Log(echo=False), device="cuda")
    rec.build()
    init_recall = rec.test().metrics["Recall@20"]
    rec.train()
    metrics = rec.test().metrics
    uids = data.test_user_ids()[:16].tolist()
    scores, ids = RecommenderService.from_recommender(rec).recommend_ids(uids, K)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = all_counts()
    n_batches = -(-graph.n_edges // batch)
    # the untrained tables, each epoch, the final test, the service
    n_evals = len(rec.history) + 3
    e_steps = epochs if model_name == "ncl" else 0
    n_layers = getattr(model, "n_layers", None)
    want = expected_launches(model_name, graph, n_layers, n_batches * epochs, n_evals, e_steps)
    if launches != want:
        raise RuntimeError(f"{model_name} on {graph.backend} launches {launches}, expected {want}")
    losses = [e["loss"] for e in rec.epoch_stats]
    if len(losses) != epochs or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{model_name} epoch losses malformed: {losses}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"{model_name} metrics not finite: {metrics}")
    mat = data.interaction_mat
    if not (np.isfinite(scores).all() and scores.shape == (len(uids), K)) or any(
            mat[u, int(i)] != 0 for u, row in zip(uids, ids) for i in row):
        raise RuntimeError(f"{model_name} on {graph.backend}: served answers malformed")
    served = {}
    if plain is not None:
        service = RecommenderService.from_recommender(rec)
        plain_u, plain_i = plain(rec)
        tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
        s_plain, i_plain = RecommenderService(plain_u, plain_i, data, graph).recommend_ids(uids, K)
        if not topk_agree(scores, ids, s_plain, i_plain, tol):
            raise RuntimeError(f"{model_name}: served answers differ from the plain path's")
        served = {"served_width": int(service.user_emb.shape[1]), "score_tol": tol}
    timed = rec.epoch_stats[1:] or rec.epoch_stats
    return {
        "model": model_name, "backend": graph.backend, "compute_dtype": graph.compute_dtype,
        "batch": batch, "layers": n_layers, "epochs": epochs, **served,
        "steps_per_epoch": n_batches, "epoch_losses": losses,
        "epoch_seconds": [e["seconds"] for e in rec.epoch_stats],
        "examples_per_s": n_batches * batch * len(timed) / sum(e["seconds"] for e in timed),
        "recall@20_untrained": init_recall,
        "recall@20_by_epoch": [h["Recall@20"] for h in rec.history],
        "best_epoch": rec.best_epoch, "recall@20": metrics["Recall@20"],
        "ndcg@20": metrics["NDCG@20"], "gate": gate,
        "masked_popularity_recall@20": pop["masked"], "popularity_recall@20": pop["plain"],
        "launches": launches, "wall_s": wall_s, "profile": profile_steps(rec, batch),
    }


def check_gate(stats):
    """Recall@20 above the bar, with the untrained tables below it (the gate
    can fail), and a falling loss. The bar: the masked popularity list's
    Recall@20 (gate "masked", the clustered set), or the popularity list's
    with Recall@20 also within MASKED_SLACK of the masked list's (gate
    "dense", the train phases' gate, for the hard set); gate "dense_kept"
    holds the dense bars without the untrained check (GRACE's untrained
    tables meet them). Gate "untrained" holds Recall@20 above the
    untrained tables' reading, gate "loss" the falling loss alone."""
    name = f"{stats['model']} {stats['backend']} {stats['compute_dtype']}"
    losses = stats["epoch_losses"]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: loss did not fall: {losses}")
    if stats["gate"] == "loss":
        return
    if stats["gate"] == "untrained":
        if not stats["recall@20"] > stats["recall@20_untrained"]:
            raise RuntimeError(f"{name}: Recall@20 {stats['recall@20']} not above the "
                               f"untrained tables' {stats['recall@20_untrained']}")
        return
    masked = stats["masked_popularity_recall@20"]
    bar = masked if stats["gate"] == "masked" else stats["popularity_recall@20"]
    if not stats["recall@20"] > bar:
        raise RuntimeError(f"{name}: Recall@20 {stats['recall@20']} not above {bar}")
    if stats["gate"] in ("dense", "dense_kept") and not stats["recall@20"] >= masked - MASKED_SLACK:
        raise RuntimeError(f"{name}: Recall@20 {stats['recall@20']} more than {MASKED_SLACK} "
                           f"below the masked popularity list's {masked}")
    if stats["gate"] != "dense_kept" and not stats["recall@20_untrained"] < bar:
        raise RuntimeError(f"{name}: the untrained tables pass the gate "
                           f"({stats['recall@20_untrained']} against {bar})")


class PlainBucketedNCL(NCL):
    """NCL on the bucketed backend with the plain rounds (``pull`` through
    the plain versions of P1 and K7) and the plain logsumexp in place of
    BucketedMatmul and CatalogLSE (K5, K6): the reference a step is held
    against."""

    def _forward_ctx(self, params, graph):
        u0, i0 = params["user_emb"], params["item_emb"]
        ego = torch.cat([u0, i0])
        layers = [ego]
        for _ in range(self.n_layers):
            ego = pull(graph.norm_adj.pull, ego, ops=PLAIN)
            layers.append(ego)
        mean = torch.mean(torch.stack(layers), dim=0)
        ctx = layers[min(self.hyper_layers * 2, self.n_layers)]
        n = graph.n_users
        return mean[:n], mean[n:], (u0, i0), (ctx[:n], ctx[n:])

    def _catalog_lse(self, q, x):
        return catalog_lse_plain(q, x, self.ssl_temp)


def first_batch(graph, batch):
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(3), graph, batch), graph, batch)
    return PairwiseBatch(users[0], items[0], negs[0], weights[0])


def step_against_plain(name, kernel, ref, dtype, want_counts, fro_tol=None, zero_grads=(),
                       frozen=()):
    """A step's value and gradients to every parameter through ``kernel`` =
    (fn, params), on the card, against ``ref`` = (fn, params), the plain
    path or the port on the CPU, on the same batch and draws (a model that
    draws masks takes them from ``host_draws``). The kernels'
    launches must be ``want_counts`` and the reference's none; the value is
    held at TOL; each gradient at GRAD_TOL (its atol relative to the
    reference's largest entry) or, with ``fro_tol``, by its relative
    Frobenius error, and that bound must reject zeros; ``zero_grads``
    (exact gradient 0) must stay under ZERO_GRAD_SHARE of the largest
    entry. ``frozen`` parameters take no gradient (GraphSAGE's fixed
    features)."""
    got = {}
    for which, (fn, params) in (("kernel", kernel), ("ref", ref)):
        p = {k: v.detach().clone().requires_grad_(k not in frozen) for k, v in params.items()}
        live = [k for k in p if k not in frozen]
        reset_counts()
        value = fn(p)
        grads = torch.autograd.grad(value, [p[k] for k in live])
        torch.cuda.synchronize()
        got[which] = (value.item(), dict(zip(live, (g.float().cuda() for g in grads))),
                      all_counts())
    (v_k, g_k, n_k), (v_r, g_r, n_r) = got["kernel"], got["ref"]
    want = {f.__name__: 0 for f in ALL_COUNTERS}
    want.update(want_counts)
    if n_k != want or any(n_r.values()):
        raise RuntimeError(f"{name}: launches {n_k} (reference {n_r}), expected {want}")
    rtol, atol = TOL[dtype]
    if not (math.isfinite(v_k) and abs(v_k - v_r) <= atol + rtol * abs(v_r)):
        raise RuntimeError(f"{name}: {v_k} against the reference's {v_r}")
    largest = max(w.abs().max().item() for w in g_r.values())
    for k in zero_grads:
        share = max(g_k[k].abs().max().item(), g_r[k].abs().max().item()) / largest
        if not share < ZERO_GRAD_SHARE:
            raise RuntimeError(f"{name}: {k}'s gradient, exactly 0, is {share} of the largest")
    checked = [k for k in g_r if k not in zero_grads]

    def errors(gs):
        if fro_tol is not None:
            return {k: (torch.linalg.norm(gs[k] - g_r[k]) / torch.linalg.norm(g_r[k])).item()
                    for k in checked}
        return {k: ((gs[k] - g_r[k]).abs().max() / g_r[k].abs().max()).item() for k in checked}

    def agree(gs):
        if fro_tol is not None:
            return all(torch.isfinite(gs[k]).all() and e <= fro_tol
                       for k, e in errors(gs).items())
        rtol, atol = GRAD_TOL[dtype]
        return all(g_r[k].abs().max().item() > 0 and torch.isfinite(gs[k]).all()
                   and torch.allclose(gs[k], g_r[k], rtol=rtol,
                                      atol=atol * g_r[k].abs().max().item()) for k in checked)

    err = errors(g_k)
    if not agree(g_k):
        raise RuntimeError(f"{name}: gradients disagree with the reference ({err})")
    if agree({k: torch.zeros_like(g) for k, g in g_r.items()}):
        raise RuntimeError(f"{name}: the bound passes zero gradients")
    return {"value": v_k, "value_abs_err": abs(v_k - v_r),
            "grad_max_abs_err": max((g_k[k] - g_r[k]).abs().max().item() for k in checked),
            "grad_max_abs": [g_r[k].abs().max().item() for k in checked],
            "grad_rel_err": max(err.values()), "grad_err_by": "frobenius" if fro_tol else "max",
            "launches": {k: v for k, v in n_k.items() if v}}


def large_ncl_one_step_check(graph, params):
    """One NCL step on the clustered bucketed graph through K5, K6, K7 and
    P1 against the plain path: the full loss at NCL's defaults, the layer
    contrast alone and ProtoNCE alone at unit weight, on the same batch and
    cluster state."""
    default = default_config(**{"embedding.size": EMB})
    unit = default_config(**{"embedding.size": EMB, "NCL.ssl_reg": 1.0, "NCL.proto_reg": 1.0})
    state = build("ncl", default).epoch_begin(params, None, graph,
                                              torch.Generator().manual_seed(7), 0)
    batch = first_batch(graph, LARGE_BATCH)
    # each round's P1 and K7 forward; backward, the rounds up to the last
    # layer the term reads: L for the loss (the mean), the context's k for
    # the layer contrast alone
    rounds, ssl_rounds = 2 * LAYERS, LAYERS + NCL_K
    lse = {"catalog_lse": 2 * catalog_lse.launches_per_call,
           "catalog_lse_bwd": 2 * catalog_lse_bwd.launches_per_call}
    out = {}
    for term, config, want in (
        ("loss", default, {"gather_rows": rounds, "gather_sum": rounds, **lse}),
        ("ssl", unit, {"gather_rows": ssl_rounds, "gather_sum": ssl_rounds, **lse}),
        ("proto", unit, {}),
    ):
        kernel_model, plain_model = build("ncl", config), PlainBucketedNCL(config)
        out[term] = step_against_plain(
            f"large NCL {term}",
            (lambda p, m=kernel_model: ncl_term(term, m, p, state, batch, graph), params),
            (lambda p, m=plain_model: ncl_term(term, m, p, state, batch, graph), params),
            torch.float32, want)
    return out


def directau_one_step_check(graph, params, batch_size, ref_graph=None):
    """One DirectAU step at its defaults. On a bucketed graph: through K7
    and P1 (the value path: the binarized adjacency has no separable
    scales) against the plain chain on the same graph. On a dense graph no
    kernel of the port is on the path: the step against the plain bucketed
    chain on ``ref_graph``, a bucketed graph of the same data."""
    config = default_config(**{"embedding.size": EMB})
    kernel_model, plain_model = build("directau", config), PlainBucketedDirectAU(config)
    batch = first_batch(graph, batch_size)
    dense = graph.backend == "dense"
    want = {} if dense else {"gather_rows": 4, "gather_sum": 2 * kernel_model.n_layers}
    if not dense and kernel_model._adj(graph).pull.sep_dst is not None:
        raise RuntimeError("the binarized adjacency kept separable scales")
    dtype = torch.bfloat16 if graph.compute_dtype == "bfloat16" else torch.float32
    return step_against_plain(
        f"DirectAU step {graph.backend} {graph.compute_dtype}",
        (lambda p: kernel_model.loss(p, {}, batch, graph)[0], params),
        (lambda p: plain_model.loss(p, {}, batch, ref_graph if dense else graph)[0], params),
        dtype, want)


def clustered_phase():
    """The clustered large set: the build, one-step checks of NCL and
    DirectAU against their plain paths, then LightGCN-BPR, NCL and DirectAU
    trained on the one graph, each held to the gate, then the bucketed zoo
    on the same graph (``bucketed_zoo_phase``) and the neighbour models
    (``clustered_neighbor_phase``)."""
    data, graph, info = clustered_build()
    pop = {"masked": info["masked_popularity_recall@20"],
           "plain": info["popularity_recall@20"]}
    params, _ = build("lightgcn", default_config(**{"embedding.size": EMB})).init(
        torch.Generator().manual_seed(0), graph)
    one_step = {"ncl": large_ncl_one_step_check(graph, params),
                "directau": directau_one_step_check(graph, params, LARGE_BATCH)}
    del params
    torch.cuda.empty_cache()
    runs = []
    for name in GATE_MODELS:
        stats = gate_phase(name, data, graph, CLUSTERED_EPOCHS[name], LARGE_BATCH, pop,
                           "masked")
        check_gate(stats)
        runs.append(stats)
    zoo = bucketed_zoo_phase(data, graph)
    return info, one_step, runs, zoo, clustered_neighbor_phase(data, graph)


def hard_phase():
    """DirectAU on the dense backend on the hard set (make_hard_dataset(),
    ML-100K-shaped), in bf16 and f32: a one-step check against the plain
    bucketed chain, then training held to the dense sets' gate; then the
    zoo on the same graphs (``hard_zoo_phase``) and the neighbour models
    and the segment backend (``hard_neighbor_phase``). (The masked
    popularity list is the stronger ranker there: the JAX package's own
    30-epoch DirectAU, 0.4144 in BASELINE.md, stays under its 0.41561, the
    bar that tests/test_torch_popularity.py holds equal to the JAX
    package's reading; PERF.md §6.)"""
    train, test = make_hard_dataset()
    data = Interaction(train, test)
    ref = DeviceGraph(data, backend="bucketed", device="cuda")
    out = {"users": data.user_num, "items": data.item_num, "train_edges": len(data.edge_users),
           "numpy": np.__version__, "one_step": {}, "train": []}
    graphs = {}
    for dtype in ("bfloat16", "float32"):
        graph = graphs[dtype] = DeviceGraph(data, compute_dtype=dtype, device="cuda")
        pop = {"masked": popularity_recall(data, graph, 20),
               "plain": popularity_recall(data, graph, 20, masked=False)}
        params, _ = build("directau", default_config(**{"embedding.size": EMB})).init(
            torch.Generator().manual_seed(0), graph)
        out["one_step"][dtype] = directau_one_step_check(graph, params, BATCH, ref)
        stats = gate_phase("directau", data, graph, HARD_EPOCHS, BATCH, pop, "dense")
        check_gate(stats)
        out["train"].append(stats)
    return (out, hard_zoo_phase(data, graphs, ref),
            hard_neighbor_phase(data, graphs["float32"], ref))


# -- the dense-path zoo: SelfCF, BUIR, SSL4Rec, GCL, GRACE, G-BT, BGRL -----------


@contextlib.contextmanager
def host_draws(seed):
    """Every augmentation draw (``graph.augment.uniform``) taken from one
    seeded host generator and moved to the tensors' device: a step on the
    card and its reference (the plain path, or the port on the CPU) see the
    same masks."""
    gen = torch.Generator().manual_seed(seed)
    on_device = augment.uniform
    augment.uniform = lambda generator, shape, device: torch.rand(
        tuple(shape), generator=gen).to(device)
    try:
        yield
    finally:
        augment.uniform = on_device


def zoo_loss(model, params, state, batch, graph, seed=5):
    """One loss of ``model`` on the draws of ``host_draws(seed)``."""
    with host_draws(seed):
        return model.loss(params, state, batch, graph, torch.Generator().manual_seed(0))[0]


def to_cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def zoo_plain(model_name, config, cpu_graph):
    """The plain path of a zoo model's eval tables on the card: SelfCF's
    plain chain there; the others (no kernel of the port on the dense
    backend) the port on the CPU, moved to the card."""
    if model_name == "selfcf":
        plain = PlainSelfCF(config)
        return lambda rec: plain.eval_embeddings(rec.params, rec.state, rec.graph)
    model = build(model_name, config)

    def tables(rec):
        u, i = model.eval_embeddings(to_cpu(rec.params), to_cpu(rec.state), cpu_graph)
        return u.cuda(), i.cuda()

    return tables


def hard_zoo_phase(data, graphs, bucketed):
    """The zoo on the hard set (d=64, B=2048), on the graphs the hard phase
    built: SelfCF's step through K1/K2 against the plain chain in bf16 and
    f32; each other model's step on the card against the port's on the CPU;
    GCL's step on the bucketed graph against its plain bucketed path (P1's
    value path, K7) and its loss against the dense backend's; then each
    model trained at its defaults (f32) for ZOO_EPOCHS and held to its
    ZOO_GATES gate, its served answers against the plain path's."""
    f32 = graphs["float32"]
    cpu = DeviceGraph(data, device="cpu")
    config = default_config(**{"embedding.size": EMB})
    batch = first_batch(f32, BATCH)
    cpu_batch = PairwiseBatch(*(t.cpu() for t in batch))
    out = {"one_step": {}, "train": [],
           "normalized_bipartite": check_normalized_bipartite(f32, cpu)}
    for dtype_name, graph in graphs.items():
        model, plain = build("selfcf", config), PlainSelfCF(config)
        params, state = model.init(torch.Generator().manual_seed(0), graph)
        dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
        out["one_step"][f"selfcf_{dtype_name}"] = step_against_plain(
            f"SelfCF step dense {dtype_name}",
            (lambda p: zoo_loss(model, p, state, batch, graph), params),
            (lambda p: zoo_loss(plain, p, state, batch, graph), params),
            dtype, {"chain_mean": model.n_layers, "chain_mean_bwd": model.n_layers})
    for name in ZOO_MODELS[1:]:
        model = build(name, config)
        params, state = model.init(torch.Generator().manual_seed(0), f32)
        cpu_state = to_cpu(state)
        out["one_step"][name] = step_against_plain(
            f"{name} step dense, card against CPU",
            (lambda p: zoo_loss(model, p, state, batch, f32), params),
            (lambda p: zoo_loss(model, p, cpu_state, cpu_batch, cpu), to_cpu(params)),
            torch.float32, {}, fro_tol=ZOO_CPU_TOL.get(name, ZOO_CPU_TOL_DEFAULT),
            zero_grads=ZERO_GRADS.get(name, ()))
    model, plain = build("gcl", config), PlainBucketedGCL(config)
    params, _ = model.init(torch.Generator().manual_seed(0), bucketed)
    gcl = step_against_plain(
        "GCL step bucketed", (lambda p: zoo_loss(model, p, {}, batch, bucketed), params),
        (lambda p: zoo_loss(plain, p, {}, batch, bucketed), params), torch.float32,
        bucketed_step_launches("gcl", model.n_layers))
    with torch.no_grad():
        dense_loss = zoo_loss(model, params, {}, batch, f32).item()
    rtol, atol = TOL[torch.float32]
    if not abs(gcl["value"] - dense_loss) <= atol + rtol * abs(dense_loss):
        raise RuntimeError(f"GCL bucketed loss {gcl['value']} against dense {dense_loss}")
    gcl["dense_value"] = dense_loss
    out["one_step"]["gcl_bucketed"] = gcl
    out["gcl_bucketed_profile"] = zoo_profile("gcl", data, bucketed, BATCH)
    pop = {"masked": popularity_recall(data, f32, 20),
           "plain": popularity_recall(data, f32, 20, masked=False)}
    for name in ZOO_MODELS:
        stats = gate_phase(name, data, f32, ZOO_EPOCHS[name], BATCH, pop, ZOO_GATES[name],
                           plain=zoo_plain(name, config, cpu))
        check_gate(stats)
        if name in ("selfcf", "buir") and stats["served_width"] != 2 * EMB:
            raise RuntimeError(f"{name} served tables of width {stats['served_width']}")
        out["train"].append(stats)
    return out


def check_normalized_bipartite(graph, cpu):
    """The dense re-normalized bipartite adjacency under one keep mask,
    built by scatter on the card twice: each coordinate holds one real
    value (the padding adds exact zeros) and the degrees are sums of 0/1,
    so the two builds must be equal bit for bit, and equal the CPU's build
    at TOL."""
    keep = (torch.rand(graph.edge_valid.shape[0], generator=torch.Generator().manual_seed(9))
            >= 0.2).float()
    a, b = (graph.normalized_bipartite(keep.cuda()).dense for _ in range(2))
    want = cpu.normalized_bipartite(keep).dense
    rtol, atol = TOL[torch.float32]
    if not (torch.equal(a, b) and torch.allclose(a.cpu(), want, rtol=rtol, atol=atol)):
        raise RuntimeError("the dense normalized_bipartite does not repeat, or differs from "
                           "the CPU's")
    return {"repeats": True, "max_abs_err_cpu": (a.cpu() - want).abs().max().item()}


def zoo_recommender(model_name, data, graph, batch):
    """A built (untrained) recommender of a zoo model at its defaults."""
    config = default_config(**{"embedding.size": EMB, "batch.size": batch, "learning.rate": LR,
                               "optimizer": "adam", "graph.compute_dtype": graph.compute_dtype})
    rec = GraphRecommender(build(model_name, config), data, config, graph=graph,
                           log=Log(echo=False), device="cuda")
    rec.build()
    return rec


def check_profile_launches(model_name, rec, batch):
    """The kernels' launches over ``profile_steps``' warm-up step and window
    (counted since the last ``reset_counts``): each step's as
    ``bucketed_step_launches`` or ``neighbor_launches`` says."""
    n_steps = 1 + min(PROFILE_STEPS, -(-rec.graph.n_edges // batch))
    n_layers = getattr(rec.model, "n_layers", None)
    per_step = (neighbor_launches(model_name, rec.graph.backend, n_layers)[0]
                if model_name in NEIGHBOR_PROFILED or rec.graph.backend == "segment"
                else bucketed_step_launches(model_name, n_layers))
    want = {k: v * n_steps for k, v in per_step.items()}
    got = {k: v for k, v in all_counts().items() if k in want}
    if got != want or any(v for k, v in all_counts().items() if k not in want):
        raise RuntimeError(f"{model_name} profile launches {all_counts()}, expected {want}")
    return got


def bucketed_zoo_phase(data, graph):
    """SelfCF, BUIR and BGRL on the clustered bucketed graph (f32, d=64,
    B=8192): one step through K7 and P1 (SelfCF on the separable fold, BUIR
    and BGRL on the value path) against the plain bucketed path, then
    PROFILE_STEPS profiled steps (no quality gate: the JAX package has no
    record on this set)."""
    config = default_config(**{"embedding.size": EMB})
    batch = first_batch(graph, LARGE_BATCH)
    plains = {"selfcf": PlainSelfCF, "buir": PlainBucketedBUIR, "bgrl": PlainBucketedBGRL}
    out = {}
    for name in BUCKETED_ZOO:
        model, plain = build(name, config), plains[name](config)
        params, state = model.init(torch.Generator().manual_seed(0), graph)
        # BGRL's ReLU units and batch norms: by Frobenius error, as against the CPU
        tol = ({"fro_tol": ZOO_CPU_TOL[name], "zero_grads": ZERO_GRADS[name]} if name == "bgrl"
               else {})
        one_step = step_against_plain(
            f"{name} step bucketed",
            (lambda p: zoo_loss(model, p, state, batch, graph), params),
            (lambda p: zoo_loss(plain, p, state, batch, graph), params), torch.float32,
            bucketed_step_launches(name, model.n_layers), **tol)
        del params, state
        out[name] = {"one_step": one_step,
                     "profile": zoo_profile(name, data, graph, LARGE_BATCH)}
        torch.cuda.empty_cache()
    return out


def zoo_profile(model_name, data, graph, batch):
    """``profile_steps`` of a zoo model's untrained recommender on a bucketed
    graph, with examples/s and K7's and P1's launches over the steps."""
    rec = zoo_recommender(model_name, data, graph, batch)
    reset_counts()
    profile = profile_steps(rec, batch)
    profile["kernel_launches"] = check_profile_launches(model_name, rec, batch)
    profile["examples_per_s"] = batch * 1e6 / profile["host_us_per_step"]
    return profile


def add_zoo_launches(chain_rows, gather_rows_, zoo, bucketed_zoo):
    """The zoo's launches into the kernels line: K1's and K2's (f32 rows)
    from the hard-set runs (SelfCF's chain over R̂), K7's and P1's from the
    bucketed zoo's profiled steps, each as ``launches_<phase>_<model>`` and
    added to the row's ``launches``."""
    for run in zoo["train"]:
        for row in chain_rows:
            n = run["launches"][row["name"]]
            if n:
                row["launches"] += n
                row[f"launches_hard_zoo_{run['model']}"] = n
    profiles = {name: run["profile"] for name, run in bucketed_zoo.items()}
    profiles["gcl"] = zoo["gcl_bucketed_profile"]
    for name, profile in profiles.items():
        for row in gather_rows_:
            n = profile["kernel_launches"][row["name"]]
            row["launches"] += n
            row[f"launches_bucketed_zoo_{name}"] = n


# -- the segment backend and the neighbour models: S1, S2, S3 -------------------------

# models whose profiled steps are counted by ``neighbor_launches``
NEIGHBOR_PROFILED = ("gat", "graphsage", "grace", "gbt")
# S1-S3 against their plain versions: the kernels sum a row's slots (or a
# head's columns) in slot order, the plain versions in their own; rtol, and
# an atol of this share of the plain result's largest entry
SEG_TOL = (1e-5, 1e-5)
# GAT's gradients to a_src and a_dst sum the softmax's backward, whose sum
# over a destination's edges is exactly 0: ill-conditioned in f32
# (tests/test_torch_gat.py). The plain path in f32 sums them with float
# atomics, 5.1e-5 from its own float64 run on the clustered graph. So a GAT
# step on the card is held to the plain path run in float64 (whose sums, in
# any order, are exact to f32's eye) by relative Frobenius error: 6.5e-7 on
# the hard set, 1.1e-6 on the clustered graph, the same in every call, on an
# NVIDIA H100 80GB HBM3 (PERF.md §6); the bound is about 10x the larger
GAT_FRO_TOL = 1e-5
# the hard set's LightGCN on the segment backend against the dense backend's,
# on the same batches: the reference's own gate between backends (BASELINE.md)
BACKEND_RECALL_GAP = 0.004


def neighbor_launches(model_name, backend, n_layers):
    """(per training step, per evaluation) launches of the segment kernels,
    P1 and K7: GAT's two attention layers (forward S2 and S1; backward S3,
    S2's backward, S1 over the transpose and two P1 per-row sums; on the
    bucket rows K7 once forward and three times backward a layer);
    GraphSAGE's L masked means (P1; the first takes no backward, its input
    being the fixed features); LightGCN's, NCL's and the square models' L
    segment matmuls both ways (their evaluation forward only); GRACE's and
    G-BT's two views of two segment matmuls both ways, where the graph is
    bucketed (their evaluation on the segment view once per layer)."""
    if model_name == "gat":
        step = {"weighted_pull": 4, "segment_softmax_rows": 2, "segment_softmax_rows_bwd": 2,
                "segment_dot": 2, "gather_sum": 4}
        per_eval = {"weighted_pull": 2, "segment_softmax_rows": 2}
        if backend == "bucketed":
            step["gather_rows"], per_eval["gather_rows"] = 8, 2
        return step, per_eval
    if model_name == "graphsage":
        return {"gather_sum": 2 * n_layers - 1}, {"gather_sum": n_layers}
    if model_name in ("grace", "gbt"):
        return {"gather_sum": 8}, {"gather_sum": 2}
    if model_name == "lightgcn" and backend == "segment":
        return {"gather_sum": 2 * n_layers}, {"gather_sum": n_layers}
    raise ValueError(f"no launch model for {model_name} on {backend}")


@contextlib.contextmanager
def plain_segment_matmul():
    """The segment matmul's plain version (the [E, d] messages added into
    their rows, under autograd) in place of P1 both ways: the reference of
    the square models on the segment backend."""
    kernel = spmm._segment_matmul
    spmm._segment_matmul = spmm.segment_matmul_plain
    try:
        yield
    finally:
        spmm._segment_matmul = kernel


def check_seg(name, fn, plain):
    """A segment kernel twice (bit for bit) and against its plain version at
    SEG_TOL. Returns the largest absolute difference."""
    (got,) = same_bits(name, lambda: (fn(),))
    want = plain()
    torch.cuda.synchronize()
    rtol, atol = SEG_TOL
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not (scale > 0 and torch.isfinite(got).all()
            and torch.allclose(got, want, rtol=rtol, atol=atol * scale)):
        raise RuntimeError(f"{name}: kernel disagrees with plain (max abs err {err})")
    return err


def segment_kernel_shape(label, row_ptr, idx, dst, live, n_src, schedule, heads):
    """S1, S2 (forward, backward) and S3 at one structure (a destination
    view or the bucket rows) and H heads of EMB, on the random logits,
    weights and cotangents the attention would give them: each against its
    plain version and itself, timed with its plain version, a library call
    where one computes the same function (H = 1: ``torch.sparse.mm`` over
    the weights as a CSR matrix for S1, ``torch.sparse.softmax`` over the
    live slots for S2 and its backward
    ``torch._sparse_softmax_backward_data``; where the rows are the
    destination nodes, ``torch.sparse.sampled_addmm`` over the view's
    pattern, batched over the heads, for S3), and its bound from the bytes it must move, each
    input read once (the distinct source and destination rows, not one row
    a slot)."""
    n_slots, n_rows = idx.numel(), row_ptr.numel() - 1
    rng = np.random.default_rng(heads)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    # gy: a cotangent in node space, gathered by each slot's destination node
    x, gy = rand(n_src, heads * EMB), rand(n_src, heads * EMB)
    e, g = rand(n_slots, heads, scale=2.0), rand(n_slots, heads)
    att = segment_softmax_rows_plain(e, row_ptr, live)
    live_idx = idx if live is None else idx[live]
    src_rows = torch.unique(live_idx).numel()
    dst_rows = torch.unique(dst).numel()
    width = heads * EMB * 4
    out = {}
    lib = None
    if heads == 1:
        csr = torch.sparse_csr_tensor(row_ptr, idx.long(), att[:, 0].contiguous(),
                                      size=(n_rows, n_src))
        lib = time_ms(lambda: torch.sparse.mm(csr, x))
    out["weighted_pull"] = {
        "max_abs_err": check_seg(f"S1 {label}", lambda: weighted_pull(x, att, idx, row_ptr,
                                                                      schedule),
                                 lambda: weighted_pull_plain(x, att, idx, row_ptr)),
        "ms": time_ms(lambda: weighted_pull(x, att, idx, row_ptr, schedule)),
        "plain_ms": time_ms(lambda: weighted_pull_plain(x, att, idx, row_ptr)),
        "library_ms": lib,
        "bound": bytes_bound(n_slots * (4 + 4 * heads) + (n_rows + 1) * 8 + src_rows * width
                             + n_rows * width)}
    lib = lib_bwd = None
    if heads == 1:
        keep = torch.ones_like(idx, dtype=torch.bool) if live is None else live
        rows_of = slot_rows(row_ptr)
        slots = torch.arange(n_slots, device="cuda")

        def coo(v):
            return torch.sparse_coo_tensor(torch.stack([rows_of[keep], slots[keep]]), v[keep, 0],
                                           size=(n_rows, n_slots)).coalesce()

        e_coo, g_coo = coo(e), coo(g)
        att_coo = torch.sparse.softmax(e_coo, 1)
        lib = time_ms(lambda: torch.sparse.softmax(e_coo, 1))
        lib_bwd = time_ms(lambda: torch._sparse_softmax_backward_data(g_coo, att_coo, 1, e_coo))
    out["segment_softmax_rows"] = {
        "max_abs_err": check_seg(f"S2 {label}", lambda: segment_softmax_rows(e, row_ptr, live),
                                 lambda: segment_softmax_rows_plain(e, row_ptr, live)),
        "ms": time_ms(lambda: segment_softmax_rows(e, row_ptr, live)),
        "plain_ms": time_ms(lambda: segment_softmax_rows_plain(e, row_ptr, live)),
        "library_ms": lib,
        "bound": bytes_bound(n_slots * (8 * heads + (0 if live is None else 1))
                             + (n_rows + 1) * 8)}
    out["segment_softmax_rows_bwd"] = {
        "max_abs_err": check_seg(f"S2 backward {label}",
                                 lambda: segment_softmax_rows_bwd(att, g, row_ptr),
                                 lambda: segment_softmax_rows_bwd_plain(att, g, row_ptr)),
        "ms": time_ms(lambda: segment_softmax_rows_bwd(att, g, row_ptr)),
        "plain_ms": time_ms(lambda: segment_softmax_rows_bwd_plain(att, g, row_ptr)),
        "library_ms": lib_bwd,
        "bound": bytes_bound(n_slots * 12 * heads + (n_rows + 1) * 8)}
    lib = lib_err = None
    if n_rows == n_src and torch.equal(dst.long(), slot_rows(row_ptr)):
        # the rows are the destination nodes: a sampled product over the
        # view's CSR pattern, batched over the heads (operands laid out for
        # it beforehand; its values come head-major)
        pattern = torch.sparse_csr_tensor(
            row_ptr.expand(heads, -1).contiguous(), idx.long().expand(heads, -1).contiguous(),
            torch.zeros(heads, n_slots, device="cuda"), size=(heads, n_rows, n_src))
        gy_h = gy.view(n_src, heads, EMB).transpose(0, 1).contiguous()
        x_h = x.view(n_src, heads, EMB).permute(1, 2, 0).contiguous()

        def sddmm():
            return torch.sparse.sampled_addmm(pattern, gy_h, x_h, beta=0.0)

        lib = time_ms(sddmm)
        lib_err = (sddmm().values().t() - segment_dot_plain(gy, dst, x, idx, heads)).abs().max()
        lib_err = lib_err.item()
    out["segment_dot"] = {
        "max_abs_err": check_seg(f"S3 {label}", lambda: segment_dot(gy, dst, x, idx, heads),
                                 lambda: segment_dot_plain(gy, dst, x, idx, heads)),
        "ms": time_ms(lambda: segment_dot(gy, dst, x, idx, heads)),
        "plain_ms": time_ms(lambda: segment_dot_plain(gy, dst, x, idx, heads)),
        "library_ms": lib, "library_max_abs_err": lib_err,
        "bound": bytes_bound(n_slots * (8 + 4 * heads) + (src_rows + dst_rows) * width)}
    for row in out.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row["shape"] = [n_rows, n_slots, heads, EMB]
    return out


def segment_kernel_shapes(label, graph):
    """``segment_kernel_shape`` at H = 4 and 1 on the graph's GAT structure:
    on the bucketed backend the bucket rows of ``norm_adj.pull`` (dead slots
    masked), else the destination view of ``bidirectional_edges``."""
    if graph.backend == "bucketed":
        pull = graph.norm_adj.pull
        aux = graph.ensure_gat_aux()
        args = (pull.row_ptr, pull.idx, aux["slot_node"], (pull.edge >= 0) & (pull.val != 0),
                graph.n_nodes, pull.schedule)
    else:
        _, by_dst = graph.bipartite_views()
        mask = bidirectional_edges(graph)[2] > 0
        args = (by_dst.row_ptr, by_dst.idx, by_dst.slot_row, mask[by_dst.perm], graph.n_nodes,
                by_dst.schedule)
    return {f"{label}_h{h}": segment_kernel_shape(f"{label} H={h}", *args, h) for h in (4, 1)}


def segment_view_pull(graph):
    """P1 over the segment backend's row-sorted view of ``norm_adj`` (one
    LightGCN layer, d = EMB, the values in slot order) against its plain
    version and itself, timed, beside one layer of ``torch.sparse.mm``."""
    adj = graph.norm_adj
    seg = adj.seg
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(adj.n_cols, EMB)).astype(
        np.float32)).cuda()
    val = adj.vals[seg.perm]
    got = check_pull("segment view", x, seg.idx, seg.row_ptr, val=val, schedule=seg.schedule)
    a_csr = torch.sparse_csr_tensor(seg.row_ptr, seg.idx.long(), val, size=adj.shape)
    live = seg.idx[val != 0]
    bound = bytes_bound(seg.n_slots * 8 + seg.row_ptr.numel() * 8
                        + torch.unique(live).numel() * EMB * 4 + adj.n_rows * EMB * 4)
    return {"shape": [adj.n_rows, seg.n_slots, EMB], **got,
            "ms": time_ms(lambda: gather_sum(x, seg.idx, seg.row_ptr, val=val,
                                             schedule=seg.schedule)),
            "plain_ms": time_ms(lambda: gather_sum_plain(x, seg.idx, seg.row_ptr, val=val)),
            "library_ms": time_ms(lambda: torch.sparse.mm(a_csr, x)),
            "bound_ms": bound[0], "bound_by": bound[1]}


class PlainSegmentLightGCN(LightGCN):
    """LightGCN on the segment backend with the plain segment matmul
    (autograd through torch ops): the reference a step is held against."""

    def propagate(self, params, graph):
        with plain_segment_matmul():
            return super().propagate(params, graph)


NEIGHBOR_PLAIN = {"gat": PlainGAT, "graphsage": PlainGraphSAGE}


def plain_own_error(plain, params, batch, graph):
    """The plain path's own f32 error: the largest relative Frobenius error
    of its f32 gradients against its float64 ones, on the same draws."""
    grads = []
    for dtype in (torch.float32, torch.float64):
        p = {k: v.detach().to(dtype).requires_grad_() for k, v in params.items()}
        grads.append(torch.autograd.grad(zoo_loss(plain, p, {}, batch, graph), list(p.values())))
    return max((torch.linalg.norm(a.double() - b) / torch.linalg.norm(b)).item()
               for a, b in zip(*grads))


def neighbor_one_step(name, graph, batch_size):
    """One step of GAT or GraphSAGE at its defaults through the segment
    kernels, P1 (and K7) against its plain path (``PlainGAT``,
    ``PlainGraphSAGE``) on the same draws: GraphSAGE's in f32; GAT's in
    float64, its gradients by relative Frobenius error (GAT_FRO_TOL), with
    the plain path's own f32 error beside it."""
    config = default_config(**{"embedding.size": EMB})
    model, plain = build(name, config), NEIGHBOR_PLAIN[name](config)
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    batch = first_batch(graph, batch_size)
    ref_params, extra, tol = params, {}, {}
    if name == "gat":
        ref_params = {k: v.double() for k, v in params.items()}
        tol = {"fro_tol": GAT_FRO_TOL}
        extra = {"reference": "plain float64",
                 "plain_f32_rel_err": plain_own_error(plain, params, batch, graph)}
    out = step_against_plain(
        f"{name} step {graph.backend}",
        (lambda p: zoo_loss(model, p, {}, batch, graph), params),
        (lambda p: zoo_loss(plain, p, {}, batch, graph), ref_params), torch.float32,
        neighbor_launches(name, graph.backend, getattr(model, "n_layers", None))[0],
        frozen=model.frozen, **tol)
    return {**out, **extra}


def segment_lightgcn_one_step(graph, batch_size):
    """One LightGCN step on the segment backend (L segment matmuls: P1 each
    way) against the plain segment matmul."""
    config = default_config(**{"embedding.size": EMB})
    model, plain = build("lightgcn", config), PlainSegmentLightGCN(config)
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    batch = first_batch(graph, batch_size)
    return step_against_plain(
        "LightGCN step segment", (lambda p: model.loss(p, {}, batch, graph)[0], params),
        (lambda p: plain.loss(p, {}, batch, graph)[0], params), torch.float32,
        neighbor_launches("lightgcn", "segment", model.n_layers)[0])


def selfloop_one_step(name, graph):
    """One GRACE or G-BT step where the graph is bucketed (its
    ``norm_adj_selfloops`` on the segment backend: P1 both ways) against
    the plain segment matmul on the same masks; the gradients by relative
    Frobenius error as the zoo's card-against-CPU steps (GRACE's InfoNCE
    over [N, 2N] scores moves a bias's gradient by a few 1e-6 of its
    largest entry between summation orders; G-BT's batch norm more, its
    biases at zero)."""
    config = default_config(**{"embedding.size": EMB})
    model = build(name, config)
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    if graph.norm_adj_selfloops.backend != "segment":
        raise RuntimeError(f"{name}: norm_adj_selfloops on {graph.norm_adj_selfloops.backend}")
    batch = first_batch(graph, BATCH)

    def plain_loss(p):
        with plain_segment_matmul():
            return zoo_loss(model, p, {}, batch, graph)

    tol = {"fro_tol": ZOO_CPU_TOL.get(name, ZOO_CPU_TOL_DEFAULT),
           "zero_grads": ZERO_GRADS.get(name, ())}
    return step_against_plain(f"{name} step bucketed (segment self-loops)",
                              (lambda p: zoo_loss(model, p, {}, batch, graph), params),
                              (plain_loss, params), torch.float32,
                              neighbor_launches(name, "bucketed", None)[0], **tol)


def hard_neighbor_phase(data, f32, bucketed):
    """The hard set (f32, d=64, B=2048): the segment kernels at its
    bidirectional edges; GraphSAGE's and GAT's steps on the dense backend
    against their plain paths, then each trained NEIGHBOR_EPOCHS and held to
    its NEIGHBOR_GATES gate, the served answers against the plain path's;
    LightGCN on the segment backend, one step against the plain segment
    matmul, then trained TRAIN_EPOCHS epochs beside the dense backend's run
    on the same batches (Recall@20 within BACKEND_RECALL_GAP); GRACE and
    G-BT forced onto the bucketed backend (``bucketed``): one step against
    the plain path, then PROFILE_STEPS profiled steps."""
    out = {"kernels": segment_kernel_shapes("hard", f32), "one_step": {}, "train": []}
    pop = {"masked": popularity_recall(data, f32, 20),
           "plain": popularity_recall(data, f32, 20, masked=False)}
    config = default_config(**{"embedding.size": EMB})
    for name in NEIGHBOR_MODELS:
        out["one_step"][name] = neighbor_one_step(name, f32, BATCH)
        plain = NEIGHBOR_PLAIN[name](config)
        stats = gate_phase(name, data, f32, NEIGHBOR_EPOCHS[name], BATCH, pop,
                           NEIGHBOR_GATES[name],
                           plain=lambda rec, m=plain: m.eval_embeddings(rec.params, rec.state,
                                                                       rec.graph))
        check_gate(stats)
        out["train"].append(stats)
    seg = DeviceGraph(data, backend="segment", device="cuda")
    out["one_step"]["lightgcn_segment"] = segment_lightgcn_one_step(seg, BATCH)
    runs = {}
    for graph in (f32, seg):
        runs[graph.backend] = gate_phase("lightgcn", data, graph, TRAIN_EPOCHS, BATCH, pop,
                                         "loss")
        check_gate(runs[graph.backend])
    gap = abs(runs["segment"]["recall@20"] - runs["dense"]["recall@20"])
    if not gap <= BACKEND_RECALL_GAP:
        raise RuntimeError(f"LightGCN on the segment backend: Recall@20 "
                           f"{runs['segment']['recall@20']} against the dense backend's "
                           f"{runs['dense']['recall@20']}")
    out["lightgcn_backends"] = {"runs": list(runs.values()), "recall@20_gap": gap}
    for name in ("grace", "gbt"):
        out["one_step"][f"{name}_bucketed"] = selfloop_one_step(name, bucketed)
        out[f"{name}_bucketed_profile"] = zoo_profile(name, data, bucketed, BATCH)
    return out


def clustered_neighbor_phase(data, graph):
    """The clustered graph (bucketed, f32, d=64, B=8192): the segment
    kernels at its bucket tables; GAT (S1-S3 and P1 over the bucket rows, K7)
    and GraphSAGE (P1 over the graph's cached views) one step against their
    plain paths, then PROFILE_STEPS profiled steps each; then LightGCN on a
    segment graph of the same data (P1 over a 2M-slot view): P1 over its
    view timed, one step against the plain segment matmul, PROFILE_STEPS
    profiled steps."""
    out = {"kernels": segment_kernel_shapes("clustered", graph)}
    for name in ("gat", "graphsage"):
        one_step = neighbor_one_step(name, graph, LARGE_BATCH)
        torch.cuda.empty_cache()
        out[name] = {"one_step": one_step, "profile": zoo_profile(name, data, graph, LARGE_BATCH)}
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seg = DeviceGraph(data, backend="segment", device="cuda")
    torch.cuda.synchronize()
    out["segment_graph_build_s"] = time.perf_counter() - t0
    out["segment_view_pull"] = segment_view_pull(seg)
    out["lightgcn_segment"] = {"one_step": segment_lightgcn_one_step(seg, LARGE_BATCH),
                               "profile": zoo_profile("lightgcn", data, seg, LARGE_BATCH)}
    del seg
    torch.cuda.empty_cache()
    return out


SEGMENT_SOURCES = {
    "weighted_pull": "recommendation_tpu/models/gat.py:59 (XLA's segment_sum, not a TPU kernel)",
    "segment_softmax_rows": "recommendation_tpu/models/gat.py:47 (XLA's segment_max and "
                            "segment_sum, not a TPU kernel)",
    "segment_softmax_rows_bwd": "recommendation_tpu/models/gat.py:162 (the custom VJP's "
                                "softmax backward, XLA; not a TPU kernel)",
    "segment_dot": "recommendation_tpu/models/gat.py:158 (the custom VJP's gather-dot, XLA; "
                   "not a TPU kernel)",
}


def segment_kernel_rows(hard, clustered, card):
    """The kernels line's rows of S1, S2 (forward, backward) and S3: the
    clustered bucket tables at H = 4 (GAT's first layer there) as the row's
    figures, every other measured shape beside them; launches from the
    neighbour models' runs (the hard set's trained GraphSAGE and GAT, the
    clustered GAT's profiled steps)."""
    shapes = {**clustered["kernels"], **hard["kernels"]}
    rows = []
    for name, src in SEGMENT_SOURCES.items():
        main = shapes["clustered_h4"][name]
        row = {"name": name, "route": "cuda", "source": "recommendation_tpu_torch/csrc/segment.cu",
               "replaces": src, "timed": "clustered bucket rows, H=4, d=64", "launches": 0,
               **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape")},
               "shapes": {label: s[name] for label, s in shapes.items()
                          if label != "clustered_h4"}, "card": card}
        row["max_abs_err"] = max(s[name]["max_abs_err"] for s in shapes.values())
        for run in hard["train"]:
            n = run["launches"][name]
            if n:
                row["launches"] += n
                row[f"launches_hard_{run['model']}"] = n
        n = clustered["gat"]["profile"]["kernel_launches"][name]
        row["launches"] += n
        row["launches_clustered_gat_profile"] = n
        rows.append(row)
    return rows


def add_neighbor_launches(k7_row, p1_row, hard, clustered):
    """P1's and K7's launches on the neighbour phases' main paths into their
    rows: the hard set's GraphSAGE, GAT and segment LightGCN runs, the
    profiled GRACE and G-BT steps on the bucketed graph, the clustered GAT,
    GraphSAGE and segment LightGCN profiles."""
    runs = {f"hard_{r['model']}": r["launches"] for r in hard["train"]}
    runs["hard_lightgcn_segment"] = hard["lightgcn_backends"]["runs"][1]["launches"]
    for name in ("grace", "gbt"):
        runs[f"hard_{name}_bucketed"] = hard[f"{name}_bucketed_profile"]["kernel_launches"]
    for name in ("gat", "graphsage"):
        runs[f"clustered_{name}"] = clustered[name]["profile"]["kernel_launches"]
    runs["clustered_lightgcn_segment"] = clustered["lightgcn_segment"]["profile"][
        "kernel_launches"]
    for row in (k7_row, p1_row):
        for label, launches in runs.items():
            n = launches.get(row["name"], 0)
            if n:
                row["launches"] += n
                row[f"launches_{label}"] = n
    p1_row["segment_view"] = clustered["segment_view_pull"]


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

    large_data, large_graph, large_info = large_build()
    large_params, _ = model.init(torch.Generator().manual_seed(0), large_graph)
    k7_row, p1_row = large_kernel_phase(large_data, large_graph, large_params)
    large_one_step = large_one_step_check(large_graph, large_params)
    launches, large_stats = large_train_phase(large_data, large_graph)
    k7_row["launches"], p1_row["launches"] = launches["gather_rows"], launches["gather_sum"]
    for row, name in ((k7_row, "gather_rows"), (p1_row, "gather_sum")):
        row["launches_large_lightgcn"] = launches[name]
    large_stats["card"] = card
    del large_data, large_graph, large_params
    torch.cuda.empty_cache()

    (clustered_info, clustered_one_step, clustered_runs, bucketed_zoo,
     clustered_nb) = clustered_phase()
    for run in clustered_runs:
        for row in lse_rows + [k7_row, p1_row]:
            row["launches"] += run["launches"][row["name"]]
            row[f"launches_clustered_{run['model']}"] = run["launches"][row["name"]]
        run["card"] = card
    hard, zoo, hard_nb = hard_phase()
    for run in hard["train"] + zoo["train"] + list(bucketed_zoo.values()) + hard_nb["train"]:
        run["card"] = card
    add_zoo_launches((rows[torch.float32], bwd_rows[torch.float32]), (k7_row, p1_row), zoo,
                     bucketed_zoo)
    add_neighbor_launches(k7_row, p1_row, hard_nb, clustered_nb)
    dense_lightgcn = hard_nb["lightgcn_backends"]["runs"][0]["launches"]
    for row in (rows[torch.float32], bwd_rows[torch.float32]):
        row["launches"] += dense_lightgcn[row["name"]]
        row["launches_hard_lightgcn_dense"] = dense_lightgcn[row["name"]]
    seg_rows = segment_kernel_rows(hard_nb, clustered_nb, card)
    kernel_rows = (list(rows.values()) + list(bwd_rows.values()) + list(layer_rows.values())
                   + list(layer_bwd_rows.values()) + lse_rows + [k7_row, p1_row] + seg_rows)
    idle = [r["name"] for r in kernel_rows if r["launches"] <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the main paths: {idle}")

    print(json.dumps({"serve": serve}))
    print(json.dumps({"one_step": one_step, "train": training}))
    print(json.dumps({"ncl": {"one_step": ncl_one_step, "train": ncl}}))
    print(json.dumps({"large": {"build": large_info, "one_step": large_one_step,
                                "train": large_stats}}))
    print(json.dumps({"clustered": {"build": clustered_info, "one_step": clustered_one_step,
                                    "train": clustered_runs}}))
    print(json.dumps({"hard": hard}))
    print(json.dumps({"hard_zoo": zoo}))
    print(json.dumps({"bucketed_zoo": bucketed_zoo}))
    print(json.dumps({"neighbors": {"hard": hard_nb, "clustered": clustered_nb}}))
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
