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
     256 MB; timed against its bound and the library call); K5 and K6 at
     d = 1024 and 600 (K6's output columns in two 512-column slabs);
  4. one-step checks: one LightGCN step's loss and gradients through
     ``ChainMean`` (K1 + K2) against autograd through the plain chain; one
     NCL step through K3-K6 against the plain path, for the full loss, the
     layer contrast alone at unit weight and ProtoNCE alone, each bound
     also rejecting zero gradients; at the bench shape; and one NCL step at
     embedding.size 1024 (both terms at unit weight) against the plain
     path by relative Frobenius error;
  5. serve phase: synthetic ML-100K (the ``bench.py`` configuration),
     LightGCN d=64 L=3 with seeded random weights, saved and reloaded
     through ``weights``; ``cli.build_service`` on ``cuda``; 320 requests
     from 16 client threads through the MicroBatcher and one ``GET
     /recommend`` over HTTP, each answer held against the plain path's on
     the card. It runs in bf16 (``bench.py``'s default) and in f32 (the
     CLI's default). Every wave replays a CUDA graph of the service's score
     block (``ops.topk.ScoreBlock``, one a padded shape; the sizes the
     clients meet are warmed up and captured before the timed run): each
     size met, and EXTRA_WAVES (no exclusion, k = 7, 1,100 users), must
     equal the block run eagerly on the same padded inputs bit for bit
     (``check_waves``), no wave may run eagerly, and ``profile_waves``
     profiles a 16-user wave graphed and eager; the clustered LightGCN
     gate run does the same for ``test()``, the evaluator and its service
     (``graphed_eval_check``);
  6. train phase: ``GraphRecommender`` on ``cuda`` at the bench shape
     (B=2048, Adam 1e-3) for TRAIN_EPOCHS epochs with an evaluation after
     each, then a few requests from ``RecommenderService.from_recommender``.
     The mean loss must fall, Recall@20 must beat the most-popular list
     (and come within 0.005 of it with train positives masked),
     K1 and K2 must launch 3 times a step (plus K1 for each evaluation),
     and a ``torch.profiler`` window of PROFILE_STEPS steps says where the step's time
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
     ``weighted_pull``, S2 with GAT's logits fused in
     (``attention_softmax``, with and without the dropout's scale, and its
     backward ``attention_softmax_bwd`` with the slope and mask) and on
     given logits (``segment_softmax_rows`` and its backward), and S1 with
     the head dot ``weighted_pull_dot`` (S3 folded into S1 over the
     transpose view: its ``dh`` and its dot) against their plain versions,
     twice bit for bit, timed beside their bounds and, where one PyTorch
     call computes the same function, ``torch.sparse.mm`` (H = 1) or
     ``torch.bmm`` over a batched COO (H > 1), ``torch.sparse.softmax``
     and its backward over a hybrid COO [R, S, H] (the softmax-only
     entries) and ``torch.sparse.sampled_addmm`` (S3 where the rows are
     the nodes); the fused call beside S1 over the transpose alone, the
     difference S3's cost: at the clustered graph's bucket tables and the
     hard set's bidirectional edges, H = 4 and 1, d = 64, and S2 at H = 3.
     On the hard set, GAT one step at 3 heads and at a hidden width of
     1024 against ``PlainGAT`` in float64. On the clustered
     graph: GAT (bucketed attention) and GraphSAGE one step against their
     plain paths (``PlainGAT``: the plain S1 and S2 under autograd, in
     float64), then PROFILE_STEPS
     profiled steps each; a segment graph of the same data, P2 over its
     row-sorted view (``segment_sum``) against its plain version, itself
     and P1 over the same view (bit for bit), timed beside P1,
     ``torch.sparse.mm`` and its bound, one LightGCN step against the plain
     segment matmul and PROFILE_STEPS profiled steps. On
     the hard set: GraphSAGE and GAT (dense backend, whose sums run the
     segment kernels) one step against their plain paths, then
     NEIGHBOR_EPOCHS epochs held to NEIGHBOR_GATES; LightGCN on the segment
     backend one step against the plain path, then TRAIN_EPOCHS epochs on
     the same batches as the dense backend's run, Recall@20 within
     BACKEND_RECALL_GAP of it; GRACE and G-BT on the bucketed graph (their
     self-loop adjacency on the segment backend) one step against the plain
     path, then PROFILE_STEPS profiled steps;
 13. the social models on the hard set with its synthesized trust triples
     (``synthesize_social``; d=64, B=2048, Adam 1e-3, f32): a
     ``SocialDeviceGraph`` on the dense, bucketed and segment backends (the
     trust edges, each social matrix's entries and bucket slots, host
     seconds); one step of DiffNet, SEPT, SEPT-basic, MHCN and ESRF (SEPT
     past its warm-up, ESRF in its adversarial phase) on the bucketed
     graph (P1 and K7 both ways) and on the segment graph (P2) against the
     plain COO product in float64; each trained SOCIAL_EPOCHS epochs on the
     dense graph and held to its SOCIAL_GATES gate, ESRF through phases 0,
     1 and 2 and SEPT into its SSL phase, each phase's loss falling, the
     served answers against the port's on the CPU; DiffNet trained on the
     bucketed graph too; each model's replayed epochs on the bucketed
     graph (item 16), P1's and K7's launches held to ``social_launches``;
     DiffNet served through ``cli.build_service`` from an ``.npz`` on the
     bucketed and the dense backend, against the plain path and each other;
 14. int8 propagation on the clustered graph (``int8_phase``): Q1
     ``quantize_rows`` (with and without its pre-scale) bit for bit and P1
     with an int8 source (the separable row-space pull and the node-space
     value pull) at P1_TOL against their plain versions at d = 256 and 250,
     each twice bit for bit; the int8 chain's fused layer (P1's int8
     epilogue: the running sum and the next layer's codes) bit for bit
     against P1, Q1 and an add in three launches, first, middle and last
     layer, at d = 256 and 250, and its running sum against the plain
     version at P1_TOL; int8 at d = 64 is the f32 path with no Q1 launch;
     Q1 and P1 at d = 256 for f32, bf16 and int8, and the fused layer
     beside the three launches, timed beside their bounds and
     ``torch.sparse.mm``, with the int8 kernels' registers; one LightGCN
     step at d = 256 on an int8 graph against the plain chain with the
     same int8 numerics (Q1 once a forward, none backward, every layer a
     fused launch); LightGCN at d = 256 trained INT8_EPOCHS epochs in f32
     and in int8 on the same batches, each held to the masked gate and
     their Recall@20 within INT8_RECALL_GAP, each step's device time and
     top kernels reported;
     then the native bucket builder against the
     numpy one on the clustered adjacency (bit for bit, host seconds) and
     ``Interaction.from_files`` against ``Interaction(load_data(...))`` on
     the hard set's files; ``python -m recommendation_tpu_torch tune`` as a
     subprocess, one epoch a configuration (a 2 x 2 grid with a rate that
     must fail alone, its CSV; then in this process through ``cli.main``,
     ``--resume`` running nothing, a preset's univariate sweep cut by
     ``--grid``); ``evaluate_rating`` on the card against the host, the LR
     and SVM probes on the card, ``profile_trace`` and ``Throughput`` around
     three steps;
 15. the parallel layer on the clustered graph (``sharded_phase``, after
     the int8 phase): LightGCN (bucketed, f32, d=64, L=3, B=8192, Adam 1e-3)
     trained by the single-rank trainer in this process (two epochs: the
     graph's warm-up, then a replay; a per-epoch checkpoint), beside each
     layout in a world of this script's ranks on the card under a hard
     timeout (a failed or missing worker fails the run; the three worlds
     run at once), each calling ``parallel.distributed.fit``: one rank
     over NCCL trains (1, 1) for two epochs, captured
     (``--sharded-nccl``; NCCL refuses two ranks on one device, so the
     two-rank layouts share the card over gloo, eagerly); two ranks train
     (1, 2) for two (``--sharded-checks``) and (2, 1) for one
     (``--sharded-data``). Every rank draws the words from its device
     generator, seeded alike. (1, 2) and (1, 1) must equal the single run
     bit for bit (each epoch's tables, Adam moments and generator state
     from the per-rank checkpoints, the epoch losses), (2, 1) within
     SHARDED_DATA_TOL of each part's largest magnitude. The (1, 1) world
     then times its build in parts, holds a second trainer's replayed
     epochs to its eager ones and a fused block to the warm-up and a
     replay (``graphed_check`` with its placement), profiles the eager
     step, holds the graphed sharded evaluator to the single evaluator and
     SHARDED_SERVE_WAVES graphed mesh waves to the same padded waves run
     eagerly (bit for bit) and to the single service (``topk_agree``),
     and profiles the waves both ways, and holds MHCN's replayed epochs on
     the hard set's bucketed social graph to its eager ones with the
     placement (``graphed_zoo_check`` on the mesh; ``sharded_nccl_worker``,
     ``nccl_checks``). The (2, 1) world then takes the data axis for every model:
     NCL and GAT one epoch each at full width on the same graph (K5/K6,
     S1/S2, K7 and P1 in both ranks) against this process's single runs:
     the tables and Adam moments after SHARDED_SNAPSHOT_STEPS steps and
     the epoch loss within SHARDED_DATA_TOL (NCL's tables within
     SHARDED_EPOCH_TOL), both ranks' tables and NCL's
     cluster state one digest each, the epoch's end reported; then one
     step of each model of SHARDED_ZOO on the hard set (bucketed; the
     social models on its trust graph) against this process's single
     step: each rank's loss, the data group's summed gradient within
     SHARDED_DATA_TOL, each rank's launches the single step's. Between
     the two it takes edge-parallel propagation (the segment backend at
     data > 1: each rank pulls its row range of ``norm_adj`` with P2 and
     the rows are all-gathered) on the clustered set's segment graph:
     LightGCN's ``eval_embeddings`` on the initial tables the single
     forward bit for bit, LightGCN's and NCL's (K5/K6 too) first
     SHARDED_SNAPSHOT_STEPS steps held as the epochs are, each rank's
     launches the single run's, each rank's rows, slots (summing to the
     view's) and P2 device µs a step reported; after the zoo, one step of
     each EDGE_ZOO model (those whose step reads ``norm_adj`` or a
     ``with_vals`` copy of it) on the hard set's segment graphs, held as
     the zoo's steps are. The (1, 2) world's ranks then restore their run
     from its per-rank checkpoints: its sharded
     ``test()`` equal to the single evaluator's metrics on its tables, its
     ``RecommenderService(..., mesh)`` over 20 waves of 16 users, with and
     without exclusions, in agreement with the single service's
     (``topk_agree``), its second epoch resumed from its epoch-0 per-rank
     checkpoint equal to the straight run's, and NCL's E-step one digest on
     both ranks; each rank's launches held to ``expected_launches``. Each
     world's wall seconds and each layout's seconds and host seconds a step
     go in the sharded line, with the card's name and power limit: two
     ranks share one card, so they are no scaling figure;
 16. the epoch as CUDA graphs (``graphed_check``, ``train/graphed.py``):
     the trainers above replay their LightGCN and NCL epochs from the
     second on, and for each configuration of the slice (LightGCN dense
     bf16 and f32 and NCL dense f32, after the NCL train phase; LightGCN on
     the clustered bucketed graph, after its gate runs; NCL on the hard
     set's bucketed graph, in the hard phase; LightGCN on the clustered
     segment graph, in the neighbour phase; LightGCN at d = 256 int8, in
     the int8 phase) the trainer's ``GraphedEpoch`` warms up and captures
     on one epoch, then from the same parameters, Adam moments, state and
     generator state GRAPHED_REPEATS consecutive replayed epochs and as
     many eager ones (``train_epoch``) must agree bit for bit epoch by
     epoch, the generator's state too (each epoch draws its words on the
     card, inside the graph), each epoch's launches ``expected_launches``'
     (a replay adds its graph's), their host seconds the medians of host
     µs a step, and one more replay under torch.profiler gives device µs a
     step, the idle share (``profile_steps``' method) and no host-to-device
     copy, with each capture's seconds and pool bytes; the first epoch's
     draw (``check_epoch_draw``) is a permutation of the train edges and
     no negative is a train positive; on the clustered bucketed graph the
     epoch in chunks of
     GRAPHED_CHUNK steps (a full chunk's graph and the remainder's) too;
     and a fused block of two epochs against two epochs, captured and
     eager (dense f32). Every
     trainer above replays the epochs of every model, so the gate runs of the hard, neighbour and
     social phases replay theirs; and the fifteen other models
     (``graphed_zoo_check``:
     DirectAU and the dense zoo on the hard set's dense f32 graph, after
     their gate runs; GraphSAGE and GAT on it, where S1, S2 and P2 launch,
     in the neighbour phase; the social models on its bucketed trust graph,
     in the social phase) and GRAPHED_ONCE_EAGER's four configurations
     (LightGCN pointwise and ``n_negs`` 3, NCL's per-batch E-step, the
     bold driver's SGD with its rate moved; the hard dense f32 graph) each
     warm up and capture, then from one start
     (parameters, moments, the param groups' tensors, state and the
     trainer's device generator) GRAPHED_REPEATS consecutive replayed
     epochs equal as many eager ones bit for bit, the generator's state
     after them too, past the words' share where the model draws masks
     (ESRF in each of its three phases' graphs), each epoch's launches
     ``expected_launches``', and one more replayed epoch under
     torch.profiler gives device µs a step, with no host-to-device copy. A
     ``graphed:`` line a configuration prints as it ends;
 17. prints the serving line, the training line, the NCL line, the large
     line, the clustered line, the hard line, the hard_zoo line, the
     bucketed_zoo line, the neighbors line, the social line, the int8 line,
     the sharded line, the graphed line, the kernels line (every kernel
     must have launched on a main path; each f32 row carries each sharded
     run's launches by rank as ``launches_sharded_<layout>[_<model>|_steps|
     _edge_<model>|_edge_steps|_checks|_mhcn_replays]`` and the launches inside each of the
     fifteen models' replayed graphs as ``launches_graphed_<model>``; a row
     without a library time says why in ``library_note``) and, last, the
     device line.

Launch counts are reset just before each main path and read just after it.
Exits non-zero without printing a result where no CUDA device is present.
"""

from __future__ import annotations

import collections
import contextlib
import concurrent.futures
import csv
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

IMPORTED_AT = [time.perf_counter()]  # this process's imports (the (1, 1) world's build split)
import torch  # noqa: E402

IMPORTED_AT.append(time.perf_counter())
DEVICE_MESH_WITH_TORCH = "torch.distributed.device_mesh" in sys.modules

from recommendation_tpu_torch.cli import build_service  # noqa: E402
from recommendation_tpu_torch.cli import main as cli_main
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch import native
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.io import load_data
from recommendation_tpu_torch.data.social import (
    Relation,
    esrf_motif_adjacency,
    mhcn_hypergraph_channels,
    sept_social_views,
    synthesize_social,
)
from recommendation_tpu_torch.data.synthetic import (
    ArrayInteraction,
    make_clustered_interactions,
    make_flat_interactions,
    make_hard_dataset,
    make_synthetic_dataset,
    write_dataset,
)
from recommendation_tpu_torch.evalx.metrics import ranking_metrics
from recommendation_tpu_torch.evalx.probe import LREvaluator, SVMEvaluator, get_split
from recommendation_tpu_torch.evalx.rating import evaluate_rating
from recommendation_tpu_torch.evalx.ranking import evaluate_ranking, score_block_for
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.bucketed import (
    PLAIN,
    build_bucketed,
    bucketed_chain_mean,
    bucketed_chain_mean_plain,
    packer,
    pull,
)
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.graph.social_device import SOCIAL_MATRICES, SocialDeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.bgrl import PlainBucketedBGRL
from recommendation_tpu_torch.models.buir import PlainBucketedBUIR
from recommendation_tpu_torch.models.directau import PlainBucketedDirectAU
from recommendation_tpu_torch.models.esrf import ESRF
from recommendation_tpu_torch.models.gat import PlainGAT, attention_structure
from recommendation_tpu_torch.models.graphsage import PlainGraphSAGE
from recommendation_tpu_torch.models.gcl import PlainBucketedGCL
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.models.selfcf import PlainSelfCF
from recommendation_tpu_torch.models.sept import SEPT
from recommendation_tpu_torch.ops import build as kernels
from recommendation_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_sum,
    gather_sum_plain,
    padded_width,
    quantize_rows,
    quantize_rows_plain,
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
    attention_softmax,
    attention_softmax_bwd,
    attention_softmax_bwd_plain,
    attention_softmax_plain,
    segment_dot_plain,
    segment_softmax_rows,
    segment_softmax_rows_bwd,
    segment_softmax_rows_bwd_plain,
    segment_softmax_rows_plain,
    segment_sum,
    slot_rows,
    weighted_pull,
    weighted_pull_dot,
    weighted_pull_dot_plain,
    weighted_pull_plain,
)
from recommendation_tpu_torch.ops.topk import ScoreBlock, topk_agree, wave_rows
from recommendation_tpu_torch.ops.counts import kernel_wrappers
from recommendation_tpu_torch.parallel.distributed import (
    WORKER,
    merged_checkpoint,
    spawn_world,
)
from recommendation_tpu_torch.sampling import (
    PairwiseBatch,
    epoch_batches,
    epoch_words,
    keyed_permutation,
    popularity_baseline_topk,
)
from recommendation_tpu_torch.serve.http import serve_http
from recommendation_tpu_torch.serve.service import RecommenderService
from recommendation_tpu_torch.train.graphed import GraphedEpoch
from recommendation_tpu_torch.train.loop import (
    cosine_decay,
    run_steps,
    set_learning_rate,
    step_grads,
    train_epoch,
)
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.utils.profiling import Throughput, profile_trace
from recommendation_tpu_torch.weights import load_params, save_params

IMPORTED_AT.append(time.perf_counter())

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
# the eager profiles' steps: few, to keep the script within its time
# (every model's epochs are timed whole by graphed_check or
# graphed_zoo_check)
BATCH, LR, TRAIN_EPOCHS, PROFILE_STEPS = 2048, 1e-3, 5, 5
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
# every kernel's wrapper, each counting its launches: K1-K4, K5/K6, K7, P1,
# Q1, S1 (and with the head dot), S2 (on given logits and with GAT's fused in)
ALL_COUNTERS = kernel_wrappers()
COUNTERS = ALL_COUNTERS[:6]  # K1-K6
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
# the social models on the hard set with its synthesized trust triples
# (dense backend, f32, each at its defaults) and their gates; epochs and
# gates from tools/zoo_gate_calibration.py --social (PERF.md §4)
SOCIAL_MODELS = ("diffnet", "sept", "sept_social", "sept_basic", "mhcn", "esrf")
SOCIAL_GATES = {"diffnet": "popularity", "sept": "popularity", "sept_social": "popularity",
                "sept_basic": "popularity", "mhcn": "loss", "esrf": "popularity"}
SOCIAL_EPOCHS = {"diffnet": 3, "sept": 4, "sept_social": 4, "sept_basic": 3, "mhcn": 3,
                 "esrf": 6}


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


# K5/K6 past K6's first 512-column slab (NCL's tuning grid reaches
# embedding.size 1024): a width of two slabs and a ragged one
LSE_WIDE_D = (1024, 600)


def kernel_phase_lse_wide(n_items):
    """K5 and K6 at B = BATCH against the dense set's item catalog at each
    of LSE_WIDE_D: against their plain versions (LSE_TOL, LSE_GRAD_TOL) and
    twice bit for bit, timed beside their plain versions and their bounds
    (the function's own one and three products; K6's second slab repeats
    the score product, which the bound does not count)."""
    rng = np.random.default_rng(5)
    out = {}
    for d in LSE_WIDE_D:
        q, x = unit_rows(rng, BATCH, d), unit_rows(rng, n_items, d)
        g = torch.from_numpy(rng.normal(size=BATCH).astype(np.float32)).cuda()
        (lse,) = same_bits(f"catalog_lse d={d}", lambda: [catalog_lse(q, x, TAU)])
        want = catalog_lse_plain(q, x, TAU)
        err = compare(f"catalog_lse d={d}", [lse], [want], torch.float32,
                      {torch.float32: LSE_TOL})
        err_b = compare(f"catalog_lse_bwd d={d}",
                        same_bits(f"catalog_lse_bwd d={d}",
                                  lambda: catalog_lse_bwd(q, x, TAU, lse, g)),
                        catalog_lse_bwd_plain(q, x, TAU, want, g), torch.float32,
                        {torch.float32: LSE_GRAD_TOL})
        shape = [(BATCH, n_items, d)]
        out[f"d{d}"] = {
            "shape": list(shape[0]), "lse_bwd_slabs": lse_ops._kernel_lib().lse_bwd_slabs(d),
            "catalog_lse": {"max_abs_err": err, "ms": time_ms(lambda: catalog_lse(q, x, TAU)),
                            "plain_ms": time_ms(lambda: catalog_lse_plain(q, x, TAU)),
                            "bound_ms": lse_bound(shape, 1)[0]},
            "catalog_lse_bwd": {"max_abs_err": err_b,
                                "ms": time_ms(lambda: catalog_lse_bwd(q, x, TAU, lse, g)),
                                "plain_ms": time_ms(lambda: catalog_lse_bwd_plain(q, x, TAU, lse,
                                                                                  g)),
                                "bound_ms": lse_bound(shape, 3)[0],
                                "workspace_bytes": check_lse_workspace(q, x, lse, g)}}
    return out


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
    return model._proto_nce(state, initial, batch, batch.users.shape[0])


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


# NCL at embedding.size 1024 against its plain path: each score now sums
# 1024 products (16x NCL's default), so the gradients are held by relative
# Frobenius error, as GAT's are, at GAT_FRO_TOL's 1e-5
NCL_WIDE_D = 1024


def ncl_wide_one_step(graph):
    """One NCL step at embedding.size NCL_WIDE_D on the dense f32 graph,
    the layer contrast and ProtoNCE at unit weight: K3 and K4 a launch a
    layer, K5 and K6 two calls (K6 in two column slabs), against the plain
    path on the same batch and clusters."""
    config = default_config(**{"embedding.size": NCL_WIDE_D, "NCL.ssl_reg": 1.0,
                               "NCL.proto_reg": 1.0})
    model, plain = build("ncl", config), PlainNCL(config)
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    state = model.epoch_begin(params, None, graph, torch.Generator().manual_seed(7), 0)
    batch = first_batch(graph, BATCH)
    want = {"chain_mean_layer": model.n_layers, "chain_mean_layer_bwd": model.n_layers,
            "catalog_lse": 2 * catalog_lse.launches_per_call,
            "catalog_lse_bwd": 2 * catalog_lse_bwd.launches_per_call}
    return step_against_plain(f"NCL step d={NCL_WIDE_D}",
                              (lambda p: model.loss(p, state, batch, graph)[0], params),
                              (lambda p: plain.loss(p, state, batch, graph)[0], params),
                              torch.float32, want, fro_tol=GAT_FRO_TOL)


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


def profile_waves(service, wave: int = 16, n_waves: int = 20, eager: bool = False):
    """Where one request wave's time goes: torch.profiler over ``n_waves``
    direct device queries of ``wave`` users (the MicroBatcher's typical wave
    at 16 clients), through the service's graphs or, ``eager``, its block
    run eagerly (``RecommenderService.eager_block``). Returns host wall per
    wave (under the profiler, whose CPU activity adds to it, and without
    it), device time per wave, the device's idle share (against the
    profiled wall) and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    uids = list(range(wave))
    graphed = service.block
    if eager:
        service.block = service.eager_block()
    try:
        service._recommend_ids_device(uids, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_waves):
            service._recommend_ids_device(uids, K)
        torch.cuda.synchronize()
        unprofiled_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_waves):
                service._recommend_ids_device(uids, K)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        service.block = graphed
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        return {"wave_users": wave, "host_us_per_wave": wall_us / n_waves,
                "device_us_per_wave": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "wave_users": wave,
        "host_us_per_wave": wall_us / n_waves,
        "host_us_per_wave_unprofiled": unprofiled_us / n_waves,
        "device_us_per_wave": device_us / n_waves,
        "device_idle_share": 1.0 - device_us / wall_us,
        "top_kernels_us_per_wave": {e.key[:60]: e.self_device_time_total / n_waves for e in top},
    }


# the serve phase's extra waves beside the buckets the clients meet: no
# exclusion, another k, and 1,100 users (a 1,024 block and a 128 tail)
EXTRA_WAVES = ((16, K, False), (16, 7, True), (1100, K, True))


def check_waves(service, label, waves, seed=0):
    """Each wave (users, k, exclude_seen) of random users through the
    service's graphs against its block run eagerly on the same padded
    inputs, bit for bit (scores and ids). Returns each wave's shape."""
    eager = service.eager_block()
    rng = np.random.default_rng(seed)
    out = []
    for b, k, exclude in waves:
        uids = rng.integers(0, service.data.user_num, b).tolist()
        got = service._recommend_ids_device(uids, k, exclude)
        padded, pos = service.wave_inputs(uids, exclude)
        want = eager.topk_ids(padded, k, pos)
        if not all(np.array_equal(g, w[:b]) for g, w in zip(got, want)):
            raise RuntimeError(f"{label}: the replayed wave of {b} users (k {k}, exclude_seen "
                               f"{exclude}) differs from the eager padded block")
        out.append({"users": b, "rows": wave_rows(b), "k": k, "exclude_seen": exclude})
    return out


def block_stats(block):
    """A ``ScoreBlock``'s graphs: their count and keys, each capture's
    seconds and the bytes its pool grew by, replays and eager runs."""
    return {"graphs": len(block.captures), "keys": [c["key"] for c in block.captures],
            "capture_s": [c["seconds"] for c in block.captures],
            "pool_bytes": [c["pool_bytes"] for c in block.captures], **block.stats}


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
    first_wave_s = {}
    try:
        # untimed waves first: each size's first wave, on the dispatcher
        # thread, warms up and captures its graph (the JAX service compiles
        # a program a size), which is start-up, not serving; the clients
        # meet these sizes only (at most N_CLIENTS users a wave)
        for b in (1, 2, 4, 8, 16):
            t = time.perf_counter()
            service.recommend_ids(list(range(b)), K)
            first_wave_s[b] = time.perf_counter() - t
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
    met = service.block.stats["replays"]
    waves = check_waves(service, f"serve {compute_dtype}",
                        [(rows, K, True) for rows in sorted({key[1] for key in service.block.keys})]
                        + list(EXTRA_WAVES))
    blocks = block_stats(service.block)
    if blocks["eager"] or met != batcher.stats["device_calls"] or blocks["graphs"] != len(
            service.block.keys):
        raise RuntimeError(f"serve {compute_dtype}: waves not all replayed: {blocks}, "
                           f"{batcher.stats}")

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
        "profile_eager": profile_waves(service, eager=True),
        "waves_same_bits": waves, "score_block": blocks, "replays_in_client_run": met,
        "first_wave_s": first_wave_s,
        "compute_dtype": compute_dtype,
        "requests": len(latencies) + len(first_wave_s),
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


def profile_steps(rec, batch=BATCH, placement=None):
    """Where one training step's time goes: torch.profiler over
    PROFILE_STEPS steps of the trainer's eager loop (``train.loop.run_steps``) on the trained
    recommender (``placement``: a sharded trainer's). Host wall per step, device time per
    step (the kernels' sum and the union of their intervals), the device's idle
    share and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    users, items, negs, weights, n_batches = epoch_batches(
        epoch_words(torch.Generator().manual_seed(11), rec.graph, batch), rec.graph, batch)
    n_steps = min(PROFILE_STEPS, n_batches)
    window = (users[:n_steps], items[:n_steps], negs[:n_steps], weights[:n_steps], n_steps)
    draws = torch.Generator().manual_seed(12)  # the augmenting models' masks
    run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state,
              (users[:1], items[:1], negs[:1], weights[:1], 1), draws, placement)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, window,
                            draws, placement)
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
    spans = [e for e in prof.events() if e.device_type.name == "CUDA"
             and not getattr(e, "is_user_annotation", False)]
    return {
        "steps": n_steps,
        "host_us_per_step": wall_us / n_steps,
        "device_us_per_step": device_us / n_steps,
        "device_busy_us_per_step": busy_us(spans) / n_steps,
        "device_idle_share": 1.0 - device_us / wall_us,
        "device_busy_idle_share": 1.0 - busy_us(spans) / wall_us,
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


def pull_bound(csr, d, itemsize, val=False, post=True, row_bytes=None):
    """P1: the slot indices (and values) and row pointers, each distinct
    source row the live slots pick read once (``row_bytes`` a row, d ·
    itemsize by default; an int8 row its padded codes and its scale), the
    row scales, the [R + 1, d] f32 output written once."""
    live = csr.ridx[csr.ridx != csr.total_rows]
    n_out = csr.total_rows + 1
    row_bytes = d * itemsize if row_bytes is None else row_bytes
    nbytes = (csr.n_slots * 4 * (1 + val) + csr.row_ptr.numel() * 8
              + torch.unique(live).numel() * row_bytes + n_out * 4 * post + n_out * d * 4)
    return bytes_bound(nbytes)


def fused_bound(csr, d, acc, requant):
    """The int8 chain's fused layer: P1-int8's bytes (``pull_bound``), the
    running sum read where there is one (``acc``), and with ``requant`` the
    pre-scale read and the next layer's padded codes and scales written."""
    n_out = csr.total_rows + 1
    pull_ms, _ = pull_bound(csr, d, 1, row_bytes=padded_width(d) + 4)
    extra = n_out * d * 4 * acc + requant * n_out * (4 + padded_width(d) + 4)
    return pull_ms + bytes_bound(extra)[0], "bytes"


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
        "sampler_s_per_epoch_device_generator": sampler_seconds(graph, device=True),
        "profile": profile_steps(rec, LARGE_BATCH),
        "ops_by_shape": profile_ops(rec, LARGE_BATCH),
    }
    return launches, stats


def sampler_seconds(graph, reps=3, device=False):
    """Host-clock seconds of one epoch's draw and batches
    (``epoch_words`` + ``epoch_batches``), ending in a synchronize: the
    words drawn on the host and copied in, or with ``device`` drawn on the
    card from a generator there, as the trainer draws them."""
    times = []
    for seed in range(reps):
        gen = torch.Generator(device="cuda" if device else "cpu").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_batches(epoch_words(gen, graph, LARGE_BATCH), graph, LARGE_BATCH)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


# -- the sets a quality gate can fail: the clustered large set, the hard set ------

def reset_counts():
    for f in ALL_COUNTERS:
        f.launches = 0
    gather_sum.launches_int8 = 0
    gather_sum.launches_fused = 0


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


def expected_launches(model_name, graph, n_layers, steps, n_evals, e_steps=0, emb=EMB,
                      phase=2):
    """What one run's steps, E-steps and evaluations launch. On the bucketed
    backend: a step as ``bucketed_step_launches`` says, NCL's L
    ``adj_matmul`` rounds P1 and K7 once each way a round with K5 and K6 two
    calls a step, and the no-grad chain (K7 2, P1 L) for each E-step and
    evaluation, L rounds (K7 and P1 L each) for GCL's and BGRL's. On the
    dense backend SelfCF's chain over R̂ is K1 L times a forward, K2 L times
    a backward; NCL's step K3 and K4 L times and K5 and K6 two calls, its
    E-steps and evaluations K1 L times; the other zoo models and DirectAU
    reach no kernel of the port (their square products are ``torch.matmul``, as the JAX package's
    are XLA's). Where int8 packs (a bucketed chain at ``emb`` >= 249), each
    forward chain quantizes layer 0's source (Q1) and its L pulls the rest
    in their epilogue; the backward quantizes nothing. ``phase``: ESRF's
    (``social_launches``)."""
    want = {f.__name__: 0 for f in ALL_COUNTERS}
    if model_name == "ssl4rec":  # no graph in its loss: no kernel on any backend
        return want
    if model_name in SOCIAL_MODELS:
        if graph.backend != "dense":  # on the dense backend: torch.matmul
            step, per_eval = social_launches(model_name, graph.backend, n_layers, phase=phase)
            for k in step:
                want[k] = step[k] * steps + per_eval[k] * n_evals
        return want
    if model_name in NEIGHBOR_MODELS or graph.backend == "segment" or (
            model_name in ("grace", "gbt") and graph.backend == "bucketed"):
        step, per_eval = neighbor_launches(model_name, graph, n_layers)
        for k in set(step) | set(per_eval):
            want[k] = step.get(k, 0) * steps + per_eval.get(k, 0) * n_evals
        return want
    if graph.backend != "bucketed":
        if model_name in ("selfcf", "lightgcn"):
            want.update(chain_mean=n_layers * (steps + n_evals), chain_mean_bwd=n_layers * steps)
        elif model_name == "ncl":  # K3/K4 a layer, two K5/K6 calls a step; K1 to evaluate
            want.update(chain_mean=n_layers * (n_evals + e_steps),
                        chain_mean_layer=n_layers * steps, chain_mean_layer_bwd=n_layers * steps,
                        catalog_lse=2 * catalog_lse.launches_per_call * steps,
                        catalog_lse_bwd=2 * catalog_lse_bwd.launches_per_call * steps)
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
        if model_name == "lightgcn" and packer(graph.compute_dtype, emb) == "int8":
            want.update(quantize_rows=steps + chains)
    return want


def graphed_eval_check(rec, data, graph):
    """A trained recommender's evaluation and service through the score
    block's graphs: ``test()`` and the evaluator on the graph's evaluation
    block against the evaluator with its block run eagerly on the same
    tables (metrics, ids and scores bit for bit), then the service's waves
    (``check_waves``) at 16 users and EXTRA_WAVES'."""
    t0 = time.perf_counter()
    user_emb, item_emb = rec.model.eval_embeddings(rec.model_params(), rec.state, graph)
    tested = rec.test()
    graphed = evaluate_ranking(user_emb, item_emb, data, graph, Ns=rec.topN)
    eager = evaluate_ranking(user_emb, item_emb, data, graph, Ns=rec.topN,
                             block=ScoreBlock(item_emb, graphs=False))
    if not (graphed.metrics == eager.metrics == tested.metrics
            and np.array_equal(graphed.top_ids, eager.top_ids)
            and np.array_equal(graphed.top_scores, eager.top_scores)):
        raise RuntimeError(f"{rec.model.name}: the graphed evaluation differs from the eager one: "
                           f"{graphed.metrics} / {eager.metrics} / {tested.metrics}")
    service = RecommenderService.from_recommender(rec)
    waves = check_waves(service, f"{rec.model.name} {graph.backend} service",
                        [(16, K, True)] + list(EXTRA_WAVES), seed=1)
    out = {"metrics": eager.metrics, "metrics_same_bits": True,
           "test_users": int(len(eager.test_user_ids)),
           "eval_block": block_stats(score_block_for(graph, item_emb)),
           "waves_same_bits": waves, "service_block": block_stats(service.block),
           "seconds": time.perf_counter() - t0}
    if out["eval_block"]["eager"] or out["service_block"]["eager"]:
        raise RuntimeError(f"{rec.model.name}: an evaluation or a wave ran eagerly: {out}")
    print(f"graphed evaluation: {rec.model.name} {graph.backend}: test() and the evaluator "
          f"equal the eager evaluator bit for bit over {out['test_users']} users; "
          f"{len(waves)} service waves too; {out['seconds']:.1f} s")
    return out


def gate_phase(model_name, data, graph, epochs, batch, pop, gate, plain=None, profile=True,
               emb=EMB, graphed_eval=False):
    """One model's training main path on a set whose ranking optimum is not
    the popularity list: the untrained tables' Recall@20, then ``epochs``
    epochs with an evaluation after each, the best epoch's tables kept (the
    trainer's model selection), the final test, and a wave of 16 test users
    served by ``RecommenderService`` (finite, no train positive). Launches
    are counted over the whole run. ``pop`` holds the masked and the plain popularity
    list's Recall@20; ``check_gate`` holds the result to ``gate``. With
    ``plain`` (the trained recommender -> the plain path's eval tables on
    the card), the served answers must equal the plain path's. ``profile``:
    ``profile_steps`` of the trained recommender in the result; ``emb``
    the embedding size. ``graphed_eval``: ``graphed_eval_check`` after
    the launches are read."""
    config = default_config(**{
        "embedding.size": emb, "batch.size": batch, "learning.rate": LR, "optimizer": "adam",
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
    want = expected_launches(model_name, graph, n_layers, n_batches * epochs, n_evals, e_steps,
                             emb)
    if launches != want:
        raise RuntimeError(f"{model_name} on {graph.backend} launches {launches}, expected {want}")
    evaluation = ({"graphed_evaluation": graphed_eval_check(rec, data, graph)}
                  if graphed_eval else {})
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
        "launches": launches, "launches_p1_int8": gather_sum.launches_int8,
        "launches_p1_fused": gather_sum.launches_fused, "wall_s": wall_s,
        "embedding_size": emb, **evaluation,
        **({"profile": profile_steps(rec, batch)} if profile else {}),
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
    if "phases" in stats:
        # a loss that changes its terms by epoch (SEPT's SSL after its
        # warm-up, ESRF's three phases) must fall within each phase that
        # spans epochs, and one phase must
        runs = {}
        for phase, loss in zip(stats["phases"], losses):
            runs.setdefault(phase, []).append(loss)
        spans = [run for run in runs.values() if len(run) > 1]
        if not spans or not all(run[-1] < run[0] for run in spans):
            raise RuntimeError(f"{name}: loss did not fall within its phases: "
                               f"{list(zip(stats['phases'], losses))}")
    elif not losses[-1] < losses[0]:
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
    on the same graph (``bucketed_zoo_phase``), the neighbour models
    (``clustered_neighbor_phase``), int8 propagation with the host
    modules (``int8_phase``) and the parallel layer (``sharded_phase``)."""
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
        # LightGCN's and NCL's epochs are timed eager and captured by graphed_check
        stats = gate_phase(name, data, graph, CLUSTERED_EPOCHS[name], LARGE_BATCH, pop,
                           "masked", profile=name == "directau",
                           graphed_eval=name == "lightgcn")
        check_gate(stats)
        runs.append(stats)
    graphed_check("lightgcn clustered bucketed float32", "lightgcn", data, graph, LARGE_BATCH,
                  chunk=GRAPHED_CHUNK)
    stamp("clustered_gates")
    zoo = bucketed_zoo_phase(data, graph)
    stamp("bucketed_zoo")
    nb = clustered_neighbor_phase(data, graph)
    stamp("clustered_neighbors")
    int8 = int8_phase(data, graph, pop)
    stamp("int8")
    sharded = sharded_phase(data, graph, card_line())
    stamp("sharded")
    return info, one_step, runs, zoo, nb, int8, sharded


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
        # f32's epoch is profiled replayed and eager by graphed_zoo_check below
        stats = gate_phase("directau", data, graph, HARD_EPOCHS, BATCH, pop, "dense",
                           profile=dtype == "bfloat16")
        check_gate(stats)
        out["train"].append(stats)
    # NCL's bucketed epoch at the hard set's (ML-100K-shaped) size: at the
    # clustered set's its 110 steps are device bound (PERF.md §5)
    graphed_check("ncl hard bucketed float32", "ncl", data, ref, BATCH)
    graphed_zoo_check("directau hard dense float32", "directau", data, graphs["float32"], BATCH)
    for label, (name, extra) in GRAPHED_ONCE_EAGER.items():
        bold = "adaptive.lr" in extra  # its BPR step draws nothing; its rate moves
        graphed_zoo_check(f"{name} {label} hard dense float32", name, data, graphs["float32"],
                          BATCH, extra=extra, draws_masks=not bold, rate_moves=bold,
                          variant=label.replace(" ", "_"))
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
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}


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
    cpu_batch = PairwiseBatch(*(t.cpu() for t in batch[:4]), batch.group)
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
    for name in ZOO_MODELS:  # each epoch profiled by graphed_zoo_check below
        stats = gate_phase(name, data, f32, ZOO_EPOCHS[name], BATCH, pop, ZOO_GATES[name],
                           plain=zoo_plain(name, config, cpu), profile=False)
        check_gate(stats)
        if name in ("selfcf", "buir") and stats["served_width"] != 2 * EMB:
            raise RuntimeError(f"{name} served tables of width {stats['served_width']}")
        out["train"].append(stats)
    for name in ZOO_MODELS:
        graphed_zoo_check(f"{name} hard dense float32", name, data, f32, BATCH)
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
    per_step = (neighbor_launches(model_name, rec.graph, n_layers)[0]
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
# S1, S2 and S1 with the head dot against their plain versions: the kernels
# sum a row's slots (or a head's columns) in slot order, the plain versions
# in their own; rtol, and an atol of this share of the plain result's
# largest entry
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


def neighbor_launches(model_name, graph, n_layers):
    """(per training step, per evaluation) launches of the segment kernels,
    P1, P2 and K7 on ``graph``: GAT's two attention layers (forward S2 with
    the logits, one launch and one more over the split rows' pieces where
    the graph's attention structure splits a row, and S1; backward S1 with
    the head dot over the transpose, S2's backward with the slope, launched
    as the forward, and two per-row sums: P2 over the views, P1 over the
    bucket rows with K7 once forward and three times backward a layer);
    GraphSAGE's L masked means (P2; the first takes no backward, its input
    being the fixed features); LightGCN's, NCL's and the square models' L
    segment matmuls both ways (P2; their evaluation forward only); GRACE's
    and G-BT's two views of two segment matmuls both ways, where the graph
    is bucketed (their evaluation on the segment view once per layer)."""
    backend = graph.backend
    if model_name == "gat":
        s2 = 2 * (1 + (attention_structure(graph).schedule[2] > 0))
        step = {"weighted_pull": 2, "weighted_pull_dot": 2, "attention_softmax": s2,
                "attention_softmax_bwd": s2}
        per_eval = {"weighted_pull": 2, "attention_softmax": s2}
        if backend == "bucketed":
            step.update(gather_sum=4, gather_rows=8)
            per_eval["gather_rows"] = 2
        else:
            step["segment_sum"] = 4
        return step, per_eval
    if model_name == "graphsage":
        return {"segment_sum": 2 * n_layers - 1}, {"segment_sum": n_layers}
    if model_name in ("grace", "gbt"):
        return {"segment_sum": 8}, {"segment_sum": 2}
    if model_name == "lightgcn" and backend == "segment":
        return {"segment_sum": 2 * n_layers}, {"segment_sum": n_layers}
    raise ValueError(f"no launch model for {model_name} on {backend}")


def check_seg(name, fn, plain):
    """A segment kernel twice (bit for bit) and against its plain version at
    SEG_TOL, each of its outputs (``fn`` returns a tensor or a tuple).
    Returns the largest absolute difference of each output."""
    def outputs(f):
        got = f()
        return got if isinstance(got, tuple) else (got,)

    got = same_bits(name, lambda: outputs(fn))
    want = outputs(plain)
    torch.cuda.synchronize()
    rtol, atol = SEG_TOL
    errs = []
    for k, (a, b) in enumerate(zip(got, want)):
        scale = b.abs().max().item()
        errs.append((a - b).abs().max().item())
        if not (scale > 0 and torch.isfinite(a).all()
                and torch.allclose(a, b, rtol=rtol, atol=atol * scale)):
            raise RuntimeError(f"{name}: output {k} disagrees with plain (max abs err {errs[-1]})")
    return errs if len(errs) > 1 else errs[0]


def s2_library(row_ptr, live, n_slots, heads):
    """The softmax-only S2's library yardstick at any head count: the live
    slots as a hybrid COO [R, S, H] (each row's slots its sparse entries,
    the heads a dense dimension), for ``torch.sparse.softmax(t, 1)`` and
    ``torch._sparse_softmax_backward_data``. Returns a function of the
    [S, H] values giving the coalesced tensor."""
    keep = torch.ones(n_slots, dtype=torch.bool, device="cuda") if live is None else live
    indices = torch.stack([slot_rows(row_ptr)[keep],
                           torch.arange(n_slots, device="cuda")[keep]])
    n_rows = row_ptr.numel() - 1
    return lambda v: torch.sparse_coo_tensor(indices, v[keep], size=(n_rows, n_slots, heads)
                                             ).coalesce()


def library_time(fn):
    """(``time_ms`` of a library yardstick, None), or (None, the reason)
    where the call fails on the card."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:200]}"
    return time_ms(fn), None


def s2_rows(label, st, n_src, heads, rng):
    """S2's two entries at one GAT structure and H heads: the fused
    forward (``attention_softmax``: the logits gathered from random
    [N, H] attention sums, the LeakyReLU, the softmax; with and without
    the dropout's scale) and backward (``attention_softmax_bwd``: the
    dropout's scale, the softmax's backward, the slope and the mask), and
    the same kernels on given logits (``segment_softmax_rows`` and its
    backward), each against its plain version and itself, timed with its
    plain version, beside the bytes it must move (each input read once:
    the work list, the slots' idx, dst and live, the [S, H] operands, and
    the distinct [N, H] rows of the logit sums; the outputs written once)
    and, for the softmax-only entries, the library call at this H
    (``s2_library``). No one PyTorch call computes the fused entries."""
    row_ptr, idx, dst, live, schedule = st.row_ptr, st.idx, st.dst, st.live, st.schedule
    n_slots = idx.numel()

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    a_src, a_dst = rand(n_src, heads, scale=2.0), rand(n_src, heads, scale=2.0)
    e, g, datt = rand(n_slots, heads, scale=2.0), rand(n_slots, heads), rand(n_slots, heads)
    keep = torch.from_numpy(((rng.random((n_slots, heads)) > 0.2) / 0.8).astype(
        np.float32)).cuda()
    args = (a_src, a_dst, idx, dst, row_ptr, live, 0.2)
    live_idx = idx if live is None else idx[live]
    live_dst = dst if live is None else dst[live]
    logit_rows = torch.unique(live_idx).numel() + torch.unique(live_dst).numel()
    work = schedule[0].numel() * 4 + schedule[1].numel() * 8
    slot = 8 + (0 if live is None else 1)  # idx, dst, live
    field = 4 * heads  # one [S, H] operand a slot
    att_p, _ = attention_softmax_plain(*args)
    att_e = segment_softmax_rows_plain(e, row_ptr, live)
    coo = s2_library(row_ptr, live, n_slots, heads)
    e_coo, g_coo = coo(e), coo(g)
    lib, lib_why = library_time(lambda: torch.sparse.softmax(e_coo, 1))
    lib_bwd = lib_bwd_why = lib_err = None
    if lib is not None:
        att_coo = torch.sparse.softmax(e_coo, 1)
        lib_err = (att_coo.values() - (att_e if live is None else att_e[live])).abs().max()
        lib_err = lib_err.item()
        lib_bwd, lib_bwd_why = library_time(lambda: torch._sparse_softmax_backward_data(
            g_coo, att_coo, 1, e_coo))
    fwd = {
        "max_abs_err": max(*check_seg(f"S2 fused {label}", lambda: attention_softmax(
            *args, schedule), lambda: attention_softmax_plain(*args)), *check_seg(
            f"S2 fused with keep {label}", lambda: attention_softmax(*args, schedule, keep),
            lambda: attention_softmax_plain(*args, keep=keep))),
        "ms": time_ms(lambda: attention_softmax(*args, schedule)),
        "with_keep_ms": time_ms(lambda: attention_softmax(*args, schedule, keep)),
        "plain_ms": time_ms(lambda: attention_softmax_plain(*args)),
        "library_ms": None,
        "bound": bytes_bound(work + n_slots * (slot + field) + logit_rows * field),
        "with_keep_bound_ms": bytes_bound(work + n_slots * (slot + 3 * field)
                                          + logit_rows * field)[0],
        "softmax_only": {
            "max_abs_err": check_seg(f"S2 {label}", lambda: segment_softmax_rows(
                e, row_ptr, live, schedule), lambda: segment_softmax_rows_plain(e, row_ptr, live)),
            "ms": time_ms(lambda: segment_softmax_rows(e, row_ptr, live, schedule)),
            "plain_ms": time_ms(lambda: segment_softmax_rows_plain(e, row_ptr, live)),
            "library_ms": lib, "library_failed": lib_why, "library_max_abs_err": lib_err,
            "bound": bytes_bound(work + n_slots * (slot - 8 + 2 * field))}}
    bwd = {
        "max_abs_err": check_seg(f"S2 fused backward {label}", lambda: attention_softmax_bwd(
            att_p, datt, *args, schedule, keep), lambda: attention_softmax_bwd_plain(
            att_p, datt, *args, keep=keep)),
        "ms": time_ms(lambda: attention_softmax_bwd(att_p, datt, *args, schedule, keep)),
        "without_keep_ms": time_ms(lambda: attention_softmax_bwd(att_p, datt, *args, schedule)),
        "plain_ms": time_ms(lambda: attention_softmax_bwd_plain(att_p, datt, *args, keep=keep)),
        "library_ms": None,
        "bound": bytes_bound(work + n_slots * (slot + 4 * field) + logit_rows * field),
        "softmax_only": {
            "max_abs_err": check_seg(f"S2 backward {label}", lambda: segment_softmax_rows_bwd(
                att_e, g, row_ptr, schedule), lambda: segment_softmax_rows_bwd_plain(
                att_e, g, row_ptr)),
            "ms": time_ms(lambda: segment_softmax_rows_bwd(att_e, g, row_ptr, schedule)),
            "plain_ms": time_ms(lambda: segment_softmax_rows_bwd_plain(att_e, g, row_ptr)),
            "library_ms": lib_bwd, "library_failed": lib_bwd_why or lib_why,
            "bound": bytes_bound(work + n_slots * 3 * field)}}
    for row in (fwd["softmax_only"], bwd["softmax_only"]):
        row["bound_ms"], row["bound_by"] = row.pop("bound")
    return {"attention_softmax": fwd, "attention_softmax_bwd": bwd}


def segment_kernel_shape(label, st, n_src, heads, s2_only=False):
    """S1, S2 (``s2_rows``) and S1 with the head dot at one GAT structure
    ``st`` (``models/gat.py::Attention``: a destination view or the bucket
    rows, with its transpose view) and H heads of EMB, on the random
    logits, weights and cotangents the attention would give them: each
    against its plain version and itself, timed with its plain version, a
    library call where one computes the same function (S1: at H = 1
    ``torch.sparse.mm`` over the weights as a CSR matrix, else
    ``torch.bmm`` over them as a batched COO [H, R, N] against the heads'
    rows laid out [H, N, D] beforehand; where the rows are the destination
    nodes, ``torch.sparse.sampled_addmm`` over the view's pattern, batched
    over the heads, for S3), and its bound from the bytes it must move,
    each input read once (the distinct source and destination rows, not
    one row a slot). The fused pull is timed beside S1 over the transpose
    alone (its weights gathered beforehand); the difference is S3's row,
    whose bound is what the fused call moves beyond S1's: the source rows
    once and the [S, H] dot written. ``s2_only``: S2's rows alone."""
    row_ptr, idx, dst, live, schedule = st.row_ptr, st.idx, st.dst, st.live, st.schedule
    n_slots, n_rows = idx.numel(), row_ptr.numel() - 1
    rng = np.random.default_rng(heads)
    out = s2_rows(label, st, n_src, heads, rng)
    if not s2_only:
        out.update(s1_rows(label, st, n_src, heads, rng))
    for row in out.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row["shape"] = [n_rows, n_slots, heads, EMB]
    return out


def s1_rows(label, st, n_src, heads, rng):
    """S1, S1 with the head dot and S3's share of it (``segment_kernel_shape``)."""
    row_ptr, idx, dst, live, schedule = st.row_ptr, st.idx, st.dst, st.live, st.schedule
    n_slots, n_rows = idx.numel(), row_ptr.numel() - 1

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    # gy: a cotangent in node space, gathered by each slot's destination node
    x, gy = rand(n_src, heads * EMB), rand(n_src, heads * EMB)
    e = rand(n_slots, heads, scale=2.0)
    att = segment_softmax_rows_plain(e, row_ptr, live)
    live_idx = idx if live is None else idx[live]
    src_rows = torch.unique(live_idx).numel()
    width = heads * EMB * 4
    out = {}
    lib_err = None
    if heads == 1:
        csr = torch.sparse_csr_tensor(row_ptr, idx.long(), att[:, 0].contiguous(),
                                      size=(n_rows, n_src))
        lib, lib_why = library_time(lambda: torch.sparse.mm(csr, x))
    else:
        hh = torch.arange(heads, device="cuda").repeat_interleave(n_slots)
        batched = torch.sparse_coo_tensor(
            torch.stack([hh, slot_rows(row_ptr).repeat(heads), idx.long().repeat(heads)]),
            att.t().reshape(-1), size=(heads, n_rows, n_src)).coalesce()
        x_h = x.view(n_src, heads, EMB).transpose(0, 1).contiguous()
        lib, lib_why = library_time(lambda: torch.bmm(batched, x_h))
        if lib is not None:
            lib_err = (torch.bmm(batched, x_h).transpose(0, 1)
                       - weighted_pull_plain(x, att, idx, row_ptr)).abs().max().item()
        del batched, x_h
    out["weighted_pull"] = {
        "max_abs_err": check_seg(f"S1 {label}", lambda: weighted_pull(x, att, idx, row_ptr,
                                                                      schedule),
                                 lambda: weighted_pull_plain(x, att, idx, row_ptr)),
        "ms": time_ms(lambda: weighted_pull(x, att, idx, row_ptr, schedule)),
        "plain_ms": time_ms(lambda: weighted_pull_plain(x, att, idx, row_ptr)),
        "library_ms": lib, "library_failed": lib_why, "library_max_abs_err": lib_err,
        "per_slot_ms": bytes_bound(n_slots * (4 + 4 * heads + width) + (n_rows + 1) * 8
                                   + n_rows * width)[0],
        "bound": bytes_bound(n_slots * (4 + 4 * heads) + (n_rows + 1) * 8 + src_rows * width
                             + n_rows * width)}
    # the backward's pull over the transpose view: alone (weights gathered
    # beforehand, as the backward did before the fold), then with the dot
    t_row_ptr, t_idx, fpos, t_node, t_schedule = (st.t_row_ptr, st.t_idx, st.t_fpos, st.t_node,
                                                  st.t_schedule)
    t_slots, t_rows = t_idx.numel(), t_row_ptr.numel() - 1
    t_live = fpos >= 0
    wt = torch.where(t_live[:, None], att[fpos.long().clamp(min=0)],
                     torch.zeros((), device="cuda")).contiguous()
    t_nodes = slot_rows(t_row_ptr)
    if t_node is not None:
        t_nodes = t_node.long()[t_nodes]
    s1t_bytes = (t_slots * (4 + 4 * heads) + (t_rows + 1) * 8
                 + torch.unique(t_idx[t_live]).numel() * width + t_rows * width)
    dot_bytes = torch.unique(t_nodes[t_live]).numel() * width + n_slots * heads * 4
    s1t_ms = time_ms(lambda: weighted_pull(gy, wt, t_idx, t_row_ptr, t_schedule))

    def fused():
        return weighted_pull_dot(gy, att, t_idx, t_row_ptr, fpos, x, t_node, t_schedule)

    dh_err, dot_err = check_seg(
        f"S1 with the head dot {label}", fused,
        lambda: weighted_pull_dot_plain(gy, att, t_idx, t_row_ptr, fpos, x, t_node))
    reached = torch.zeros(n_slots, dtype=torch.bool, device="cuda")
    reached[fpos[t_live].long()] = True
    if int(t_live.sum()) != int(reached.sum()) or fused()[1][~reached].any():
        raise RuntimeError(f"S1 with the head dot {label}: the live slots do not map one to "
                           f"one, or a forward slot no live slot reaches is not 0")
    fused_ms = time_ms(fused)
    out["weighted_pull_dot"] = {
        "max_abs_err": max(dh_err, dot_err), "dh_max_abs_err": dh_err,
        "dot_max_abs_err": dot_err, "ms": fused_ms,
        "plain_ms": time_ms(lambda: weighted_pull_dot_plain(gy, att, t_idx, t_row_ptr, fpos, x,
                                                            t_node)),
        "library_ms": None, "s1_transpose_ms": s1t_ms,
        "s1_transpose_bound_ms": bytes_bound(s1t_bytes)[0],
        "bound": bytes_bound(s1t_bytes + dot_bytes)}
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
        "max_abs_err": dot_err, "ms": fused_ms - s1t_ms,
        "plain_ms": time_ms(lambda: segment_dot_plain(gy, dst, x, idx, heads)),
        "library_ms": lib, "library_max_abs_err": lib_err,
        "fused_into": "weighted_pull_dot", "bound": bytes_bound(dot_bytes)}
    return out


def segment_kernel_shapes(label, graph):
    """``segment_kernel_shape`` at H = 4 and 1, and S2's rows at H = 3, on
    the graph's GAT structure (``attention_structure``): on the bucketed
    backend the bucket rows of ``norm_adj.pull`` and ``pull_t`` (dead slots
    masked), else the views of ``bidirectional_edges``."""
    st = attention_structure(graph)
    return {f"{label}_h{h}": segment_kernel_shape(f"{label} H={h}", st, graph.n_nodes, h,
                                                  s2_only=h == 3)
            for h in (4, 3, 1)}


def segment_view_pull(graph):
    """P2 over the segment backend's row-sorted view of ``norm_adj`` (one
    LightGCN layer, d = EMB, the values in slot order) against its plain
    version at P1_TOL, itself and P1 over the same view bit for bit; P2,
    P1, the plain version and one layer of ``torch.sparse.mm`` timed beside
    the bytes bound."""
    adj = graph.norm_adj
    seg = adj.seg
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(adj.n_cols, EMB)).astype(
        np.float32)).cuda()
    val = adj.vals[seg.perm]
    got = segment_sum(x, seg, val)
    again = segment_sum(x, seg, val)
    p1 = gather_sum(x, seg.idx, seg.row_ptr, val=val, schedule=seg.schedule)
    want = gather_sum_plain(x, seg.idx, seg.row_ptr, val=val)
    torch.cuda.synchronize()
    rtol, atol = P1_TOL
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not (torch.equal(got, again) and torch.equal(got, p1)):
        raise RuntimeError("segment_sum over the view: two calls differ, or differ from P1's")
    if not (scale > 0 and torch.isfinite(got).all()
            and torch.allclose(got, want, rtol=rtol, atol=atol * scale)):
        raise RuntimeError(f"segment_sum over the view disagrees with plain (max abs err {err})")
    a_csr = torch.sparse_csr_tensor(seg.row_ptr, seg.idx.long(), val, size=adj.shape)
    live = seg.idx[val != 0]
    bound = bytes_bound(seg.n_slots * 8 + seg.row_ptr.numel() * 8
                        + torch.unique(live).numel() * EMB * 4 + adj.n_rows * EMB * 4)
    return {"shape": [adj.n_rows, seg.n_slots, EMB], "max_abs_err": err, "max_abs": scale,
            "equals_p1": True, "items": int(seg.sums[0].shape[0]),
            "ms": time_ms(lambda: segment_sum(x, seg, val)),
            "p1_ms": time_ms(lambda: gather_sum(x, seg.idx, seg.row_ptr, val=val,
                                                schedule=seg.schedule)),
            "plain_ms": time_ms(lambda: gather_sum_plain(x, seg.idx, seg.row_ptr, val=val)),
            "library_ms": time_ms(lambda: torch.sparse.mm(a_csr, x)),
            "bound_ms": bound[0], "bound_by": bound[1]}


class PlainSegmentLightGCN(LightGCN):
    """LightGCN on the segment backend with the plain segment matmul
    (autograd through torch ops): the reference a step is held against."""

    def propagate(self, params, graph):
        with spmm.plain_products():
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


def neighbor_one_step(name, graph, batch_size, overrides=None):
    """One step of GAT or GraphSAGE at its defaults (but for ``overrides``
    of the config) through the segment kernels, P1 (and K7) against its
    plain path (``PlainGAT``, ``PlainGraphSAGE``) on the same draws:
    GraphSAGE's in f32; GAT's in float64, its gradients by relative
    Frobenius error (GAT_FRO_TOL), with the plain path's own f32 error
    beside it."""
    config = default_config(**{"embedding.size": EMB, **(overrides or {})})
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
        neighbor_launches(name, graph, getattr(model, "n_layers", None))[0],
        frozen=model.frozen, **tol)
    return {**out, **extra, **(overrides or {})}


# GAT's shapes past the kernels' old limits, on the hard set: a head count
# that does not divide 32, and a head of 1024 f32 (past one column pass of
# the fused pull)
GAT_WIDE = {"gat_heads3": {"GAT.num_heads": 3}, "gat_hidden1024": {"GAT.hidden": 1024}}


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
        neighbor_launches("lightgcn", graph, model.n_layers)[0])


def selfloop_one_step(name, graph):
    """One GRACE or G-BT step where the graph is bucketed (its
    ``norm_adj_selfloops`` on the segment backend: P2 both ways) against
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
        with spmm.plain_products():
            return zoo_loss(model, p, {}, batch, graph)

    tol = {"fro_tol": ZOO_CPU_TOL.get(name, ZOO_CPU_TOL_DEFAULT),
           "zero_grads": ZERO_GRADS.get(name, ())}
    return step_against_plain(f"{name} step bucketed (segment self-loops)",
                              (lambda p: zoo_loss(model, p, {}, batch, graph), params),
                              (plain_loss, params), torch.float32,
                              neighbor_launches(name, graph, None)[0], **tol)


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
    for key, overrides in GAT_WIDE.items():
        out["one_step"][key] = neighbor_one_step("gat", f32, BATCH, overrides)
    for name in NEIGHBOR_MODELS:
        out["one_step"][name] = neighbor_one_step(name, f32, BATCH)
        plain = NEIGHBOR_PLAIN[name](config)
        stats = gate_phase(name, data, f32, NEIGHBOR_EPOCHS[name], BATCH, pop,
                           NEIGHBOR_GATES[name],
                           plain=lambda rec, m=plain: m.eval_embeddings(rec.params, rec.state,
                                                                       rec.graph),
                           profile=False)  # its epoch profiled by graphed_zoo_check below
        check_gate(stats)
        out["train"].append(stats)
        graphed_zoo_check(f"{name} hard dense float32", name, data, f32, BATCH)
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
    kernels at its bucket tables; GAT (S1, S2 and P1 over the bucket rows, K7)
    and GraphSAGE (P2 over the graph's cached views) one step against their
    plain paths, then PROFILE_STEPS profiled steps each; then LightGCN on a
    segment graph of the same data (P2 over a 2M-slot view): P2 over its
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
    graphed_check("lightgcn clustered segment float32", "lightgcn", data, seg, LARGE_BATCH)
    del seg
    torch.cuda.empty_cache()
    return out


SEGMENT_SOURCES = {
    "weighted_pull": "recommendation_tpu/models/gat.py:59 (XLA's segment_sum, not a TPU kernel)",
    "weighted_pull_dot": "recommendation_tpu/models/gat.py:191 (the custom VJP's transpose pull, "
                         "XLA, with the gather-dot of :157 folded in; not a TPU kernel)",
    "attention_softmax": "recommendation_tpu/models/gat.py:44-52 (the logits, XLA's segment_max "
                         "and segment_sum; not a TPU kernel)",
    "attention_softmax_bwd": "recommendation_tpu/models/gat.py:162-165 (the custom VJP's "
                             "softmax backward, slope and mask, XLA; not a TPU kernel)",
    "segment_dot": "recommendation_tpu/models/gat.py:157 (the custom VJP's gather-dot, XLA; "
                   "not a TPU kernel)",
}


def segment_kernel_rows(hard, clustered, card):
    """The kernels line's rows of S1, S1 with the head dot, S2 (forward,
    backward: the fused entries, with the softmax-only ones beside them)
    and S3: the clustered bucket tables at H = 4 (GAT's first layer there)
    as the row's figures, every other measured shape beside them;
    launches from the neighbour models' runs (the hard set's trained
    GraphSAGE and GAT, the clustered GAT's profiled steps). S3 runs inside
    S1's transpose pull: its row's time is the fused call's less S1's
    alone, its launches the fused call's."""
    shapes = {**clustered["kernels"], **hard["kernels"]}
    rows = []
    for name, src in SEGMENT_SOURCES.items():
        main = shapes["clustered_h4"][name]
        counter = main.get("fused_into", name)
        row = {"name": name, "route": "cuda", "source": "recommendation_tpu_torch/csrc/segment.cu",
               "replaces": src, "timed": "clustered bucket rows, H=4, d=64", "launches": 0,
               **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape") if k in main},
               "shapes": {label: s[name] for label, s in shapes.items()
                          if label != "clustered_h4" and name in s}, "card": card}
        if "softmax_only" in main:
            row["softmax_only"] = main["softmax_only"]
        if counter != name:
            row["fused_into"] = f"{counter} (S1's transpose pull, PR 10)"
            row["launches_of"] = counter
        row["max_abs_err"] = max(s[name]["max_abs_err"] for s in shapes.values() if name in s)
        for run in hard["train"]:
            n = run["launches"].get(counter, 0)
            if n:
                row["launches"] += n
                row[f"launches_hard_{run['model']}"] = n
        n = clustered["gat"]["profile"]["kernel_launches"].get(counter, 0)
        row["launches"] += n
        row["launches_clustered_gat_profile"] = n
        rows.append(row)
    return rows


def add_neighbor_launches(k7_row, p1_row, p2_row, hard, clustered):
    """P1's, P2's and K7's launches on the neighbour phases' main paths into
    their rows: the hard set's GraphSAGE, GAT and segment LightGCN runs,
    the profiled GRACE and G-BT steps on the bucketed graph, the clustered
    GAT, GraphSAGE and segment LightGCN profiles."""
    runs = {f"hard_{r['model']}": r["launches"] for r in hard["train"]}
    runs["hard_lightgcn_segment"] = hard["lightgcn_backends"]["runs"][1]["launches"]
    for name in ("grace", "gbt"):
        runs[f"hard_{name}_bucketed"] = hard[f"{name}_bucketed_profile"]["kernel_launches"]
    for name in ("gat", "graphsage"):
        runs[f"clustered_{name}"] = clustered[name]["profile"]["kernel_launches"]
    runs["clustered_lightgcn_segment"] = clustered["lightgcn_segment"]["profile"][
        "kernel_launches"]
    for row in (k7_row, p1_row, p2_row):
        for label, launches in runs.items():
            n = launches.get(row["name"], 0)
            if n:
                row["launches"] += n
                row[f"launches_{label}"] = n


def segment_sum_row(clustered, card):
    """The kernels line's row of P2: its check and times over the clustered
    segment view (``segment_view_pull``), P1's time over the same view
    beside them; launches added by the phases that run it."""
    view = dict(clustered["segment_view_pull"])
    return {"name": "segment_sum", "route": "cuda",
            "source": "recommendation_tpu_torch/csrc/segment_sum.cu",
            "replaces": "recommendation_tpu/ops/spmm.py:34-50 (XLA's segment_sum over the "
                        "row-sorted view, not a TPU kernel)",
            "timed": "clustered segment view, d=64, with values", "launches": 0,
            **{k: view.pop(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            "library": "torch.sparse.mm, CSR [N, N] x [N, 64] f32", "view": view, "card": card}

# -- the social models: DiffNet, SEPT, SEPT-basic, MHCN, ESRF ---------------------------

# the models behind the social names (``sept_social`` is SEPT by another name)
SOCIAL_TRAINED = ("diffnet", "sept", "sept_basic", "mhcn", "esrf")
# an epoch past SEPT's warm-up and in ESRF's adversarial third at the
# default max.epoch 30: the state the steps are checked and profiled in
LATE_EPOCH = 29
# parameters whose exact gradient is 0: MHCN's fourth supervised gate's
# bias, which no channel's MIM loss uses (its L2 norm at 0 has gradient 0)
SOCIAL_ZERO_GRADS = {"mhcn": ("sgating_b.3",)}
# the social steps' f32 gradients are ill-conditioned: MHCN's MIM loss sums
# -log σ over every user of three channels, ESRF's generator a gumbel
# softmax at temperature 0.2 over [100, K, U]; their gradients moved by up
# to 3.8e-6 and 1.1e-6 of their largest entry between two f32 summation
# orders (P1's and the plain COO product's, a CPU rehearsal at 200 users).
# So every social step is held to the plain path in float64 by relative
# Frobenius error at GAT_FRO_TOL, as GAT's is


def social_launches(model_name, backend, n_layers, n_layers_g=2, phase=2):
    """(per training step, per evaluation) launches of P1 and K7 of a social
    model on a bucketed graph (P2 on a segment graph, whose products run
    over the row-sorted views): each ``adj_matmul`` launches them once
    forward and once more backward where a gradient flows through it.
    DiffNet: L products over the trust matrix and one over R̂; SEPT: L over
    each of its four views (rec, edge-dropped, friend, sharing); SEPT-basic:
    L over the edge-dropped view; MHCN: five a layer (three channels, Rᵀ,
    R̂) and one a channel in the MIM loss; ESRF: L over ``norm_adj`` in
    phase 0, the generator's ``n_layers_g`` over the motif matrix in phase
    1 (under no_grad: forward only) and phase 2 (both ways); its social
    discriminator's layers are dense products. An evaluation runs the
    forward of each model's rec view: L products (DiffNet L + 1, MHCN 5L)."""
    L = n_layers
    if model_name == "esrf":
        fwd, bwd = ((L, L), (n_layers_g, 0), (n_layers_g, n_layers_g))[phase]
        per_eval = L
    else:
        fwd, per_eval = {"diffnet": (L + 1, L + 1), "sept": (4 * L, L),
                         "sept_social": (4 * L, L), "sept_basic": (L, L),
                         "mhcn": (5 * L + 3, 5 * L)}[model_name]
        bwd = fwd
    if backend != "bucketed":
        return {"segment_sum": fwd + bwd}, {"segment_sum": per_eval}
    return ({"gather_sum": fwd + bwd, "gather_rows": fwd + bwd},
            {"gather_sum": per_eval, "gather_rows": per_eval})


def model_launches(model, backend, phase=2):
    return social_launches(model.name, backend, model.n_layers,
                           getattr(model, "n_layers_g", 2), phase)


def social_build():
    """The hard set with its synthesized trust triples (``synthesize_social``),
    a ``SocialDeviceGraph`` on each of the dense, bucketed and segment
    backends: the trust edges, each social matrix's stored entries and
    bucket slots, the host seconds of the synthesis, of the motif algebra
    alone, and of each graph beside the plain ``DeviceGraph``'s."""
    train, test = make_hard_dataset()
    data = Interaction(train, test)
    t0 = time.perf_counter()
    triples = synthesize_social(data)
    t1 = time.perf_counter()
    relation = Relation(triples, data.user)
    S, Y = relation.get_social_mat(), data.interaction_mat
    mhcn_hypergraph_channels(S, Y)
    esrf_motif_adjacency(S, Y)
    sept_social_views(relation.get_bidirectional_social_mat(), Y)
    t2 = time.perf_counter()
    graphs, build_s = {}, {}
    for backend in ("dense", "bucketed", "segment"):
        t = time.perf_counter()
        DeviceGraph(data, backend=backend, device="cuda")
        torch.cuda.synchronize()
        t_base = time.perf_counter()
        graphs[backend] = SocialDeviceGraph(data, triples, backend=backend, device="cuda")
        torch.cuda.synchronize()
        build_s[backend] = {"device_graph_s": t_base - t,
                            "social_device_graph_s": time.perf_counter() - t_base}
    bucketed = graphs["bucketed"]
    info = {"users": data.user_num, "items": data.item_num, "train_edges": len(data.edge_users),
            "trust_edges": len(triples), "relations": relation.size()[1],
            "synthesize_s": t1 - t0, "motif_host_s": t2 - t1, "build_s": build_s,
            "nnz": bucketed.social_nnz,
            "bucket_slots": {name: [getattr(bucketed, name).pull.n_slots,
                                    getattr(bucketed, name).pull_t.n_slots]
                             for name in SOCIAL_MATRICES}}
    print(f"social graph: {json.dumps(info)}")
    return data, triples, graphs, info


def late_state(model, params, state, graph):
    """The state at LATE_EPOCH: SEPT with SSL on and an edge mask, SEPT-basic
    with an edge mask, ESRF in phase 2."""
    return model.epoch_begin(params, state, graph, torch.Generator().manual_seed(9), LATE_EPOCH)


def social_one_step(name, graph, batch):
    """One step of a social model at its defaults in its late state, through
    P1 and K7 (bucketed) or P1 (segment), against the same step with the
    plain COO product for every ``adj_matmul`` (``spmm.plain_products``) in
    float64 on the same batch and draws, by relative Frobenius error
    (GAT_FRO_TOL), the plain path's own f32 error beside it."""
    model = build(name, default_config(**{"embedding.size": EMB}))
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    state = late_state(model, params, state, graph)

    def plain(p):
        with spmm.plain_products():
            return zoo_loss(model, p, state, batch, graph)

    grads = []
    for dtype in (torch.float32, torch.float64):
        p = {k: v.detach().to(dtype).requires_grad_() for k, v in params.items()}
        grads.append(dict(zip(p, torch.autograd.grad(plain(p), list(p.values())))))
    live = [k for k in grads[1] if grads[1][k].abs().max() > 0]
    own = max((torch.linalg.norm(grads[0][k].double() - grads[1][k])
               / torch.linalg.norm(grads[1][k])).item() for k in live)
    out = step_against_plain(
        f"{name} step {graph.backend}", (lambda p: zoo_loss(model, p, state, batch, graph), params),
        (plain, {k: v.double() for k, v in params.items()}), torch.float32,
        model_launches(model, graph.backend)[0], fro_tol=GAT_FRO_TOL,
        zero_grads=SOCIAL_ZERO_GRADS.get(name, ()))
    return {**out, "reference": "plain float64", "plain_f32_rel_err": own}


@contextlib.contextmanager
def record_phases(seen):
    """Each epoch's phase as the trainer begins it: ESRF's phase, SEPT's SSL
    flag (one host read an epoch)."""
    esrf, sept = ESRF.epoch_begin, SEPT.epoch_begin

    def esrf_begin(self, *args):
        state = esrf(self, *args)
        seen.append(state["phase"])
        return state

    def sept_begin(self, *args):
        state = sept(self, *args)
        seen.append(int(state["ssl_on"].item()))
        return state

    ESRF.epoch_begin, SEPT.epoch_begin = esrf_begin, sept_begin
    try:
        yield
    finally:
        ESRF.epoch_begin, SEPT.epoch_begin = esrf, sept


def plain_tables(rec):
    """A recommender's eval tables through ``adj_matmul``'s plain versions,
    on its graph."""
    with spmm.plain_products():
        return rec.model.eval_embeddings(rec.params, rec.state, rec.graph)


def social_train(name, data, graph, pop, plain):
    """A social model trained SOCIAL_EPOCHS on ``graph`` and held to its
    SOCIAL_GATES gate; ESRF must walk phases 0, 1 and 2 and SEPT reach its
    SSL phase, each phase's loss falling."""
    seen = []
    with record_phases(seen):
        # the epochs are profiled replayed on the bucketed graph (graphed_zoo_check)
        stats = gate_phase(name, data, graph, SOCIAL_EPOCHS[name], BATCH, pop, SOCIAL_GATES[name],
                           plain=plain, profile=False)
    if name in ("esrf", "sept"):
        stats["phases"] = seen
        want = {0, 1, 2} if name == "esrf" else {0, 1}
        if set(seen) != want:
            raise RuntimeError(f"{name} saw phases {seen}, not each of {sorted(want)}")
    check_gate(stats)
    return stats


def social_serve(rec, data, triples, train, test):
    """DiffNet served through ``cli.build_service`` from its trained
    parameters saved as ``.npz``, on the bucketed backend (the eval tables
    through P1 and K7: L + 1 launches each) and on the dense one: each
    service's answers for 64 test users against the plain path's on its
    graph, and the two services against each other."""
    uids = data.test_user_ids()[:64].tolist()
    out, answers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/diffnet.npz"
        save_params(ckpt, rec.params)
        for backend in ("bucketed", "dense"):
            config = default_config(**{"embedding.size": EMB, "graph.backend": backend})
            reset_counts()
            service = build_service("diffnet", ckpt, config, train, test, device="cuda",
                                    social=triples)
            scores, ids = service.recommend_ids(uids, K)
            torch.cuda.synchronize()
            launches = {k: v for k, v in all_counts().items() if v}
            model = build("diffnet", config)
            want = (model_launches(model, backend)[1] if backend == "bucketed" else {})
            if launches != want:
                raise RuntimeError(f"DiffNet served on {backend}: launches {launches}, "
                                   f"expected {want}")
            with spmm.plain_products():
                plain_u, plain_i = model.eval_embeddings(load_params(ckpt, "diffnet", service.graph.device), {},
                                                         service.graph)
            tol = score_tolerance(service.user_emb, service.item_emb, plain_u, plain_i)
            s_plain, i_plain = RecommenderService(plain_u, plain_i, data,
                                                  service.graph).recommend_ids(uids, K)
            if not (np.isfinite(scores).all() and topk_agree(scores, ids, s_plain, i_plain, tol)):
                raise RuntimeError(f"DiffNet served on {backend}: answers differ from the "
                                   "plain path's")
            answers[backend] = (scores, ids, service)
            out[backend] = {"launches": launches, "score_tol": tol, "served_users": len(uids)}
    (s_b, i_b, sv_b), (s_d, i_d, sv_d) = answers["bucketed"], answers["dense"]
    tol = score_tolerance(sv_b.user_emb, sv_b.item_emb, sv_d.user_emb, sv_d.item_emb)
    if not topk_agree(s_b, i_b, s_d, i_d, tol):
        raise RuntimeError("DiffNet's bucketed and dense services disagree")
    out["backends_score_tol"] = tol
    return out


def social_phase(card):
    """The social models on the hard set with its synthesized trust triples
    (d=64, B=2048, Adam 1e-3, f32): the graphs on three backends; one step
    of each model on the bucketed and the segment graph against the plain
    path; each trained on the dense graph to its SOCIAL_GATES gate at
    SOCIAL_EPOCHS (the served answers against the port's on the CPU), and
    DiffNet on the bucketed graph too (against the plain path); the six
    models' replayed epochs on the bucketed graph (``graphed_zoo_check``:
    launches, profile); DiffNet served from an ``.npz`` through
    ``build_service``."""
    seconds, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        seconds[name], t = time.perf_counter() - t, time.perf_counter()

    data, triples, graphs, info = social_build()
    dense, bucketed, segment = graphs["dense"], graphs["bucketed"], graphs["segment"]
    cpu = SocialDeviceGraph(data, triples, backend="dense", device="cpu")
    out = {"build": info, "one_step": {}, "train": [], "card": card, "seconds": seconds}
    lap("build")
    batch = first_batch(dense, BATCH)
    for name in SOCIAL_TRAINED:
        for graph in (bucketed, segment):
            out["one_step"][f"{name}_{graph.backend}"] = social_one_step(name, graph, batch)
    lap("one_step")
    pop = {"masked": popularity_recall(data, dense, 20),
           "plain": popularity_recall(data, dense, 20, masked=False)}
    config = default_config(**{"embedding.size": EMB})
    for name in SOCIAL_TRAINED:
        out["train"].append(social_train(name, data, dense, pop, zoo_plain(name, config, cpu)))
    stats = social_train("diffnet", data, bucketed, pop, plain_tables)
    out["train"].append(stats)
    for run in out["train"]:
        run["card"] = card
    lap("train")
    for name in SOCIAL_MODELS:
        graphed_zoo_check(f"{name} hard bucketed float32", name, data, bucketed, BATCH)
    lap("graphed")
    rec = GraphRecommender(build("diffnet", config), data, config, graph=bucketed,
                           log=Log(echo=False), device="cuda")
    rec.build()
    out["serve"] = social_serve(rec, data, triples, data.training_data, data.test_data)
    lap("serve")
    return out


def add_social_launches(k7_row, p1_row, social):
    """P1's and K7's launches on the social phase's main paths into their
    rows: DiffNet's bucketed training run and its bucketed service (the
    models' replayed epochs on the bucketed graph: ``add_graphed_launches``)."""
    bucketed = [r for r in social["train"] if r["backend"] == "bucketed"][0]
    runs = {"hard_social_diffnet_train": bucketed["launches"]}
    runs["hard_social_diffnet_serve"] = social["serve"]["bucketed"]["launches"]
    for row in (k7_row, p1_row):
        for label, launches in runs.items():
            n = launches.get(row["name"], 0)
            if n:
                row["launches"] += n
                row[f"launches_{label}"] = n


# -- int8 propagation (Q1, P1's int8 source), the native builder, the tuner,
# -- the rating, probe and profiling modules --------------------------------------

# int8 packs where the packed row keeps 64 f32 words (d >= 249,
# graph/bucketed.py::packer): the widths of the tuning presets' grids
# (tune/presets.py EMBS) where it is live; 250 gives code rows with padding
INT8_D, INT8_PAD_D, INT8_NARROW_D = 256, 250, 64
# LightGCN at INT8_D on the clustered set, f32 and int8 on the same batches:
# the fewest epochs that clear the masked popularity list by a third in
# both (a 14-epoch run on the H100: Recall@20 0.0289, 0.0318, 0.0371,
# 0.0435 after epochs 1-4 in f32 and int8 alike, against 0.02847; PERF.md §4)
INT8_EPOCHS = 4
# the int8 step against the plain chain with the same int8 numerics: the
# two round a layer's sums in another order, so a later layer's code that
# sits at a tie flips by one quantum in one of them (tests/test_torch_int8.py
# bounds this per element on the CPU); here the gradients are held by their
# relative Frobenius error, a bound that rejects zeros
INT8_FRO_TOL = 1e-4
# int8 propagation's cost in quality: LightGCN's Recall@20 at INT8_D after
# INT8_EPOCHS within this of f32's on the same batches (0.00021 on the H100,
# PERF.md §6)
INT8_RECALL_GAP = 0.002
TUNE_GRID = ("embedding.size=64,128", "learning.rate=1e-3,5e-3")
TUNE_BAD_RATE = "-1"  # torch.optim.Adam refuses it: those configurations must fail alone


def check_quantize(name, x, pre=None):
    """Q1 against its plain version bit for bit (codes, scales, the padding
    codes 0), and a second call against the first."""
    codes, scale = quantize_rows(x, pre)
    again = quantize_rows(x, pre)
    want = quantize_rows_plain(x, pre)
    torch.cuda.synchronize()
    table = torch.as_strided(codes, (codes.shape[0], codes.stride(0)), (codes.stride(0), 1))
    if not (torch.equal(codes, want[0]) and torch.equal(scale, want[1])
            and torch.equal(codes, again[0]) and torch.equal(scale, again[1])
            and not table[:, x.shape[1]:].any()):
        raise RuntimeError(f"quantize_rows {name}: differs from its plain version")
    return codes, scale


# the int8 chain's fused layer: (running sum read, next codes written)
FUSED_LAYERS = {"first": (False, True), "middle": (True, True), "last": (True, False)}


def check_fused(name, codes, scale, fwd, acc, requant):
    """The int8 chain's fused layer (P1's int8 epilogue) on the separable
    row-space tables against P1, Q1 and an add in three launches, bit for
    bit, twice; its running sum against the plain version at P1_TOL (the
    codes of the plain sums may flip at a tie, so they are not compared)."""
    kw = dict(post=fwd.sep_dst, skip=fwd.total_rows, schedule=fwd.schedule, scale=scale,
              acc=acc)
    more = dict(requant=True, pre=fwd.sep_src_row) if requant else {}
    fused = [gather_sum(codes, fwd.ridx, fwd.row_ptr, **kw, **more) for _ in range(2)]
    y = gather_sum(codes, fwd.ridx, fwd.row_ptr, **{**kw, "acc": None})
    three = (y if acc is None else acc + y,
             *(quantize_rows(y, fwd.sep_src_row) if requant else ()))
    plain = gather_sum_plain(codes, fwd.ridx, fwd.row_ptr, **kw, **more)
    torch.cuda.synchronize()
    fused = [(t,) if isinstance(t, torch.Tensor) else t for t in fused]
    want = plain[0] if requant else plain
    if not all(len(f) == len(three) and all(torch.equal(a, b) for a, b in zip(f, three))
               for f in fused):
        raise RuntimeError(f"fused int8 layer {name}: differs from its three launches")
    got = fused[0][0]
    rtol, atol = P1_TOL
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and torch.allclose(
            got, want, rtol=rtol, atol=atol * want.abs().max().item())):
        raise RuntimeError(f"fused int8 layer {name}: disagrees with plain (max abs err {err})")
    return {"max_abs_err": err, "max_abs": want.abs().max().item()}


def kernel_registers(source, kernel):
    """ptxas's registers and spills of each instantiation of ``kernel`` in
    this run's build of ``csrc/<source>.cu``, by its mangled template
    arguments (empty where the library was built before)."""
    out, fn = {}, ""
    for line in kernels.build_logs.get(source, "").splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif kernel in fn and ("registers" in line or "spill" in line):
            key = fn.split(kernel, 1)[1].split("EEv", 1)[0].lstrip("I")
            out[key] = (out.get(key, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def q1_bound(n, d, pre=True):
    """Q1: the rows (and pre) read once, the padded code rows and the
    scales written once."""
    return bytes_bound(n * d * 4 + n * 4 * pre + n * padded_width(d) + n * 4)


def int8_kernel_phase(data, graph):
    """Q1 and P1 with an int8 source against their plain versions at the
    clustered bucket tables (d = 256 and 250), twice bit for bit, and the
    fused layer against its three launches; int8 below d = 249 is f32 (no
    Q1); Q1 and P1 at d = 256 for f32, bf16 and int8, and the fused layer
    (first, middle, last) beside the three launches, timed beside their
    bounds and ``torch.sparse.mm``. Returns the Q1, P1-int8 and fused
    rows."""
    adj = graph.norm_adj
    fwd = adj.pull
    r = fwd.total_rows
    ridx, ptr, sched, post = fwd.ridx, fwd.row_ptr, fwd.schedule, fwd.sep_dst
    rng = np.random.default_rng(21)
    variants, fused_checks, inputs = {}, {}, {}
    for d in (INT8_D, INT8_PAD_D):
        x = torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32) * 0.05).cuda()
        x[r] = 0.0
        xn = torch.from_numpy(rng.normal(size=(fwd.n_cols, d)).astype(np.float32) * 0.05).cuda()
        codes, scale = check_quantize(f"separable source d={d}", x, fwd.sep_src_row)
        codes_n, scale_n = check_quantize(f"node rows d={d}", xn)
        if not torch.all(codes[r] == 0):
            raise RuntimeError("quantize_rows: the zero row's codes are not 0")
        variants[f"separable, row space, d={d}"] = check_pull(
            f"int8 separable d={d}", codes, ridx, ptr, post=post, skip=r, schedule=sched,
            scale=scale)
        variants[f"values, node space, d={d}"] = check_pull(
            f"int8 node d={d}", codes_n, fwd.idx, ptr, val=fwd.val, schedule=sched, scale=scale_n)
        acc = torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32) * 0.05).cuda()
        for layer, (with_acc, requant) in FUSED_LAYERS.items():
            fused_checks[f"{layer} layer, d={d}"] = check_fused(
                f"{layer} d={d}", codes, scale, fwd, acc if with_acc else None, requant)
        inputs[d] = (x, xn, codes, scale, acc)
    # below d = 249 int8 does not pack: the f32 path, bit for bit, and no Q1
    x64 = torch.from_numpy(rng.normal(size=(fwd.n_cols, INT8_NARROW_D)).astype(np.float32)).cuda()
    before = quantize_rows.launches
    narrow_same = (torch.equal(pull(fwd, x64, "int8"), pull(fwd, x64, "float32"))
                   and torch.equal(bucketed_chain_mean(LAYERS, "int8", fwd, adj.pull_t, x64),
                                   bucketed_chain_mean(LAYERS, "float32", fwd, adj.pull_t, x64)))
    torch.cuda.synchronize()
    if not narrow_same or quantize_rows.launches != before:
        raise RuntimeError(f"int8 at d={INT8_NARROW_D} is not the f32 path")
    x, xn, codes, scale, acc = inputs[INT8_D]
    pre = fwd.sep_src_row
    a = data.norm_adj.tocsr()
    a_csr = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                    torch.from_numpy(a.indices.astype(np.int64)),
                                    torch.from_numpy(a.data.astype(np.float32)),
                                    size=a.shape).cuda()
    library_ms = time_ms(lambda: torch.sparse.mm(a_csr, xn))
    q1_b = q1_bound(r + 1, INT8_D)
    q1 = {
        "name": "quantize_rows", "route": "cuda",
        "source": "recommendation_tpu_torch/csrc/gather.cu",
        "replaces": "recommendation_tpu/graph/bucketed.py:507 (XLA's _pack_int8_rows with "
                    ":591's source scaling; not a TPU kernel)",
        "shape": [r + 1, INT8_D], "timed": "the int8 chain's separable source, with pre",
        "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(lambda: quantize_rows(x, pre)),
        "plain_ms": time_ms(lambda: quantize_rows_plain(x, pre)),
        "bound_ms": q1_b[0], "bound_by": q1_b[1], "library_ms": None,
        "d250_ms": time_ms(lambda: quantize_rows(inputs[INT8_PAD_D][0], pre)),
        "d250_bound_ms": q1_bound(r + 1, INT8_PAD_D)[0],
    }
    p1_b = pull_bound(fwd, INT8_D, 1, row_bytes=padded_width(INT8_D) + 4)
    xb = x.bfloat16()
    p1 = {
        "name": "gather_sum_int8", "route": "cuda",
        "source": "recommendation_tpu_torch/csrc/gather.cu",
        "replaces": "recommendation_tpu/graph/bucketed.py:594 (XLA's int8 bucket pull, "
                    "pull_rowspace :563-607; not a TPU kernel)",
        "shape": [r, fwd.n_slots, INT8_D], "timed": "one separable int8 layer of the chain",
        "launches": 0, "variants": variants,
        "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
        "ms": time_ms(lambda: gather_sum(codes, ridx, ptr, post=post, skip=r, schedule=sched,
                                         scale=scale)),
        "plain_ms": time_ms(lambda: gather_sum_plain(codes, ridx, ptr, post=post, scale=scale)),
        "bound_ms": p1_b[0], "bound_by": p1_b[1], "library_ms": library_ms,
        "library": "torch.sparse.mm, CSR [N, N] x [N, 256] f32",
        "registers": kernel_registers("gather", "gather_sum_i8_kernel"),
    }

    def layer(with_acc, requant, fn=gather_sum):
        return fn(codes, ridx, ptr, post=post, skip=r, schedule=sched, scale=scale,
                  acc=acc if with_acc else None,
                  **(dict(requant=True, pre=pre) if requant else {}))

    def three_launches(with_acc, requant):
        y = layer(False, False)
        return (y if not with_acc else acc + y), (quantize_rows(y, pre) if requant else None)

    def three_bound(with_acc, requant):  # P1-int8, Q1 on its output, the add's 3 rows
        return (p1_b[0] + requant * q1_bound(r + 1, INT8_D)[0]
                + with_acc * bytes_bound(3 * (r + 1) * INT8_D * 4)[0])

    fused_ms = {k: time_ms(lambda a=a, q=q: layer(a, q)) for k, (a, q) in FUSED_LAYERS.items()}
    fused_b = {k: fused_bound(fwd, INT8_D, a, q)[0] for k, (a, q) in FUSED_LAYERS.items()}
    fused = {
        "name": "gather_sum_int8_fused", "route": "cuda",
        "source": "recommendation_tpu_torch/csrc/gather.cu",
        "replaces": "recommendation_tpu/graph/bucketed.py:658-661 (the int8 chain's layer: "
                    "pull_rowspace's pack :591-592 and pull :594-607, then the running sum; "
                    "not a TPU kernel)",
        "shape": [r, fwd.n_slots, INT8_D],
        "timed": "a middle layer of the separable int8 chain (running sum in, next codes out)",
        "launches": 0, "variants": fused_checks,
        "max_abs_err": max(v["max_abs_err"] for v in fused_checks.values()),
        "ms": fused_ms["middle"], "layers_ms": fused_ms,
        "three_launches_ms": {k: time_ms(lambda a=a, q=q: three_launches(a, q))
                              for k, (a, q) in FUSED_LAYERS.items()},
        "plain_ms": time_ms(lambda: layer(True, True, gather_sum_plain)),
        "bound_ms": fused_b["middle"], "bound_by": "bytes", "layers_bound_ms": fused_b,
        "three_launches_bound_ms": {k: three_bound(a, q) for k, (a, q) in FUSED_LAYERS.items()},
        "library_ms": None,
    }
    for name, src, itemsize in (("f32_d256", x, 4), ("bf16_d256", xb, 2)):
        bound = pull_bound(fwd, INT8_D, itemsize)
        p1[name] = {
            "ms": time_ms(lambda src=src: gather_sum(src, ridx, ptr, post=post, skip=r,
                                                     schedule=sched)),
            "plain_ms": time_ms(lambda src=src: gather_sum_plain(src, ridx, ptr, post=post)),
            "bound_ms": bound[0], "library_ms": library_ms,
        }
    del inputs, x, xn, xb, codes, scale, acc, a_csr
    torch.cuda.empty_cache()
    return q1, p1, fused


def int8_one_step(graph8):
    """One LightGCN step at d = 256 on the int8 graph (Q1 once, P1's fused
    int8 layers and K7 forward, the f32 Horner chain backward) against the plain chain
    with the same int8 numerics (the plain quantizer, autograd through the
    plain pulls with the kernels' straight-through gradient)."""
    config = default_config(**{"embedding.size": INT8_D, "LightGCN.n_layers": LAYERS})
    model, plain = build("lightgcn", config), PlainBucketedLightGCN(config)
    params, _ = model.init(torch.Generator().manual_seed(0), graph8)
    batch = first_batch(graph8, LARGE_BATCH)
    return step_against_plain(
        f"lightgcn int8 d={INT8_D}", (lambda p: model.loss(p, {}, batch, graph8)[0], params),
        (lambda p: plain.loss(p, {}, batch, graph8)[0], params), torch.float32,
        {"gather_rows": 4, "gather_sum": 2 * LAYERS, "quantize_rows": 1},
        fro_tol=INT8_FRO_TOL)


def native_phase(data, train, test, tmp):
    """The native builder against the numpy builder on the clustered
    graph's normalized adjacency (every table bit for bit, host seconds of
    each), and ``Interaction.from_files`` against ``Interaction(load_data)``
    on the hard set's files in ``tmp``."""
    coo = data.norm_adj.tocoo()
    n = coo.shape[0]
    t0 = time.perf_counter()
    fast = build_bucketed(coo.row, coo.col, coo.data, n, n, device="cpu")
    t1 = time.perf_counter()
    saved = native._LIB, native._LIB_TRIED
    native._LIB, native._LIB_TRIED = None, True  # hidden: the numpy path runs
    try:
        slow = build_bucketed(coo.row, coo.col, coo.data, n, n, device="cpu")
    finally:
        native._LIB, native._LIB_TRIED = saved
    t2 = time.perf_counter()
    names = ("idx", "val", "edge", "ridx", "row_ptr", "work", "work_start", "gather_pos",
             "node_of_row", "sep_dst", "sep_src_row")
    if fast.caps != slow.caps or fast.counts != slow.counts or not all(
            torch.equal(getattr(fast, k), getattr(slow, k)) for k in names):
        raise RuntimeError("the native bucket tables differ from the numpy builder's")
    write_dataset(tmp, train, test)
    t3 = time.perf_counter()
    quick = Interaction.from_files(f"{tmp}/train.txt", f"{tmp}/test.txt")
    t4 = time.perf_counter()
    ref = Interaction(load_data(f"{tmp}/train.txt"), load_data(f"{tmp}/test.txt"))
    t5 = time.perf_counter()
    if not (quick.user == ref.user and quick.item == ref.item and quick.test_set == ref.test_set
            and quick.training_set_u == ref.training_set_u
            and np.array_equal(quick.edge_users, ref.edge_users)
            and (quick.norm_adj != ref.norm_adj).nnz == 0):
        raise RuntimeError("Interaction.from_files differs from Interaction(load_data(...))")
    return {"tables": [n, int(fast.n_slots), len(fast.caps)], "native_build_s": t1 - t0,
            "numpy_build_s": t2 - t1, "from_files_s": t4 - t3, "load_data_s": t5 - t4,
            "hard_set_edges": int(len(ref.edge_users))}


def run_tune(tmp, out, *args, in_process=False):
    """``python -m recommendation_tpu_torch tune`` on the hard set's files as
    a subprocess from the checkout (``in_process``: the same command line
    through ``cli.main`` in this process, which saves a process start);
    its stdout and results."""
    argv = ["tune", "--model", "lightgcn", "--train", f"{tmp}/train.txt", "--test",
            f"{tmp}/test.txt", "--set", "max.epoch=1", "--out", out, *args]
    t0 = time.perf_counter()
    if in_process:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        if rc != 0:
            raise RuntimeError(f"tune {args} returned {rc}:\n{buf.getvalue()[-2000:]}")
        stdout = buf.getvalue()
    else:
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        proc = subprocess.run([sys.executable, "-m", "recommendation_tpu_torch", *argv], cwd=root,
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"tune {args} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                               f"{proc.stderr[-4000:]}")
        stdout = proc.stdout
    with open(out) as f:
        return stdout, json.load(f), time.perf_counter() - t0


def tune_phase(tmp):
    """The tune command: a 2 x 2 grid (each Recall@20) with a rate that
    must fail in each of its configurations alone, the CSV with one header;
    the same sweep with ``--resume`` runs nothing; a preset's univariate
    sweep, its grid cut by ``--grid`` overrides to the preset's defaults."""
    out, table = f"{tmp}/tune.json", f"{tmp}/tune.csv"
    grid = ["--grid", TUNE_GRID[0], "--grid", f"{TUNE_GRID[1]},{TUNE_BAD_RATE}", "--csv", table]
    _, results, grid_s = run_tune(tmp, out, *grid)
    ok = [r for r in results if "metrics" in r]
    bad = [r for r in results if "error" in r]
    if (len(ok) != 4 or len(bad) != 2 or any(r["config"]["learning.rate"] != -1 for r in bad)
            or not all(0.0 < r["metrics"]["Recall@20"] <= 1.0 for r in ok)):
        raise RuntimeError(f"tune grid: {results}")
    with open(table, newline="") as f:
        rows = list(csv.reader(f))
    if len(rows) != 7 or "error" not in rows[0] or "Recall@20" not in rows[0] or any(
            len(row) < len(rows[0]) for row in rows):
        raise RuntimeError(f"tune CSV: {rows[:2]}")
    stdout, resumed, resume_s = run_tune(tmp, out, *grid[:-2], "--resume", in_process=True)
    if resumed != results or "resuming: 6 configurations" not in stdout or "[1/6]" in stdout:
        raise RuntimeError(f"tune --resume reran recorded configurations:\n{stdout[-2000:]}")
    # the preset's univariate sweep, every key of its grid cut to its
    # default by --grid: the defaults' one configuration
    preset_out = f"{tmp}/preset.json"
    _, preset, preset_s = run_tune(
        tmp, preset_out, "--mode", "univariate", "--preset", "--grid", "embedding.size=64",
        "--grid", "LightGCN.n_layers=3", "--grid", "learning.rate=0.01", "--grid", "loss=bpr",
        "--grid", "n_negs=1", in_process=True)
    if len(preset) != 1 or "metrics" not in preset[0]:
        raise RuntimeError(f"tune --preset: {preset}")
    return {"grid": {json.dumps(r["config"], sort_keys=True): r["metrics"]["Recall@20"]
                     for r in ok},
            "failed": [r["error"] for r in bad], "csv_header": rows[0],
            "preset": {json.dumps(r["config"], sort_keys=True): r["metrics"]["Recall@20"]
                       for r in preset},
            "seconds": {"grid": grid_s, "resume": resume_s, "preset": preset_s}}


def extras_phase(train, test, tmp):
    """``evaluate_rating`` from LightGCN's trained tables on the card against
    the same report from the tables on the host; the LR and SVM probes on
    the card on well-separated clusters; ``profile_trace`` around three
    steps (a trace file) and ``Throughput`` over them."""
    data = Interaction(train, test)
    graph = DeviceGraph(data, device="cuda")
    config = default_config(**{"embedding.size": EMB, "batch.size": BATCH, "learning.rate": LR,
                               "max.epoch": 2, "item.ranking.topN": [20]})
    rec = GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                           log=Log(echo=False), device="cuda")
    rec.build()
    rec.train()
    ue, ie = rec.model.eval_embeddings(rec.params, rec.state, graph)
    card_rating = evaluate_rating(ue, ie, data)
    host_rating = evaluate_rating(ue.cpu().numpy(), ie.cpu().numpy(), data)
    if not all(math.isfinite(card_rating[k]) and abs(card_rating[k] - host_rating[k]) <= 1.01e-5
               for k in ("MAE", "RMSE")):
        raise RuntimeError(f"evaluate_rating on the card {card_rating}, on the host {host_rating}")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 32)) * 4.0
    y = rng.integers(0, 4, 4000)
    z = (centers[y] + rng.normal(size=(4000, 32))).astype(np.float32)
    split = get_split(4000, train_ratio=0.1, test_ratio=0.8, seed=1)
    probes = {"lr": LREvaluator(num_epochs=100, device="cuda")(torch.from_numpy(z).cuda(), y,
                                                                split),
              "svm": SVMEvaluator(num_epochs=100, device="cuda")(z, y, split)}
    if not all(p["micro_f1"] > 0.9 for p in probes.values()):
        raise RuntimeError(f"the probes do not separate the clusters: {probes}")
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(5), graph, BATCH), graph, BATCH)
    window = (users[:3], items[:3], negs[:3], weights[:3], 3)
    meter = Throughput()
    with profile_trace(f"{tmp}/trace") as prof:
        _, loss = run_steps(rec.model, rec.optimizer, graph, rec.params, rec.state, window,
                            torch.Generator().manual_seed(6))
        float(loss)
        meter.add(3 * BATCH)
    rate = meter.examples_per_s
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
    if not (os.path.getsize(prof.trace_path) > 0 and device_us > 0 and rate > 0):
        raise RuntimeError(f"profile_trace wrote {prof.trace_path}, device us {device_us}")
    return {"rating_card": card_rating, "rating_host": host_rating, "probes": probes,
            "trace_bytes": os.path.getsize(prof.trace_path), "trace_device_us": device_us,
            "throughput_examples_per_s": rate}


def int8_phase(data, graph, pop):
    """Q1 and P1's int8 source at the clustered tables, one int8 LightGCN
    step against the plain chain, LightGCN at d = 256 trained in f32 and in
    int8 on the same batches (each held to the masked gate), then the
    native builder, the tune command and the rating, probe and profiling
    modules. Returns (the phase's line, Q1's row, P1-int8's row, the fused
    layer's row)."""
    t0 = time.perf_counter()
    q1_row, p1_row, fused_row = int8_kernel_phase(data, graph)
    t1 = time.perf_counter()
    graph8 = DeviceGraph(data, backend="auto", compute_dtype="int8", device="cuda")
    one_step = int8_one_step(graph8)
    t2 = time.perf_counter()
    runs = {}
    for name, g in (("float32", graph), ("int8", graph8)):
        stats = gate_phase("lightgcn", data, g, INT8_EPOCHS, LARGE_BATCH, pop, "masked",
                           emb=INT8_D)
        check_gate(stats)
        runs[name] = stats
    q1_row["launches"] = runs["int8"]["launches"]["quantize_rows"]
    p1_row["launches"] = runs["int8"]["launches_p1_int8"]
    fused_row["launches"] = runs["int8"]["launches_p1_fused"]
    n_steps = runs["int8"]["steps_per_epoch"] * INT8_EPOCHS
    n_chains = len(runs["int8"]["recall@20_by_epoch"]) + 3
    # every forward chain: Q1 once, and each of its L layers a fused P1
    want = LAYERS * (n_steps + n_chains)
    if (p1_row["launches"], fused_row["launches"], q1_row["launches"]) != (
            want, want, n_steps + n_chains) or runs["float32"]["launches"][
            "quantize_rows"] or runs["float32"]["launches_p1_int8"]:
        raise RuntimeError(f"P1's int8 launches {p1_row['launches']} (fused "
                           f"{fused_row['launches']}), Q1's {q1_row['launches']}, expected "
                           f"{want} and {n_steps + n_chains}; f32 {runs['float32']['launches']}")
    gap = runs["float32"]["recall@20"] - runs["int8"]["recall@20"]
    if not abs(gap) <= INT8_RECALL_GAP:
        raise RuntimeError(f"int8 Recall@20 {runs['int8']['recall@20']} is {gap} from f32's")
    graphed_check(f"lightgcn clustered bucketed d={INT8_D} int8", "lightgcn", data, graph8,
                  LARGE_BATCH, emb=INT8_D)
    del graph8
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    train, test = make_hard_dataset()
    with tempfile.TemporaryDirectory() as tmp:
        host = {"native": native_phase(data, train, test, tmp)}
        t4 = time.perf_counter()
        host["tune"] = tune_phase(tmp)
        t5 = time.perf_counter()
        host["extras"] = extras_phase(train, test, tmp)
    t6 = time.perf_counter()
    line = {
        "one_step": one_step, "train": runs,
        "recall@20": {k: v["recall@20"] for k, v in runs.items()},
        "recall@20_gap_f32_minus_int8": gap,
        "step": {k: {key: v["profile"].get(key) for key in (
            "device_us_per_step", "host_us_per_step", "device_idle_share", "launches_per_step",
            "top_kernels_us_per_step")} for k, v in runs.items()},
        "host_modules": host,
        "seconds": {"kernels": t1 - t0, "one_step": t2 - t1, "train": t3 - t2,
                    "native": t4 - t3, "tune": t5 - t4, "extras": t6 - t5, "all": t6 - t0},
    }
    print(f"int8: recall@20 {line['recall@20']}, step device us "
          f"{ {k: v['device_us_per_step'] for k, v in line['step'].items()} }, "
          f"seconds {line['seconds']}")
    return line, q1_row, p1_row, fused_row


# the parallel layer: LightGCN on the clustered bucketed graph, each layout
# trained in a world of ranks started as subprocesses of the port's worker
# (``parallel.distributed``'s ``fit``): (layout, backend, epochs). The
# layouts with two ranks share the one card over gloo (NCCL refuses two
# ranks on a device); the one-rank world runs NCCL's collectives, captured
# in its epochs' CUDA graphs. Every world is this script's own ranks
# (SHARDED_SCRIPT_WORLDS), which call ``fit`` and then take their checks in
# the same processes: (1, 2)'s evaluates and serves its tables and resumes
# its second epoch (``sharded_checks_worker``), (2, 1)'s the data axis's
# and the edge-parallel checks (``sharded_data_worker``), (1, 1)'s the
# captured epoch, the fused block, the graphed evaluator and mesh service
# and the step's profiles and build seconds (``sharded_nccl_worker``).
SHARDED_WORLDS = (("1x2", "gloo", 2), ("2x1", "gloo", 1), ("1x1", "nccl", 2))
SHARDED_SCRIPT_WORLDS = {"1x2": "--sharded-checks", "2x1": "--sharded-data",
                         "1x1": "--sharded-nccl"}
# the single run the worlds are held to: its first epoch is the graph's
# warm-up, its second a replay
SHARDED_SINGLE_EPOCHS = 2
# (2, 1) against the single run after one epoch, each part's largest
# difference over its largest magnitude (the data group's gradient sum in
# another order, carried through Adam in f32): on an NVIDIA H100 80GB HBM3
# at 700 W this phase reads 6.2e-7 (tables), 2.4e-7 (exp_avg) and 1.6e-7
# (exp_avg_sq); the JAX package holds its data axis to 5e-3
# (tests/test_parallel_trainer.py:61-62)
SHARDED_DATA_TOL = {"params": 1e-5, "exp_avg": 1e-5, "exp_avg_sq": 1e-5, "grad": 1e-5,
                    "loss": 1e-5}
SHARDED_SERVE_WAVES = 20
# the sharded runs' configuration (LightGCN at the clustered gates' width);
# each world adds its epoch count
SHARDED_CONF = {"embedding.size": EMB, "LightGCN.n_layers": LAYERS, "batch.size": LARGE_BATCH,
                "learning.rate": LR, "optimizer": "adam", "eval.interval": 1,
                "item.ranking.topN": [20], "graph.backend": "bucketed", "checkpoint.keep": 3}
SHARDED_WORLD_TIMEOUT_S = 420
# the data axis for every model (the (2, 1) world's own checks): one step of
# each registered model on the hard set (bucketed; the social models on its
# trust graph) at LATE_EPOCH's state, each rank against the single step in
# this process (its loss; the data group's summed gradient as one part,
# "grad"), NCL's two contrastive terms weighted to matter beside BPR; NCL
# and GAT one epoch at full width on the clustered set at the gates'
# configuration (NCL's defaults) against the single run
SHARDED_ZOO = ("lightgcn", "ncl", "directau", "selfcf", "buir", "ssl4rec", "gcl", "grace", "gbt",
               "bgrl", "graphsage", "gat", "diffnet", "sept", "sept_basic", "mhcn", "esrf")
SHARDED_EPOCH_MODELS = ("ncl", "gat")
SHARDED_STEP_EXTRA = {"ncl": {"NCL.ssl_reg": 1e-3, "NCL.proto_reg": 1e-3}}
SHARDED_STEP_SEED = 7
# NCL's and GAT's (2, 1) epochs are held after their first
# SHARDED_SNAPSHOT_STEPS steps (tables and Adam moments, copied as the next
# batch is cut: ``StepSnapshot``) and by the epoch loss, to SHARDED_DATA_TOL
# but where SHARDED_EPOCH_TOL says otherwise. Later in the epoch GAT's gap
# grows past rounding without a fault (a LeakyReLU kink takes the other
# slope on a last-bit difference), and the single run with each batch's
# rows in another order moves as far; the epoch's end is reported
# (``epoch_end_gap``). ``tools/probe_sharded_epochs.py`` reads the gap step
# by step beside planted faults. On an NVIDIA H100 80GB HBM3 at 700 W, after
# 8 steps: GAT 9.8e-8 (tables), 1.2e-6 (exp_avg), 4.3e-7 (exp_avg_sq), 1.8e-5
# at 16 steps; NCL's moments 3.5e-6 and 2.1e-6
SHARDED_SNAPSHOT_STEPS = 8
# NCL's tables: its full-catalog denominators give every row a gradient near
# Adam's eps (1e-8), where g / (sqrt(v) + eps) turns the gradient's rounding
# into 1e-4 of the tables' largest magnitude from the first step on. Read
# over steps 1 to 8 (same card): the (2, 1) run 7.9e-5 to 9.3e-5, the single
# run with its rows reversed 1.2e-4 to 1.4e-4; the planted faults 1.4e-2 to
# 0.18 (the summed gradient doubled) and 0.17 to 0.74 (each rank's batch
# cut to half its rows), every moment of theirs 0.85 to 3.0 away
SHARDED_EPOCH_TOL = {"ncl": {"params": 1e-3}}
# edge-parallel propagation (the segment backend at data > 1: each data rank
# pulls its row range of norm_adj's row-sorted view and the rows are
# all-gathered, ``ops/spmm.py``), in the (2, 1) world on the clustered
# set's segment graph at full width: LightGCN's forward on the initial
# tables bit for bit, then LightGCN's and NCL's first SHARDED_SNAPSHOT_STEPS
# steps (NCL after its E-step) held as the epochs above are; each rank's
# launches the single run's. Then one step of each model whose propagation
# reads norm_adj or a with_vals copy of it (DirectAU's and BGRL's
# binarized one, BUIR's dropped edges) on the hard set's segment graphs:
# GCL and SEPT-basic read it in their evaluation only (their steps
# propagate over normalized_bipartite), GRACE and G-BT read
# norm_adj_selfloops, GraphSAGE and GAT the bipartite views, DiffNet and
# MHCN the social matrices, SSL4Rec no graph
EDGE_STEP_MODELS = ("lightgcn", "ncl")
EDGE_ZOO = ("lightgcn", "ncl", "directau", "selfcf", "buir", "bgrl", "sept", "esrf")
# their steps at LATE_EPOCH, but ESRF's at epoch 0 (its first phase: after
# it the generator's social links replace each norm_adj layer)
EDGE_STEP_EPOCH = {"esrf": 0}


def table_gap(got, want):
    """(bit for bit, each part's largest absolute difference over its
    largest magnitude) of two ``merged_checkpoint`` payloads' tables
    (``params``), Adam moments and counts."""
    same, gaps = got["step"] == want["step"], {}
    for part in ("params", "exp_avg", "exp_avg_sq"):
        diff = scale = 0.0
        for k, v in want[part].items():
            same &= torch.equal(got[part][k], v)
            diff = max(diff, (got[part][k] - v).abs().max().item())
            scale = max(scale, v.abs().max().item())
        gaps[part] = diff / scale if scale > 0 else diff
    return same, gaps


def sharded_world(argv, n_ranks, out):
    """One world of ``argv`` on the card (its ranks' logs in ``out``):
    (its wall seconds, each rank's report ``out/<prefix>rank<r>.json``)."""
    t0 = time.perf_counter()
    spawn_world(argv, n_ranks, SHARDED_WORLD_TIMEOUT_S, os.path.join(out, "logs"),
                env={"PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    return time.perf_counter() - t0


def rank_reports(out, n_ranks, prefix=""):
    reports = []
    for r in range(n_ranks):
        with open(os.path.join(out, f"{prefix}rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def state_digest(state) -> str:
    """A digest of a model state's tensors' bits (NCL's centroids and
    assignments), in key order."""
    h = hashlib.sha256()
    for k in sorted(state):
        if isinstance(state[k], torch.Tensor):
            h.update(k.encode() + state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sharded_zoo_graphs(device, backend="bucketed", data=None):
    """The hard set (``data``, else made here) and the two graphs the data
    axis's one-step checks run on (the trust graph for the social models),
    on ``backend``, as every rank builds them from the seed."""
    if data is None:
        train, test = make_hard_dataset()
        data = Interaction(train, test)
    return data, {"plain": DeviceGraph(data, backend=backend, device=device),
                  "social": SocialDeviceGraph(data, synthesize_social(data), backend=backend,
                                              device=device)}


def sharded_zoo_config(name):
    return default_config(**{"embedding.size": EMB, "batch.size": BATCH,
                             "LightGCN.n_layers": LAYERS, "learning.rate": LR,
                             "optimizer": "adam", **SHARDED_STEP_EXTRA.get(name, {})})


def trainer_step(rec, epoch, seed):
    """One step of a built trainer with nothing updated: ``epoch_begin``
    of ``epoch`` (its draws from a generator seeded ``seed``), then the
    loss on the first batch of an epoch drawn from a generator seeded
    ``seed + 1``, which also feeds the loss's draws (``step_grads``). A
    sharded trainer takes its rows of that batch (its placement's
    ``batch``) and gives the data group's summed gradient. Returns (loss,
    {name: gradient}, the state the loss read)."""
    state = rec.model.epoch_begin(rec.model_params(), rec.state, rec.graph,
                                  torch.Generator().manual_seed(seed), epoch)
    gen = torch.Generator().manual_seed(seed + 1)
    arrays = epoch_batches(epoch_words(gen, rec.graph, rec.batch_size), rec.graph,
                           rec.batch_size)
    whole = PairwiseBatch(*(a[0] for a in arrays[:4]))
    place = rec._placement
    batch = whole if place is None else place.batch(whole)
    loss, grads, _ = step_grads(rec.model, rec.graph, rec.params, state, batch, gen, place)
    names = [k for k, p in rec.params.items() if p.requires_grad]
    return loss.detach(), dict(zip(names, grads)), state


def zoo_step(rec, epoch=LATE_EPOCH):
    """One step of a built recommender (``trainer_step`` at ``epoch``, by
    default LATE_EPOCH: ESRF adversarial, SEPT's SSL on, NCL after an
    E-step) with its launches: (loss, {name: gradient on the host},
    launches, the state's digest)."""
    reset_counts()
    loss, grads, state = trainer_step(rec, epoch, SHARDED_STEP_SEED)
    torch.cuda.synchronize()
    return (float(loss), {k: g.detach().cpu() for k, g in grads.items()}, all_counts(),
            state_digest(state))


def zoo_step_launches(name, graph, model):
    """What ``zoo_step`` launches: one step and, for NCL, its E-step."""
    return expected_launches(name, graph, getattr(model, "n_layers", LAYERS), 1, 0,
                             e_steps=int(name == "ncl"))


def sharded_zoo_single():
    """Every model's single step on the card in this process, its launches
    held to ``zoo_step_launches``."""
    data, graphs = sharded_zoo_graphs("cuda")
    out = {}
    for name in SHARDED_ZOO:
        graph = graphs["social" if name in SOCIAL_MODELS else "plain"]
        rec = make_trainer(name, data, graph, sharded_zoo_config(name))
        out[name] = zoo_step(rec)
        want = zoo_step_launches(name, graph, rec.model)
        if out[name][2] != want:
            raise RuntimeError(f"{name} single step launches {out[name][2]}, expected {want}")
    del graphs
    torch.cuda.empty_cache()
    return out


def sharded_data_worker(run_dir, pairs_path, conf_json):
    """One rank of the (2, 1) world over gloo on the card: LightGCN's ``fit``
    in ``run_dir`` (what the (2, 1) world's ``--jobs fit`` ran before this
    world took the data axis's checks too), then NCL's and GAT's epoch
    (``snapshot_epoch``, on the same pairs at the same configuration; the
    checkpoints in ``run_dir/<model>/ckpt``, rank 0's snapshot in
    ``run_dir/<model>/snapshot.pt``), then the edge-parallel runs on the
    clustered set's segment graph (``edge_runs``; rank 0's tables in
    ``run_dir/edge.pt``), one step of every model of SHARDED_ZOO on the
    hard set (``zoo_step``) and of every EDGE_ZOO model on its segment
    graphs (``edge_zoo_steps``). Each rank writes ``data_rank<r>.json``
    (each epoch's state and snapshot digests, launches and stats; every
    step's loss, launches and state digest; the edge-parallel reports);
    rank 0 writes the summed gradients to ``zoo_grads.npz`` and
    ``edge_zoo_grads.npz``."""
    import torch.distributed as dist

    from recommendation_tpu_torch.parallel.distributed import fit, initialize
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize("gloo", "cuda")
    rank = dist.get_rank()
    conf = json.loads(conf_json)
    mesh = make_mesh(MeshSpec(2, 1), "cuda")
    lightgcn = fit(pairs_path, mesh, default_config(**conf), run_dir, device)
    report = {"epochs": {}, "steps": {}}
    for name in SHARDED_EPOCH_MODELS:
        out = os.path.join(run_dir, name)
        rec, snap, launches = snapshot_epoch(name, lightgcn.data, lightgcn.graph,
                                             {**conf, "checkpoint.dir": os.path.join(out, "ckpt")},
                                             mesh)
        report["epochs"][name] = {"state_digest": state_digest(rec.state),
                                  "snapshot_digest": payload_digest(snap), "launches": launches,
                                  "epoch": rec.epoch_stats[0]}
        if rank == 0:
            torch.save(snap, os.path.join(out, "snapshot.pt"))
        del rec, snap
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["edge"], edge_tables = edge_runs(lightgcn.data, conf, device, mesh)
    if rank == 0:
        torch.save(edge_tables, os.path.join(run_dir, "edge.pt"))
    del lightgcn, edge_tables
    torch.cuda.empty_cache()
    report["edge_s"] = time.perf_counter() - t0
    data, graphs = sharded_zoo_graphs(device)
    grads = {}
    t0 = time.perf_counter()
    for name in SHARDED_ZOO:
        rec = make_trainer(name, data, graphs["social" if name in SOCIAL_MODELS else "plain"],
                           sharded_zoo_config(name), mesh)
        loss, g, launches, digest = zoo_step(rec)
        report["steps"][name] = {"loss": loss, "launches": launches, "state_digest": digest}
        grads.update({f"{name}/{k}": v.numpy() for k, v in g.items()})
    report["zoo_s"] = time.perf_counter() - t0
    del graphs
    t0 = time.perf_counter()
    report["edge_steps"], edge_grads = edge_zoo_steps(device, mesh, data)
    report["edge_zoo_s"] = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(run_dir, "zoo_grads.npz"), **grads)
        np.savez(os.path.join(run_dir, "edge_zoo_grads.npz"), **edge_grads)
    with open(os.path.join(run_dir, f"data_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def make_trainer(name, data, graph, config, mesh=None):
    """A single trainer of ``name`` on ``graph``'s device, or a sharded one
    over ``mesh``, built."""
    if mesh is None:
        rec = GraphRecommender(build(name, config), data, config, graph=graph,
                               log=Log(echo=False), device=graph.device)
    else:
        from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender

        rec = ShardedGraphRecommender(build(name, config), data, config, graph=graph, mesh=mesh,
                                      log=Log(echo=False), device=graph.device)
    rec.build()
    return rec


def edge_run(name, data, graph, conf, mesh=None):
    """``name``'s first SHARDED_SNAPSHOT_STEPS steps on the segment graph
    ``graph`` at ``conf``, by a single trainer or a sharded one over
    ``mesh`` (edge-parallel at data > 1): ``epoch_begin`` of epoch 0 (NCL's
    E-step) and the steps on the batches of generators seeded from
    SHARDED_STEP_SEED, through the trainer's step loop and placement
    (``train.loop.run_steps``), under ``torch.profiler``. LightGCN's
    ``eval_embeddings`` on the initial tables first. Returns (the report:
    the propagation path with the rank's rows and slots, launches, P2's
    device µs a step, the steps' host seconds, the last loss; the
    tables: the forward where it was taken, ``tables_and_moments`` after the
    steps)."""
    from torch.profiler import ProfilerActivity, profile

    config = default_config(**{**conf, "graph.backend": "segment", "max.epoch": 1})
    seconds = {}
    t0 = time.perf_counter()
    rec = make_trainer(name, data, graph, config, mesh)
    report = {"propagation": rec.edge_report() if mesh is not None
              else {"propagation": "replicated"}, "seconds": seconds}
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    tables = {}
    if name == "lightgcn":
        t0 = time.perf_counter()
        with torch.no_grad():
            tables["forward"] = tuple(t.cpu() for t in rec.model.eval_embeddings(
                rec.model_params(), rec.state, rec.graph))
        report["forward_digest"] = hashlib.sha256(b"".join(
            t.numpy().tobytes() for t in tables["forward"])).hexdigest()
        seconds["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = rec.model.epoch_begin(rec.model_params(), rec.state, rec.graph,
                                  torch.Generator().manual_seed(SHARDED_STEP_SEED), 0)
    gen = torch.Generator().manual_seed(SHARDED_STEP_SEED + 1)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(gen, rec.graph, rec.batch_size), rec.graph, rec.batch_size)
    k = SHARDED_SNAPSHOT_STEPS
    window = (users[:k], items[:k], negs[:k], weights[:k], k)
    torch.cuda.synchronize()
    seconds["epoch_begin"] = time.perf_counter() - t0
    reset_counts()
    calls = spmm.edge_parallel_matmul.calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events: a quick read
        t0 = time.perf_counter()
        rec.state, loss = run_steps(rec.model, rec.optimizer, rec.graph, rec.params, state,
                                    window, gen, rec._placement)
        report["loss"] = float(loss)
        report["host_s"] = time.perf_counter() - t0
    report["launches"] = all_counts()
    report["edge_parallel_products"] = spmm.edge_parallel_matmul.calls - calls
    t0 = time.perf_counter()
    p2_us = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA" and "segment_sum" in e.key)
    report["p2_device_us_per_step"] = p2_us / k if p2_us > 0 else "not measured"
    seconds["profile_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables["steps"] = tables_and_moments(rec)
    report["snapshot_digest"] = payload_digest(tables["steps"])
    seconds["snapshot"] = time.perf_counter() - t0
    del rec
    torch.cuda.empty_cache()
    return report, tables


def edge_runs(data, conf, device, mesh=None):
    """EDGE_STEP_MODELS' ``edge_run`` on the clustered set's segment graph
    (built here, as every rank builds it): ({model: report}, {model:
    tables}), with the whole view's slot count in LightGCN's report."""
    t0 = time.perf_counter()
    graph = DeviceGraph(data, backend="segment", compute_dtype="float32", device=device)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    reports, tables = {}, {}
    for name in EDGE_STEP_MODELS:
        reports[name], tables[name] = edge_run(name, data, graph, conf, mesh)
    reports["lightgcn"]["view_slots"] = int(graph.norm_adj.seg.n_slots)
    reports["lightgcn"]["seconds"]["graph"] = graph_s
    del graph
    torch.cuda.empty_cache()
    return reports, tables


def edge_zoo_steps(device, mesh=None, data=None):
    """One step of each EDGE_ZOO model on the hard set's segment graphs
    (``sharded_zoo_graphs``; ``data`` the hard set, else made there) by
    ``zoo_step``, single or sharded over ``mesh``: ({model: loss,
    launches, state digest, edge-parallel products}, {model/param:
    gradient})."""
    data, graphs = sharded_zoo_graphs(device, "segment", data)
    steps, grads = {}, {}
    for name in EDGE_ZOO:
        rec = make_trainer(name, data, graphs["social" if name in SOCIAL_MODELS else "plain"],
                           sharded_zoo_config(name), mesh)
        calls = spmm.edge_parallel_matmul.calls
        loss, g, launches, digest = zoo_step(rec, EDGE_STEP_EPOCH.get(name, LATE_EPOCH))
        steps[name] = {"loss": loss, "launches": launches, "state_digest": digest,
                       "edge_parallel_products": spmm.edge_parallel_matmul.calls - calls}
        if mesh is not None and not steps[name]["edge_parallel_products"]:
            raise RuntimeError(f"{name}'s step at (2, 1) on the segment graph made no "
                               "edge-parallel product")
        grads.update({f"{name}/{k}": v.numpy() for k, v in g.items()})
    del graphs
    torch.cuda.empty_cache()
    return steps, grads


class StepSnapshot:
    """A built trainer's step-loop placement (``train.loop``; None for a
    single trainer), wrapped to copy the trainer's tables and Adam moments
    to the host after its first ``steps`` steps, as the next batch is cut
    (``payloads[steps]``, in ``merged_checkpoint``'s form). Everything else
    is the placement's: the step is unchanged."""

    def __init__(self, rec, steps):
        self.rec, self.steps, self.seen, self.payloads = rec, tuple(steps), 0, {}
        self.inner = rec._placement

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def gather(self, params):
        return params if self.inner is None else self.inner.gather(params)

    def reduce_grads(self, grads):
        return grads if self.inner is None else self.inner.reduce_grads(grads)

    def batch(self, whole):
        if self.seen in self.steps:
            self.payloads[self.seen] = tables_and_moments(self.rec)
        self.seen += 1
        return whole if self.inner is None else self.inner.batch(whole)


def tables_and_moments(rec):
    """A trainer's whole tables and Adam moments on the host, as
    ``merged_checkpoint`` gives them (one model rank: every shard whole)."""
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    with torch.no_grad():
        for k, p in rec.params.items():
            st = rec.optimizer.state.get(p)
            if not st:  # a frozen parameter
                continue
            out["params"][k] = p.detach().cpu().clone()
            out["exp_avg"][k] = st["exp_avg"].cpu().clone()
            out["exp_avg_sq"][k] = st["exp_avg_sq"].cpu().clone()
            out["step"][k] = float(st["step"])
    return out


def payload_digest(payload) -> str:
    """A digest of ``tables_and_moments``' bits, part by part in key order."""
    h = hashlib.sha256()
    for part in ("params", "exp_avg", "exp_avg_sq"):
        for k in sorted(payload[part]):
            h.update(f"{part}/{k}".encode() + payload[part][k].numpy().tobytes())
    return h.hexdigest()


def snapshot_epoch(name, data, graph, conf, mesh=None):
    """One epoch of ``name`` at ``conf`` on the card, by a single trainer
    or a sharded one over ``mesh``, with its tables and moments copied
    after SHARDED_SNAPSHOT_STEPS steps (``StepSnapshot``), through the
    eager step loop. Returns (the trained recommender, the copy, every
    kernel's launches over ``train()``)."""
    rec = make_trainer(name, data, graph, default_config(**{**conf, "max.epoch": 1}), mesh)
    snap = StepSnapshot(rec, (SHARDED_SNAPSHOT_STEPS,))
    rec._placement = snap
    rec._graphed = None  # the hook runs in the eager loop (a replay equals it bit for bit)
    reset_counts()
    rec.train()
    torch.cuda.synchronize()
    rec._placement = snap.inner
    return rec, snap.payloads[SHARDED_SNAPSHOT_STEPS], all_counts()


def sharded_epoch_single(data, graph, conf, tmp):
    """NCL's and GAT's single-rank epoch on the clustered graph at the
    (2, 1) world's configuration (``snapshot_epoch``): {model: (the copy
    after SHARDED_SNAPSHOT_STEPS steps, epoch 0's checkpoint merged, the
    epoch loss, the state digest, the epoch's seconds, the run's seconds
    with its build)}."""
    out = {}
    for name in SHARDED_EPOCH_MODELS:
        ckpt = os.path.join(tmp, f"single_{name}")
        t0 = time.perf_counter()
        rec, snap, _ = snapshot_epoch(name, data, graph, {**conf, "checkpoint.dir": ckpt})
        out[name] = (snap, merged_checkpoint(ckpt, 0), rec.epoch_stats[0]["loss"],
                     state_digest(rec.state), rec.epoch_stats[0]["seconds"],
                     time.perf_counter() - t0)
        del rec
        torch.cuda.empty_cache()
    return out


def grad_gap(got, want):
    """The largest difference of two gradient dicts over the largest
    magnitude of ``want``, over all of a model's parameters (one part)."""
    diff = max(float(np.abs(got[k] - w.numpy()).max()) for k, w in want.items())
    return diff / max(float(w.abs().max()) for w in want.values())


def sharded_data_checks(out, graph, n_batches, zoo_single, epoch_single):
    """The (2, 1) world's data-axis checks against the single runs: NCL's
    and GAT's epoch (the tables and moments after SHARDED_SNAPSHOT_STEPS
    steps and the epoch loss within SHARDED_DATA_TOL, or SHARDED_EPOCH_TOL
    where it names the part, the ranks' launches
    held to ``expected_launches``, the ranks' tables and NCL's cluster
    state bit for bit alike; the gap at the epoch's end reported), then
    every model's step (each rank's
    loss; the summed gradient within SHARDED_DATA_TOL["grad"]; each rank's
    launches as the single step's)."""
    reports = rank_reports(out, 2, "data_")
    epochs = {}
    for name in SHARDED_EPOCH_MODELS:
        single_snap, single, single_loss, single_digest, single_s, _ = epoch_single[name]
        bounds = {**SHARDED_DATA_TOL, **SHARDED_EPOCH_TOL.get(name, {})}
        ranks = [r["epochs"][name] for r in reports]
        want = expected_launches(name, graph, LAYERS, n_batches, 1, e_steps=int(name == "ncl"))
        launches = [r["launches"] for r in ranks]
        if any(got[k] != want[k] for got in launches for k in got):
            raise RuntimeError(f"sharded 2x1 {name}: launches {launches}, expected {want}")
        losses = [r["epoch"]["loss"] for r in ranks]
        same, gaps = table_gap(torch.load(os.path.join(out, name, "snapshot.pt")), single_snap)
        gaps["loss"] = abs(losses[0] - single_loss) / abs(single_loss)
        digests = [r["state_digest"] for r in ranks]
        snap_digests = [r["snapshot_digest"] for r in ranks]
        if (any(x != losses[0] for x in losses) or len(set(digests)) != 1
                or len(set(snap_digests)) != 1
                or any(gaps[p] > bounds[p] for p in gaps)):
            raise RuntimeError(f"sharded 2x1 {name}: relative gaps after "
                               f"{SHARDED_SNAPSHOT_STEPS} steps and of the epoch loss {gaps} "
                               f"(bounds {bounds}), losses {losses} against "
                               f"{single_loss}, state digests {digests}, snapshot digests "
                               f"{snap_digests}")
        end_same, end_gaps = table_gap(merged_checkpoint(os.path.join(out, name, "ckpt"), 0),
                                       single)
        epochs[name] = {"snapshot_steps": SHARDED_SNAPSHOT_STEPS, "relative_gap": gaps,
                        "bounds": {p: bounds[p] for p in gaps},
                        "bit_for_bit": bool(same), "epoch_end_gap": end_gaps,
                        "epoch_end_bit_for_bit": bool(end_same), "epoch_loss": losses[0],
                        "host_s_per_step": max(r["epoch"]["seconds"] for r in ranks) / n_batches,
                        "single_host_s_per_step": single_s / n_batches,
                        "state_equal_on_ranks": True, "tables_equal_on_ranks": True,
                        "state_equal_single": digests[0] == single_digest,
                        "launches_by_rank": launches}
    grads = np.load(os.path.join(out, "zoo_grads.npz"))
    steps = {}
    for name in SHARDED_ZOO:
        loss, want, launches, digest = zoo_single[name]
        got = {k: grads[f"{name}/{k}"] for k in want}
        ranks = [r["steps"][name] for r in reports]
        gaps = {"grad": grad_gap(got, want),
                "loss": max(abs(r["loss"] - loss) for r in ranks) / max(abs(loss), 1e-30)}
        if (any(gaps[p] > SHARDED_DATA_TOL[p] for p in gaps)
                or any(r["launches"] != launches for r in ranks)
                or len({r["state_digest"] for r in ranks}) != 1):
            raise RuntimeError(f"sharded 2x1 {name} step: relative gaps {gaps} (bounds "
                               f"{SHARDED_DATA_TOL}), launches {[r['launches'] for r in ranks]} "
                               f"against {launches}, state digests "
                               f"{[r['state_digest'] for r in ranks]}")
        steps[name] = {**gaps, "state_equal_single": ranks[0]["state_digest"] == digest,
                       "launches_by_rank": [r["launches"] for r in ranks]}
    return {"epochs": epochs, "steps": steps, "zoo_s": max(r["zoo_s"] for r in reports)}


def edge_checks(out, single, zoo_single, card):
    """The (2, 1) world's edge-parallel runs against the single runs made
    in this process: each rank edge-parallel, its slots summing to the
    whole view's; LightGCN's forward the single forward bit for bit on
    every rank; LightGCN's and NCL's tables and Adam moments after
    SHARDED_SNAPSHOT_STEPS steps within SHARDED_DATA_TOL (or
    SHARDED_EPOCH_TOL), alike on both ranks, each rank's launches the
    single run's; each EDGE_ZOO step's summed gradient and each rank's loss
    within SHARDED_DATA_TOL, each rank's launches the single step's."""
    reports = rank_reports(out, 2, "data_")
    (single_reports, single_tables), (single_steps, single_grads) = single, zoo_single
    tables = torch.load(os.path.join(out, "edge.pt"))
    ranks = [r["edge"] for r in reports]
    props = [r["lightgcn"]["propagation"] for r in ranks]
    view_slots = single_reports["lightgcn"]["view_slots"]
    if (any(p.get("propagation") != "edge-parallel" for p in props)
            or [p["part"] for p in props] != [0, 1]
            or sum(p["slots"] for p in props) != view_slots
            or any(p["ranges"] != props[0]["ranges"] for p in props)):
        raise RuntimeError(f"edge-parallel 2x1: the ranks' paths {props}, the view's slots "
                           f"{view_slots}")
    want_u, want_i = single_tables["lightgcn"]["forward"]
    got_u, got_i = tables["lightgcn"]["forward"]
    forward_gap = max((got_u - want_u).abs().max().item(), (got_i - want_i).abs().max().item())
    digests = {r["lightgcn"]["forward_digest"] for r in ranks}
    if not (torch.equal(got_u, want_u) and torch.equal(got_i, want_i)) or digests != {
            single_reports["lightgcn"]["forward_digest"]}:
        raise RuntimeError(f"edge-parallel 2x1: LightGCN's forward differs from the single "
                           f"forward by {forward_gap}, rank digests {digests}")
    models = {}
    for name in EDGE_STEP_MODELS:
        bounds = {**SHARDED_DATA_TOL, **SHARDED_EPOCH_TOL.get(name, {})}
        same, gaps = table_gap(tables[name]["steps"], single_tables[name]["steps"])
        launches = [r[name]["launches"] for r in ranks]
        want = single_reports[name]["launches"]
        if (any(got != want for got in launches)
                or len({r[name]["snapshot_digest"] for r in ranks}) != 1
                or any(gaps[p] > bounds[p] for p in gaps)
                or any(r[name]["edge_parallel_products"] <= 0 for r in ranks)):
            raise RuntimeError(f"edge-parallel 2x1 {name}: relative gaps after "
                               f"{SHARDED_SNAPSHOT_STEPS} steps {gaps} (bounds {bounds}), "
                               f"launches {launches} against {want}, snapshot digests "
                               f"{[r[name]['snapshot_digest'] for r in ranks]}")
        models[name] = {"snapshot_steps": SHARDED_SNAPSHOT_STEPS, "relative_gap": gaps,
                        "bounds": {p: bounds[p] for p in gaps}, "bit_for_bit": bool(same),
                        "tables_equal_on_ranks": True, "launches_by_rank": launches,
                        "edge_parallel_products_by_rank": [r[name]["edge_parallel_products"]
                                                           for r in ranks],
                        "p2_device_us_per_step_by_rank": [r[name]["p2_device_us_per_step"]
                                                          for r in ranks],
                        "single_p2_device_us_per_step":
                            single_reports[name]["p2_device_us_per_step"],
                        "host_s_per_step_by_rank": [r[name]["host_s"] / SHARDED_SNAPSHOT_STEPS
                                                    for r in ranks],
                        "single_host_s_per_step":
                            single_reports[name]["host_s"] / SHARDED_SNAPSHOT_STEPS,
                        "seconds_by_rank": [r[name]["seconds"] for r in ranks],
                        "single_seconds": single_reports[name]["seconds"]}
    grads = np.load(os.path.join(out, "edge_zoo_grads.npz"))
    steps = {}
    for name in EDGE_ZOO:
        want = {k[len(name) + 1:]: torch.from_numpy(v) for k, v in single_grads.items()
                if k.startswith(f"{name}/")}
        got = {k: grads[f"{name}/{k}"] for k in want}
        single = single_steps[name]
        rank_steps = [r["edge_steps"][name] for r in reports]
        gaps = {"grad": grad_gap(got, want),
                "loss": max(abs(r["loss"] - single["loss"]) for r in rank_steps)
                / max(abs(single["loss"]), 1e-30)}
        if (any(gaps[p] > SHARDED_DATA_TOL[p] for p in gaps)
                or any(r["launches"] != single["launches"] for r in rank_steps)
                or len({r["state_digest"] for r in rank_steps}) != 1):
            raise RuntimeError(f"edge-parallel 2x1 {name} step: relative gaps {gaps} (bounds "
                               f"{SHARDED_DATA_TOL}), launches "
                               f"{[r['launches'] for r in rank_steps]} against "
                               f"{single['launches']}")
        steps[name] = {**gaps, "launches_by_rank": [r["launches"] for r in rank_steps],
                       "edge_parallel_products_by_rank": [r["edge_parallel_products"]
                                                          for r in rank_steps],
                       "state_equal_single": rank_steps[0]["state_digest"]
                       == single["state_digest"]}
    print(f"edge-parallel 2x1 ({card}): ranges {props[0]['ranges']}, slots "
          f"{[p['slots'] for p in props]} of {view_slots}, P2 device us a step by rank "
          f"{ {n: m['p2_device_us_per_step_by_rank'] for n, m in models.items()} }")
    return {"card": card, "set": "clustered, segment, f32, d=64, L=3, B=8192",
            "ranges": props[0]["ranges"], "slots_by_rank": [p["slots"] for p in props],
            "transpose_slots_by_rank": [p["transpose_slots"] for p in props],
            "view_slots": view_slots, "forward_bit_for_bit": True, "forward_gap": forward_gap,
            "models": models, "steps": steps,
            "edge_s": max(r["edge_s"] for r in reports),
            "edge_zoo_s": max(r["edge_zoo_s"] for r in reports)}


def sharded_phase(data, graph, card):
    """The sharded trainer, evaluator, service and checkpoints
    (``parallel/``) on the clustered bucketed graph at full width (f32,
    d = 64, L = 3, B = 8192, Adam 1e-3): the single-rank trainer in this
    process (one epoch), then a world of ``python -m
    recommendation_tpu_torch.parallel.distributed --worker --jobs fit``
    subprocesses on the card for each layout of SHARDED_WORLDS (K7 and P1
    in every rank): two ranks over gloo train (1, 2) for two epochs and
    (2, 1) for one, one rank over NCCL (1, 1) for one. (1, 2) and (1, 1)
    must equal the single run bit for bit (epoch 0's tables and Adam
    moments from the per-rank checkpoints, the epoch loss), (2, 1) within
    SHARDED_DATA_TOL. A world of this script's ranks over gloo then takes
    the (1, 2) run's checkpoints (``sharded_checks_worker``): its sharded
    ``test()`` must equal the single evaluator's metrics on its tables,
    its mesh service (SHARDED_SERVE_WAVES waves of 16 users, with and
    without exclusions) the single service's (``topk_agree``), and its
    second epoch, resumed from its epoch-0 per-rank checkpoint, the
    straight run's bit for bit, and NCL's E-step the same on both ranks.
    The (2, 1) world is this script's own ranks (``sharded_data_worker``):
    after LightGCN's ``fit`` it takes the data axis's checks
    (``sharded_data_checks``) and the edge-parallel checks
    (``edge_checks``) against the single runs made here first
    (``sharded_zoo_single``, ``sharded_epoch_single``, ``edge_runs``,
    ``edge_zoo_steps``). Each rank's
    launches are held to ``expected_launches``. Two ranks share one card
    over gloo, and the three worlds run at once, beside the single runs: the
    seconds are no scaling figure."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sharded_")
    try:
        pairs_path = os.path.join(tmp, "pairs.npz")
        np.savez(pairs_path, pairs=np.concatenate([data.test_pairs, data.training_data]),
                 n_users=graph.n_users, n_items=graph.n_items, test_fraction=0.1)
        conf = SHARDED_CONF
        worlds, argvs = [], []
        for layout, backend, epochs in SHARDED_WORLDS:
            out = os.path.join(tmp, layout)
            n_ranks = int(layout.split("x")[0]) * int(layout.split("x")[1])
            if layout in SHARDED_SCRIPT_WORLDS:  # LightGCN's fit, then the layout's checks
                argv = [sys.executable, os.path.abspath(__file__), SHARDED_SCRIPT_WORLDS[layout],
                        out, pairs_path, json.dumps({**conf, "max.epoch": epochs})]
            else:
                argv = WORKER + ["--jobs", "fit", "--device", "cuda", "--backend", backend,
                                 "--data", pairs_path, "--mesh", layout, "--out", out,
                                 "--set", f"max.epoch={epochs}"]
                for k, v in conf.items():
                    argv += ["--set", f"{k}={v}"]
            argvs.append((argv, n_ranks, out))
            worlds.append({"job": "fit" if layout not in SHARDED_SCRIPT_WORLDS else
                           f"fit, then {SHARDED_SCRIPT_WORLDS[layout][2:]}", "layout": layout,
                           "backend": backend, "ranks": n_ranks})
        # the worlds at once, each on a thread that waits for its ranks, while
        # this process makes the single runs they are held to: they share the
        # card and the host's cores, so their seconds overlap
        t_worlds = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(argvs)) as pool:
            walls = [pool.submit(sharded_world, *a) for a in argvs]
            single_dir = os.path.join(tmp, "single")
            config = default_config(**conf, **{"max.epoch": SHARDED_SINGLE_EPOCHS,
                                               "checkpoint.dir": single_dir})
            t1 = time.perf_counter()
            rec = GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                                   log=Log(echo=False), device="cuda")
            rec.build()
            rec.train()
            torch.cuda.synchronize()
            if rec._graphed is None or not rec._graphed.captures:
                raise RuntimeError("the single run the worlds are held to did not replay its "
                                   "epoch")
            single = [merged_checkpoint(single_dir, e) for e in range(SHARDED_SINGLE_EPOCHS)]
            n_batches = -(-graph.n_edges // LARGE_BATCH)
            runs = {"single": {"train_s": time.perf_counter() - t1,
                               "epoch_losses": [e["loss"] for e in rec.epoch_stats],
                               "epoch_seconds": [e["seconds"] for e in rec.epoch_stats],
                               "host_s_per_step": [e["seconds"] / n_batches
                                                   for e in rec.epoch_stats]}}
            single_loss = [e["loss"] for e in rec.epoch_stats]
            del rec
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            zoo_single = sharded_zoo_single()
            epoch_single = sharded_epoch_single(data, graph, conf, tmp)
            for name, single_run in epoch_single.items():
                runs[f"single_{name}"] = {"epoch_loss": single_run[2],
                                          "host_s_per_step": single_run[4] / n_batches,
                                          "train_s": single_run[5]}
            runs["single_zoo_steps_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            edge_single = (edge_runs(data, conf, "cuda"), edge_zoo_steps("cuda"))
            runs["single_edge_s"] = time.perf_counter() - t1
            for world, wall in zip(worlds, walls):
                world["wall_s"] = wall.result()
        runs["worlds_wall_s"] = time.perf_counter() - t_worlds
        for (layout, backend, epochs), (_, n_ranks, out) in zip(SHARDED_WORLDS, argvs):
            checks = rank_reports(out, n_ranks, "checks_") if layout == "1x2" else None
            runs[layout] = sharded_checks(layout, backend, epochs, rank_reports(out, n_ranks),
                                          out, graph, n_batches, single, single_loss, checks)
            if layout == "2x1":
                runs[layout]["data_axis"] = sharded_data_checks(out, graph, n_batches,
                                                                zoo_single, epoch_single)
                runs[layout]["edge_parallel"] = edge_checks(out, *edge_single, card)
            if layout == "1x1":
                runs[layout]["captured"] = nccl_checks(out, runs[layout], runs["single"],
                                                       graph, n_batches)
            print(f"sharded {layout} ({backend}): train {runs[layout]['train_s']:.1f} s, "
                  f"host s a step by epoch {runs[layout]['host_s_per_step']}, relative gaps "
                  f"{runs[layout]['relative_gap']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"card": card, "set": "clustered, bucketed, f32, d=64, L=3, B=8192",
            "note": "two ranks share one card over gloo (NCCL refuses two ranks on a "
                    "device), and the three worlds run at once, beside the single runs: the "
                    "seconds are no scaling figure, and the (1, 1) world's timings are taken "
                    "beside the other worlds' work on the card",
            "data_tol": SHARDED_DATA_TOL, "worlds": worlds, "runs": runs,
            "seconds": time.perf_counter() - t0}


def sharded_checks_worker(run_dir, pairs_path, conf_json):
    """One rank of the (1, 2) world over gloo on the card: LightGCN's
    ``fit`` in ``run_dir`` at ``conf_json``'s configuration (the run the
    layout's checks read), then on that run a trainer restored from its
    last per-rank checkpoints gives the
    sharded ``test()`` beside the single evaluator on the same tables and
    serves SHARDED_SERVE_WAVES waves of 16 test users with the mesh and
    without it, with and without exclusions (rank 0 writes
    ``serve.npz``); a second trainer resumes from a copy of the run's
    epoch-0 checkpoints in ``run_dir/resumed`` and trains to the run's
    epoch count. Each rank writes ``checks_rank<r>.json``."""
    import torch.distributed as dist

    from recommendation_tpu_torch.parallel.distributed import fit, initialize
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize("gloo", "cuda")
    rank = dist.get_rank()
    conf = json.loads(conf_json)
    mesh = make_mesh(MeshSpec(1, 2), "cuda")
    fitted = fit(pairs_path, mesh, default_config(**conf), run_dir, device)
    data, graph = fitted.data, fitted.graph
    del fitted
    torch.cuda.empty_cache()

    def trainer(ckpt_dir):
        cfg = default_config(**conf, **{"checkpoint.dir": ckpt_dir})
        rec = ShardedGraphRecommender(build("lightgcn", cfg), data, cfg, graph=graph,
                                      mesh=mesh, log=Log(echo=False), device=device)
        rec.build()
        return rec

    rec = trainer(os.path.join(run_dir, "ckpt"))
    user_emb, item_emb = rec.model.eval_embeddings(rec.model_params(), rec.state, graph)
    report = {"restored_start_epoch": rec.start_epoch, "metrics": rec.test().metrics,
              "single_metrics": evaluate_ranking(user_emb, item_emb, data, graph,
                                                 Ns=rec.topN).metrics}
    rng = np.random.default_rng(11)
    waves = [rng.choice(data.test_user_ids(), 16, replace=False).tolist()
             for _ in range(SHARDED_SERVE_WAVES)]
    answers = {"users": np.asarray(waves)}
    for tag, mesh_arg in (("mesh", mesh), ("single", None)):
        service = RecommenderService.from_recommender(rec, mesh=mesh_arg)
        for exclude, kind in ((True, "seen"), (False, "raw")):
            got = [service.recommend_ids(u, k=10, exclude_seen=exclude) for u in waves]
            answers[f"{tag}_scores_{kind}"] = np.stack([s for s, _ in got])
            answers[f"{tag}_ids_{kind}"] = np.stack([i for _, i in got])
    if rank == 0:
        np.savez(os.path.join(run_dir, "serve.npz"), **answers)
    resumed_dir = os.path.join(run_dir, "resumed")
    CheckpointManager(resumed_dir, rank=rank).save(
        0, CheckpointManager(os.path.join(run_dir, "ckpt"), rank=rank).restore(0))
    resumed = trainer(resumed_dir)
    report["resumed_from"] = resumed.start_epoch - 1
    resumed.train()
    report["resumed_epochs"] = resumed.epoch_stats
    # NCL's E-step at (1, 2): every rank clusters the gathered tables
    cfg = default_config(**conf)
    ncl = ShardedGraphRecommender(build("ncl", cfg), data, cfg, graph=graph, mesh=mesh,
                                  log=Log(echo=False), device=device)
    ncl.build()
    report["ncl_state_digest"] = state_digest(trainer_step(ncl, 0, SHARDED_STEP_SEED)[2])
    with open(os.path.join(run_dir, f"checks_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_nccl_worker(run_dir, pairs_path, conf_json):
    """The one rank of the (1, 1) world over NCCL on the card. Its build in
    parts (ROADMAP 13d): the default group's set-up, the mesh, each group's
    first collective (NCCL makes a communicator there), the import of
    ``torch._dynamo`` (a process's first ``torch.optim`` optimizer makes
    it), and the imports of torch and of the port (this process's own,
    ``IMPORTED_AT``); then LightGCN's ``fit`` in ``run_dir`` (its epochs
    captured; its build now the graph and placement alone). Then a second
    trainer of the same configuration: its epochs through ``graphed_check``
    with its placement (the warm-up, GRAPHED_REPEATS replays against as
    many eager epochs bit for bit, a profiled replay) and a fused block of
    two epochs against the warm-up and the first replay; the eager step's
    profile (``profile_steps`` with the placement, Step 0); the sharded
    evaluator (``sharded_test``: its blocks' graphs hold NCCL's all-gathers)
    against the single evaluator's metrics; the mesh service:
    SHARDED_SERVE_WAVES waves of 16 test users, with and without exclusions, each replay
    against the same padded wave run eagerly bit for bit and against the
    single service (``topk_agree``), and its waves profiled both ways; MHCN
    (the social example's model) on the hard set's bucketed social graph
    through ``graphed_zoo_check`` on the same mesh (its replays against its
    eager epochs with the placement, bit for bit). Writes
    ``nccl_rank0.json`` and rank 0's served answers ``nccl_serve.npz``."""
    import torch.distributed as dist

    from recommendation_tpu_torch.parallel.distributed import fit, initialize
    from recommendation_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        MeshSpec,
        axis_group,
        make_mesh,
    )
    from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender

    torch.backends.cuda.matmul.allow_tf32 = False
    split = {"imports": {"torch_s": IMPORTED_AT[1] - IMPORTED_AT[0],
                         "device_mesh_loaded_by_torch": DEVICE_MESH_WITH_TORCH,
                         "port_s": IMPORTED_AT[2] - IMPORTED_AT[1],
                         "dynamo_loaded": "torch._dynamo" in sys.modules}}
    t = time.perf_counter()
    device = initialize("nccl", "cuda")
    split["init_process_group_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh = make_mesh(MeshSpec(1, 1), "cuda")
    split["mesh_s"] = time.perf_counter() - t
    split["first_collective_s"] = {}
    for name, group in (("default", None), ("data", axis_group(mesh, DATA_AXIS)),
                        ("model", axis_group(mesh, MODEL_AXIS))):
        t = time.perf_counter()
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        torch.cuda.synchronize()
        split["first_collective_s"][name] = time.perf_counter() - t
    t = time.perf_counter()
    from torch import _dynamo  # noqa: F401  (what the first optimizer imports)
    split["dynamo_import_s"] = time.perf_counter() - t
    conf = json.loads(conf_json)
    fitted = fit(pairs_path, mesh, default_config(**conf), run_dir, device)
    data, graph = fitted.data, fitted.graph
    del fitted
    torch.cuda.empty_cache()
    config = default_config(**{**conf, "max.epoch": 2})

    def trainer(cfg):
        rec = ShardedGraphRecommender(build("lightgcn", cfg), data, cfg, graph=graph, mesh=mesh,
                                      log=Log(echo=False), device=device)
        rec.build()
        return rec

    t = time.perf_counter()
    rec = trainer(config)
    split["second_build_s"] = time.perf_counter() - t
    if rec.epoch_report()["epochs"] != "captured":
        raise RuntimeError(f"(1, 1) over NCCL: the epochs are not captured: "
                           f"{rec.epoch_report()}")
    fused_config = config.with_overrides(**{
        "eval.interval": 2, "train.fuse_epochs": True, "train.fuse_below_steps": 128})

    def fused_block():
        block = trainer(fused_config)
        if not block._can_fuse_epochs():
            raise RuntimeError("(1, 1) over NCCL: the fused trainer does not fuse its block")
        block.train()
        return block

    report = {"build_split": split, "epoch_path": rec.epoch_report(),
              "graphed": graphed_check("lightgcn clustered bucketed, sharded (1, 1) nccl",
                                       "lightgcn", data, graph, LARGE_BATCH, rec=rec,
                                       fused=fused_block)}
    report["eager_profile"] = profile_steps(rec, LARGE_BATCH, rec._placement)
    sharded = rec.sharded_test()
    report["sharded_test"] = {"metrics": sharded.metrics, "single_metrics": rec.test().metrics,
                              "block": block_stats(rec._scorer)}
    if report["sharded_test"]["metrics"] != report["sharded_test"]["single_metrics"] or (
            not rec._scorer.stats["replays"] or rec._scorer.stats["eager"]):
        raise RuntimeError(f"(1, 1) over NCCL: the sharded evaluator {report['sharded_test']}")
    service = RecommenderService.from_recommender(rec, mesh=mesh)
    single = RecommenderService.from_recommender(rec)
    eager = service.eager_block()
    rng = np.random.default_rng(11)
    waves = [rng.choice(data.test_user_ids(), 16, replace=False).tolist()
             for _ in range(SHARDED_SERVE_WAVES)]
    answers = {"users": np.asarray(waves)}
    for exclude, kind in ((True, "seen"), (False, "raw")):
        for tag, svc, block in (("mesh", service, None), ("eager", service, eager),
                                ("single", single, None)):
            graphed = svc.block
            svc.block = block or graphed
            try:
                got = [svc._recommend_ids_device(u, K, exclude) for u in waves]
            finally:
                svc.block = graphed
            answers[f"{tag}_scores_{kind}"] = np.stack([a for a, _ in got])
            answers[f"{tag}_ids_{kind}"] = np.stack([b for _, b in got])
        if not all(np.array_equal(answers[f"mesh_{x}_{kind}"], answers[f"eager_{x}_{kind}"])
                   for x in ("scores", "ids")):
            raise RuntimeError(f"(1, 1) over NCCL: a replayed mesh wave ({kind}) differs from "
                               "the same padded wave run eagerly")
    stats = block_stats(service.block)
    if stats["eager"] or stats["replays"] != 2 * SHARDED_SERVE_WAVES:
        raise RuntimeError(f"(1, 1) over NCCL: the mesh waves did not all replay: {stats}")
    report["service"] = {"waves": SHARDED_SERVE_WAVES, "block": stats,
                         "fetch": sorted({service.sharded_fetch(u, K, True) for u in waves}),
                         "graphed": profile_waves(service),
                         "eager": profile_waves(service, eager=True)}
    hard = Interaction(*make_hard_dataset())
    social = SocialDeviceGraph(hard, synthesize_social(hard), backend="bucketed", device=device)
    report["mhcn"] = graphed_zoo_check("mhcn hard bucketed float32, sharded (1, 1) nccl", "mhcn",
                                       hard, social, BATCH, mesh=mesh)
    # the launches of graphed_check's epochs (each held there to expected_launches)
    report["launches"] = {k: v * (1 + 2 * GRAPHED_REPEATS)
                          for k, v in report["graphed"]["launches_per_epoch"].items()}
    np.savez(os.path.join(run_dir, "nccl_serve.npz"), **answers)
    with open(os.path.join(run_dir, "nccl_rank0.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def nccl_checks(out, run, single_run, graph, n_batches):
    """The (1, 1) world's own checks (``sharded_nccl_worker``'s report):
    its served waves against the single service (``topk_agree``), its
    launches (every captured epoch's were held to ``expected_launches`` in
    the world), the build's split beside ``fit``'s build and the single
    run's, and the step eager and captured."""
    with open(os.path.join(out, "nccl_rank0.json")) as f:
        report = json.load(f)
    served = np.load(os.path.join(out, "nccl_serve.npz"))
    scores = np.concatenate([served["single_scores_seen"], served["single_scores_raw"]])
    tol = 1e-6 * float(np.abs(scores).max()) * EMB  # f32 dot products of d terms
    for w in range(len(served["users"])):
        for kind in ("seen", "raw"):
            if not topk_agree(served[f"mesh_scores_{kind}"][w], served[f"mesh_ids_{kind}"][w],
                              served[f"single_scores_{kind}"][w],
                              served[f"single_ids_{kind}"][w], tol):
                raise RuntimeError(f"(1, 1) mesh wave {w} ({kind}) differs from the single "
                                   "service's")
    graphed, eager = report["graphed"], report["eager_profile"]
    split = report["build_split"]
    line = {"epoch_path": report["epoch_path"], "build_split": split,
            "fit_build_s": run["build_s"], "fit_graph_s": run["graph_s"],
            "device_figures": "the world's device µs and idle shares are taken beside the other "
                              "worlds' work on the card: not a measurement "
                              "(tools/probe_nccl_step.py measures the world alone)",
            "step": {"eager": eager, "captured": {
                "host_us_per_step": graphed["captured"]["host_us_per_step"],
                "eager_epoch_host_us_per_step": graphed["eager"]["host_us_per_step"],
                "captures": graphed["captures"]},
                     "single_captured_host_us_per_step": [
                         s / n_batches * 1e6 for s in single_run["epoch_seconds"]]},
            "graphed": graphed, "sharded_test": report["sharded_test"],
            "service": report["service"], "mhcn": report["mhcn"], "served_equal_eager": True,
            "served_agree_single": True, "serve_score_tol": tol,
            "launches": report["launches"]}
    print(f"sharded 1x1 (nccl) captured: host us a step eager {eager['host_us_per_step']:.1f}, "
          f"captured {graphed['captured']['host_us_per_step']:.1f} (beside the other worlds; "
          f"device figures: tools/probe_nccl_step.py); capture s, pool MB "
          f"{[(round(c['seconds'], 3), round(c['pool_bytes'] / 2**20, 1)) for c in graphed['captures']]}; "
          f"build split {split}; mesh wave host us graphed "
          f"{report['service']['graphed'].get('host_us_per_wave_unprofiled')} eager "
          f"{report['service']['eager'].get('host_us_per_wave_unprofiled')}; mhcn host us a "
          f"step eager {report['mhcn']['eager']['host_us_per_step']:.1f} captured "
          f"{report['mhcn']['captured']['host_us_per_step']:.1f}")
    return line


def sharded_checks(layout, backend, epochs, ranks, out, graph, n_batches, single, single_loss,
                   checks=None):
    """One layout's ranks against the single run: the epochs' path
    (captured over NCCL, eager over gloo), launches, epoch losses, and each
    epoch's tables, moments and device generator state that the single run
    has (SHARDED_SINGLE_EPOCHS: its warm-up, then a replay); with
    ``checks`` (the (1, 2) run's ``sharded_checks_worker`` reports) its
    evaluator, service and resumed epoch."""
    exact = layout.startswith("1x")
    want = expected_launches("lightgcn", graph, LAYERS, n_batches * epochs, epochs)
    paths = {r["epoch_path"]["epochs"] for r in ranks}
    if paths != {"captured" if backend == "nccl" else "eager"}:
        raise RuntimeError(f"sharded {layout} ({backend}): the epochs ran {paths}: "
                           f"{[r['epoch_path'] for r in ranks]}")
    launches = [r["launches"] for r in ranks]
    if any(got[k] != want[k] for got in launches for k in got):
        raise RuntimeError(f"sharded {layout}: launches {launches}, expected {want}")
    losses = [[e["loss"] for e in r["epochs"]] for r in ranks]
    if any(x != losses[0] for x in losses) or len(losses[0]) != epochs:
        raise RuntimeError(f"sharded {layout}: the ranks' epoch losses {losses}")
    by_epoch = []
    for e in range(min(epochs, len(single))):  # the single run's warm-up, then its replay
        got = merged_checkpoint(os.path.join(out, "ckpt"), e)
        same, gaps = table_gap(got, single[e])
        same &= torch.equal(got["draws"], single[e]["draws"])
        loss_gap = abs(losses[0][e] - single_loss[e])
        if (exact and not (same and loss_gap == 0)) or any(
                gaps[p] > SHARDED_DATA_TOL[p] for p in gaps) or (
                loss_gap > 1e-5 * abs(single_loss[e])):
            raise RuntimeError(f"sharded {layout}: epoch {e} differs from the single run's: "
                               f"relative gaps {gaps} (bounds {SHARDED_DATA_TOL}), loss "
                               f"{losses[0][e]} against {single_loss[e]}")
        by_epoch.append((bool(same), gaps, loss_gap))
    same, gaps, loss_gap = by_epoch[0]
    epoch_s = [max(r["epochs"][e]["seconds"] for r in ranks) for e in range(epochs)]
    run = {"backend": backend, "ranks": len(ranks), "epochs": epochs,
           "graph_s": max(r["graph_s"] for r in ranks),
           "build_s": max(r["build_s"] for r in ranks),
           "train_s": max(r["train_s"] for r in ranks),
           "host_s_per_step": [t / n_batches for t in epoch_s], "epoch_seconds": epoch_s,
           "epoch_losses": losses[0], "bit_for_bit": bool(same), "relative_gap": gaps,
           "loss_gap": loss_gap, "bit_for_bit_by_epoch": [b[0] for b in by_epoch],
           "relative_gap_by_epoch": [b[1] for b in by_epoch],
           "epoch_path": ranks[0]["epoch_path"], "captures": ranks[0]["captures"],
           "shard_rows": ranks[0]["shard_rows"],
           "sharded": ranks[0]["sharded"], "launches_by_rank": launches}
    if checks is None:
        return run
    metrics = checks[0]["metrics"]
    if len({c["ncl_state_digest"] for c in checks}) != 1:
        raise RuntimeError(f"sharded {layout}: NCL's cluster state differs between the ranks: "
                           f"{[c['ncl_state_digest'] for c in checks]}")
    if any(c["metrics"] != metrics or c["single_metrics"] != metrics for c in checks) or any(
            c["restored_start_epoch"] != epochs for c in checks):
        raise RuntimeError(f"sharded test() {[c['metrics'] for c in checks]} against the single "
                           f"evaluator's {[c['single_metrics'] for c in checks]} on the same "
                           "restored tables")
    served = np.load(os.path.join(out, "serve.npz"))
    scores = np.concatenate([served["single_scores_seen"], served["single_scores_raw"]])
    tol = 1e-6 * float(np.abs(scores).max()) * EMB  # f32 dot products of d terms
    for w in range(len(served["users"])):
        for kind in ("seen", "raw"):
            if not topk_agree(served[f"mesh_scores_{kind}"][w], served[f"mesh_ids_{kind}"][w],
                              served[f"single_scores_{kind}"][w],
                              served[f"single_ids_{kind}"][w], tol):
                raise RuntimeError(f"sharded service wave {w} ({kind}) differs from the "
                                   "single service's")
    straight = merged_checkpoint(os.path.join(out, "ckpt"), epochs - 1)
    same, gaps = table_gap(merged_checkpoint(os.path.join(out, "resumed"), epochs - 1), straight)
    if not same or any(c["resumed_from"] != 0 for c in checks) or any(
            [e["loss"] for e in c["resumed_epochs"]] != losses[0][1:] for c in checks):
        raise RuntimeError(f"the resumed epochs differ from the straight run's by {gaps}")
    run.update({"ncl_state_equal_on_ranks": True,
                "metrics": metrics, "metrics_equal_single_evaluator": True,
                "served_waves": int(len(served["users"])), "served_equal_single": True,
                "serve_score_tol": tol, "resumed_equal_straight": True})
    return run


def add_sharded_launches(kernel_rows, sharded):
    """Each layout's ranks' launches into the kernels rows (a fused row's
    into the kernel it runs in, ``launches_of``): LightGCN's K7 and P1 in
    every layout; at (2, 1) also NCL's and GAT's epochs and every model's
    step (``data_axis``), and the edge-parallel runs (``edge_parallel``:
    LightGCN's and NCL's steps, the norm_adj readers' steps); at (1, 1) the
    epochs of its captured checks (``captured``) and MHCN's replays. The bf16 rows take none
    (every sharded run is f32)."""
    rows = [r for r in kernel_rows if r.get("dtype", "float32") == "float32"]
    for layout, run in sharded["runs"].items():
        if not isinstance(run, dict) or "launches_by_rank" not in run:
            continue
        parts = {"": run["launches_by_rank"]}
        if "captured" in run:  # the (1, 1) world's captured and eager epochs, MHCN's replays
            parts["_checks"] = [run["captured"]["launches"]]
            parts["_mhcn_replays"] = [run["captured"]["mhcn"]["replayed_launches"]]
        for name, sub in run.get("data_axis", {}).get("epochs", {}).items():
            parts[f"_{name}"] = sub["launches_by_rank"]
        edge = run.get("edge_parallel", {})
        for name, sub in edge.get("models", {}).items():
            parts[f"_edge_{name}"] = sub["launches_by_rank"]
        for label, steps in (("_steps", run.get("data_axis", {}).get("steps", {})),
                             ("_edge_steps", edge.get("steps", {}))):
            if steps:
                parts[label] = [{k: sum(s["launches_by_rank"][r][k] for s in steps.values())
                                 for k in steps[next(iter(steps))]["launches_by_rank"][r]}
                                for r in range(2)]
        for row in rows:
            name = row.get("launches_of", row["name"])
            for label, by_rank in parts.items():
                counts = [ranks.get(name, 0) for ranks in by_rank]
                if any(counts):
                    row[f"launches_sharded_{layout}{label}"] = counts
                    row["launches"] += sum(counts)


def add_graphed_launches(kernel_rows):
    """The launches inside the replayed graphs of ``graphed_zoo_check``
    (the fifteen models and GRAPHED_ONCE_EAGER's four configurations,
    every run f32) into the kernels rows, each as
    ``launches_graphed_<model>`` (``_<variant>`` for the four) and added to
    the row's ``launches``."""
    for row in kernel_rows:
        if row.get("dtype", "float32") != "float32":
            continue
        for run in GRAPHED:
            n = run.get("replayed_launches", {}).get(row.get("launches_of", row["name"]), 0)
            if n:
                row[f"launches_graphed_{run.get('launches_key', run['model'])}"] = n
                row["launches"] += n


# why a kernel's row has no library time: no one PyTorch call computes the
# same function on the same inputs
LIBRARY_NOTES = {
    "weighted_pull_dot": "two outputs: the transpose pull (torch.bmm over a batched COO, S1's "
                         "yardstick) and the per-slot head dot (torch.sparse.sampled_addmm, "
                         "S3's, where the rows are the nodes) are two calls",
    "attention_softmax": "GAT's logits (a gather-add of the node scores, the slope, the mask) "
                         "come before the softmax; on given logits torch.sparse.softmax "
                         "(softmax_only.library_ms)",
    "attention_softmax_bwd": "the slope and the mask follow the softmax's backward; on given "
                             "logits torch._sparse_softmax_backward_data "
                             "(softmax_only.library_ms)",
    "segment_dot": "on the bucket rows the rows are not the nodes, so no sampled product has "
                   "the pattern; torch.sparse.sampled_addmm where they are (the hard set's "
                   "views, the neighbors line)",
    "quantize_rows": "torch.quantize_per_channel takes the row scales as an input: their row "
                     "maximum is a second call",
    "gather_sum_int8_fused": "a pull of int8 codes with a running sum and the next layer's "
                             "codes: torch.sparse.mm takes no int8 source and writes one output",
}


# -- the epoch as CUDA graphs (train/graphed.py) ------------------------------

# consecutive timed epochs each way, eager and captured: each replay held to
# its eager epoch; host µs a step and the idle share are the medians
GRAPHED_REPEATS = 2
# the chunked epoch's steps_per_call on the clustered bucketed set: 110
# batches = 3 x 32 + 14, a full chunk's graph and a remainder's
GRAPHED_CHUNK = 32
GRAPHED = []  # one entry a configuration: the graphed line
# the models whose step draws nothing (ESRF neither in phase 0): their
# generator moves by the epoch's words alone
GRAPHED_ZOO_DRAWLESS = ("directau", "selfcf", "diffnet", "sept", "sept_social", "sept_basic")
# the configurations that trained eagerly until they were captured (their
# steps draw words or produce the state; the bold driver's rate moves),
# checked as the zoo is on the hard set: label -> (model, config keys)
GRAPHED_ONCE_EAGER = {
    "pointwise": ("lightgcn", {"loss": "pointwise"}),
    "bce n_negs 3": ("lightgcn", {"loss": "bce", "n_negs": 3}),
    "e_step batch": ("ncl", {"NCL.e_step_cadence": "batch"}),
    "bold driver sgd": ("lightgcn", {"adaptive.lr": True, "optimizer": "sgd"}),
}


def group_tensors(optimizer):
    """Each param group's tensors but its parameters (a tensor rate, G-BT's
    schedule count)."""
    return [{k: v for k, v in group.items() if k != "params" and isinstance(v, torch.Tensor)}
            for group in optimizer.param_groups]


def train_snapshot(params, optimizer, state):
    """Copies of the parameters, every optimizer state tensor, the model
    state and the param groups' tensors."""
    moments = [{k: v.clone() for k, v in optimizer.state[p].items()} for p in params.values()]
    return ({k: v.detach().clone() for k, v in params.items()}, moments,
            {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()},
            [{k: v.clone() for k, v in group.items()} for group in group_tensors(optimizer)])


def put_back(params, optimizer, snap):
    """The snapshot's parameters and optimizer state, written in place."""
    with torch.no_grad():
        for (k, v), moments in zip(params.items(), snap[1]):
            v.copy_(snap[0][k])
            for key, t in moments.items():
                optimizer.state[v][key].copy_(t)
        for group, saved in zip(group_tensors(optimizer), snap[3]):
            for key, t in saved.items():
                group[key].copy_(t)


def same(a, b):
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def snapshot_diff(got, want, loss_got, loss_want):
    """The parts of two snapshots that differ in any bit (empty: the same)."""
    bad = [f"params.{k}" for k in want[0] if not torch.equal(got[0][k], want[0][k])]
    bad += [f"optimizer.{i}.{k}" for i, (g, w) in enumerate(zip(got[1], want[1]))
            for k in w if not torch.equal(g[k], w[k])]
    bad += [f"state.{k}" for k in want[2] if not same(got[2][k], want[2][k])]
    bad += [f"group.{i}.{k}" for i, (g, w) in enumerate(zip(got[3], want[3]))
            for k in w if not torch.equal(g[k], w[k])]
    if not torch.equal(loss_got, loss_want):
        bad.append("loss")
    return bad


def busy_us(events):
    """The µs in which at least one of ``events`` (device events with time
    ranges) ran: the union of their intervals, where kernels that overlap
    (a layer launched early by programmatic dependent launch) count once."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def device_profile(fn, n_steps):
    """``profile_steps``' device reading over one epoch of ``fn`` (returning
    its loss, read on the host at the end) under torch.profiler, device
    events only: the kernels' and copies' µs a step (their sum, as
    ``profile_steps``; and the union of their intervals, ``busy_us``), the
    five with the most time, and the host-to-device copies (``htod_copies``:
    a replayed epoch, which draws its words on the card, makes none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        float(fn())
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        return {"device_us_per_step": "not measured", "htod_copies": "not measured"}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    spans = [e for e in prof.events() if e.device_type.name == "CUDA"
             and not getattr(e, "is_user_annotation", False)]
    return {"device_us_per_step": device_us / n_steps,
            "device_busy_us_per_step": busy_us(spans) / n_steps,
            "htod_copies": sum(e.count for e in events if "HtoD" in e.key),
            "top_kernels_us_per_step": {e.key[:100]: e.self_device_time_total / n_steps
                                        for e in top}}


def check_epoch_draw(label, graph, batch, state):
    """The words an epoch draws on the card from the trainer's generator at
    ``state``, drawn again from a replica (a replay from that state draws
    the same bits: the epoch comparisons hold it to the eager epoch bit for
    bit): the permutation is one of the train edges, the epoch's rows cover
    every train edge, and no negative is a train positive of its user."""
    gen = torch.Generator(device=graph.device)
    gen.set_state(state)
    words = epoch_words(gen, graph, batch)
    e, n_items = graph.n_edges, graph.n_items
    perm = keyed_permutation(words.perm_ks, words.perm_salts, e).long()
    users, items, negs, _, _ = epoch_batches(words, graph, batch)
    live = graph.edge_valid > 0
    train = torch.sort(graph.edge_users[live].long() * n_items
                       + graph.edge_items[live].long()).values
    rows = users.flatten()[:e].long() * n_items + items.flatten()[:e].long()
    out = {"permutation": torch.equal(torch.sort(perm).values,
                                      torch.arange(e, device=perm.device)),
           "rows_cover_the_train_edges": torch.equal(torch.sort(rows).values, train),
           "negatives_that_are_train_positives": int(torch.isin(
               users.flatten().long() * n_items + negs.flatten().long(), train).sum()),
           "negatives": int(negs.numel())}
    if not (out["permutation"] and out["rows_cover_the_train_edges"]) or out[
            "negatives_that_are_train_positives"]:
        raise RuntimeError(f"{label}: the epoch's draw on the card is malformed: {out}")
    return out


def graphed_check(label, model_name, data, graph, batch, emb=EMB, chunk=None, rec=None,
                  fused=None):
    """One configuration's captured epoch on the card. The trainer's
    ``GraphedEpoch`` warms up and captures on its first epoch; then from
    the same parameters, Adam moments, state and generator state,
    GRAPHED_REPEATS consecutive replayed epochs and as many eager ones
    (``train_epoch`` from the trainer's generator) must agree bit for bit
    epoch by epoch, the generator's state after each too (the words are
    drawn on the card inside the graph: consecutive replays draw new
    ones), each epoch's launches must be ``expected_launches``' for its
    steps, and each epoch's host seconds (ending in the loss's host read)
    are taken; one more replayed epoch under torch.profiler gives the
    device µs a step (``device_profile``: the eager epoch runs the same
    kernels, and profiling its host calls costs seconds a configuration)
    and the host-to-device copies, none. The medians give host µs a step
    and, with the device's, both idle shares (``profile_steps``' method). The first
    epoch's draw is checked (``check_epoch_draw``). With ``chunk``, the
    epoch in chunks of ``chunk`` steps (its warm-up and its replay) must
    give the first replayed epoch's bits. ``rec``: a built trainer to check
    in place of a new single one (a sharded trainer: its eager epochs take
    its placement). ``fused``: a function that trains a trainer of the same
    configuration from the same start through one fused block of two
    epochs and returns it; its tables, moments, generator state and two
    losses must be the warm-up's and the first replay's."""
    t0 = time.perf_counter()
    if rec is None:
        config = default_config(**{
            "embedding.size": emb, "batch.size": batch, "learning.rate": LR,
            "optimizer": "adam", "graph.compute_dtype": graph.compute_dtype,
            "item.ranking.topN": [20]})
        rec = GraphRecommender(build(model_name, config), data, config, graph=graph,
                               log=Log(echo=False), device="cuda")
        rec.build()
    runner, draws = rec._graphed, rec._draws
    if runner is None or not runner.capture or runner.chunks is not None:
        raise RuntimeError(f"{label}: the trainer does not capture its epochs in one graph")
    if hasattr(runner, "words") or draws.device.type != "cuda":
        raise RuntimeError(f"{label}: the epoch's words are not drawn on the card")
    model, params, opt, n = rec.model, rec.params, rec.optimizer, runner.n_batches
    state = model.epoch_begin(params, rec.state, graph, torch.Generator().manual_seed(1), 0)
    want = expected_launches(model_name, graph, model.n_layers, n, 0, emb=emb)

    def epoch(name, fn):
        """``fn``'s (state, loss) after the loss's host read, its host µs a
        step, its launches held to ``want``."""
        reset_counts()
        t = time.perf_counter()
        st, loss = fn()
        float(loss)
        host_us = (time.perf_counter() - t) * 1e6 / n
        launches = all_counts()
        if launches != want:
            raise RuntimeError(f"{label} {name} epoch launches {launches}, expected {want}")
        return st, loss, host_us

    warm = epoch("warm-up", lambda: runner.run(state, draws))
    start, start_draws = train_snapshot(params, opt, warm[0]), draws.get_state()
    draw = check_epoch_draw(label, graph, batch, start_draws)

    def from_start(name, fn, epochs):
        """``epochs`` consecutive epochs of ``fn`` from the start: each
        one's (snapshot, loss, host µs, the generator's state after it)."""
        put_back(params, opt, start)
        draws.set_state(start_draws)
        st, out = dict(start[2]), []
        for _ in range(epochs):
            st, loss, host_us = epoch(name, lambda: fn(st))
            out.append((train_snapshot(params, opt, st), loss.clone(), host_us,
                        draws.get_state()))
        return out

    def captured(st):
        return runner.run(st, draws)

    def eager(st):
        return train_epoch(model, opt, graph, params, st, draws, batch,
                           placement=rec._placement)

    runs = {mode: from_start(mode, fn, GRAPHED_REPEATS)
            for mode, fn in (("captured", captured), ("eager", eager))}
    diff = {}
    for r, (got, want_run) in enumerate(zip(runs["captured"], runs["eager"])):
        diff[f"captured_vs_eager_{r}"] = snapshot_diff(got[0], want_run[0], got[1], want_run[1])
        if not torch.equal(got[3], want_run[3]):
            diff[f"captured_vs_eager_{r}"].append("generator_state")
    first, loss_c = runs["captured"][0][0], runs["captured"][0][1]
    chunked = None
    if chunk is not None:
        chunked = GraphedEpoch(model, opt, graph, params, batch, steps_per_call=chunk)
        for name in ("chunked_warm_up", "chunked"):
            (snap, loss_k, _, after), = from_start(name, lambda st: chunked.run(st, draws), 1)
            diff[f"{name}_vs_captured"] = snapshot_diff(snap, first, loss_k, loss_c)
            if not torch.equal(after, runs["captured"][0][3]):
                diff[f"{name}_vs_captured"].append("generator_state")
    if fused is not None:
        block = fused()
        first_run = runs["captured"][0]
        diff["fused_vs_warm_up_and_replay"] = snapshot_diff(
            train_snapshot(block.params, block.optimizer, block.state), first_run[0],
            first_run[1], first_run[1])
        if [e["loss"] for e in block.epoch_stats] != [float(warm[1]), float(first_run[1])]:
            diff["fused_vs_warm_up_and_replay"].append("losses")
        if not torch.equal(block._draws.get_state(), first_run[3]):
            diff["fused_vs_warm_up_and_replay"].append("generator_state")
        del block
    states = [x[3] for x in runs["captured"]]
    if (any(diff.values()) or not math.isfinite(float(loss_c))
            or any(torch.equal(a, b) for a, b in zip([start_draws] + states, states))):
        raise RuntimeError(f"{label}: the epochs differ: {diff}, loss {float(loss_c)}")
    put_back(params, opt, start)
    draws.set_state(start_draws)
    prof = device_profile(lambda: captured(dict(start[2]))[1], n)
    if prof["htod_copies"]:
        raise RuntimeError(f"{label}: a replayed epoch copied from the host: "
                           f"{prof['htod_copies']} copies")
    dev, timing = prof["device_us_per_step"], {}
    for mode in ("eager", "captured"):
        hosts = [x[2] for x in runs[mode]]
        host = float(np.median(hosts))
        timing[mode] = {"host_us_per_step": host, "host_us_per_step_by_repeat": hosts,
                        "device_idle_share": 1.0 - dev / host if isinstance(dev, float) else dev}
        if isinstance(dev, float):
            timing[mode]["device_busy_idle_share"] = 1.0 - prof["device_busy_us_per_step"] / host
    out = {"config": label, "model": model_name, "backend": graph.backend,
           "compute_dtype": graph.compute_dtype, "d": emb, "batch": batch,
           "steps_per_epoch": n, "loss": float(loss_c), "same_bits": sorted(diff),
           "epoch_draw": draw, "launches_per_epoch": want, "warm_up_host_us_per_step": warm[2],
           "captures": runner.captures, "chunks": chunked and chunked.chunks,
           "chunk_captures": chunked and chunked.captures, **timing, "device": prof,
           "seconds": time.perf_counter() - t0}
    GRAPHED.append(out)
    print(f"graphed: {label}: {len(diff)} comparisons bit for bit; host us/step eager "
          f"{timing['eager']['host_us_per_step']:.1f} captured "
          f"{timing['captured']['host_us_per_step']:.1f}; device us/step {dev} (busy "
          f"{prof.get('device_busy_us_per_step')}); idle captured "
          f"{timing['captured']['device_idle_share']} (busy "
          f"{timing['captured'].get('device_busy_idle_share')}); host-to-device copies in the "
          f"replay {prof['htod_copies']}; capture s "
          f"{[round(c['seconds'], 3) for c in runner.captures]}, pool MB "
          f"{[round(c['pool_bytes'] / 2**20, 1) for c in runner.captures]}"
          + (f", chunked {[round(c['seconds'], 3) for c in chunked.captures]} s, "
             f"{[round(c['pool_bytes'] / 2**20, 1) for c in chunked.captures]} MB"
             if chunked else "") + f"; {out['seconds']:.1f} s")
    del rec, runner, chunked
    torch.cuda.empty_cache()
    return out


def graphed_zoo_check(label, model_name, data, graph, batch, extra=None, draws_masks=None,
                      rate_moves=False, variant=None, mesh=None):
    """One of the fifteen models' captured epochs at its defaults (d=64,
    Adam at LR; GraphRecommender's ``GraphedEpoch``, warmed up and
    captured on its first epoch): from one start (parameters, Adam's
    moments, the param groups' tensors, the state and the trainer's device
    generator), GRAPHED_REPEATS consecutive replayed epochs, with
    ``epoch_begin`` between them, against as many eager epochs
    (``train_epoch`` from the trainer's generator), bit for bit epoch by
    epoch: the second equal only if each replay advanced the generator as
    the eager epoch did, its words drawn on the card. The generator's state
    after them must agree, and move past the words' share where the model
    draws masks. Each epoch's launches must be ``expected_launches``', and
    the phase's first draw well formed (``check_epoch_draw``). At
    LATE_EPOCH (SEPT's SSL on); ESRF in each phase's first epoch, one graph
    a phase. Then one more replayed epoch under torch.profiler
    (``device_profile``: the eager epoch runs the same kernels, and
    profiling its host calls costs seconds a model), whose device µs give
    both idle shares, with no host-to-device copy. G-BT's rate is a group tensor: it
    must agree after every epoch, and its schedule on the card must be the
    CPU's (optax's, ``tests/test_torch_graphed_zoo.py``) bit for bit at
    every update from 0 to T + 3. ``extra``: config keys over the
    defaults (GRAPHED_ONCE_EAGER's); ``draws_masks``: whether the step
    draws (None: the model's default); ``rate_moves``: the rate moves by
    ×1.05 before each later epoch, as the bold driver moves it, into the
    same tensor on both paths; ``variant``: the configuration's name in
    the kernels line's ``launches_graphed_<model>_<variant>``; ``mesh``:
    the model trained through ``ShardedGraphRecommender`` on that mesh (its
    eager epochs take the trainer's placement)."""
    t0 = time.perf_counter()
    config = default_config(**{
        "embedding.size": EMB, "batch.size": batch, "learning.rate": LR, "optimizer": "adam",
        "graph.compute_dtype": graph.compute_dtype, "item.ranking.topN": [20], **(extra or {})})
    if mesh is None:
        rec = GraphRecommender(build(model_name, config), data, config, graph=graph,
                               log=Log(echo=False), device="cuda")
    else:
        from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender

        rec = ShardedGraphRecommender(build(model_name, config), data, config, graph=graph,
                                      mesh=mesh, log=Log(echo=False), device=graph.device)
    rec.build()
    runner, draws = rec._graphed, rec._draws
    if runner is None or not runner.capture or runner.chunks is not None:
        raise RuntimeError(f"{label}: the trainer does not capture its epochs in one graph")
    if hasattr(runner, "words") or draws.device.type != "cuda":
        raise RuntimeError(f"{label}: the epoch's words are not drawn on the card")
    model, params, opt, n = rec.model, rec.params, rec.optimizer, runner.n_batches
    n_layers = getattr(model, "n_layers", None)
    if model_name == "esrf":
        third = max(1, model.max_epoch // 3)
        epochs = {model.phase_of(e): e for e in (0, third, 2 * third)}
    else:
        epochs = {2: LATE_EPOCH}
    out = {"config": label, "model": model_name, "backend": graph.backend,
           "compute_dtype": graph.compute_dtype, "d": EMB, "batch": batch, "extra": extra or {},
           "launches_key": model_name if variant is None else f"{model_name}_{variant}",
           "optimizer": type(opt).__name__, "steps_per_epoch": n, "phases": {}}
    replayed = collections.Counter()  # the kernels' launches inside replayed graphs
    if model_name == "gbt":
        count = torch.arange(model.total_steps + 4, dtype=torch.int32)
        rates = cosine_decay(LR, count.cuda(), model.total_steps)
        if not torch.equal(rates.cpu(), cosine_decay(LR, count, model.total_steps)):
            raise RuntimeError(f"{label}: the cosine schedule on the card differs from the CPU's")
        out["schedule_steps_same_as_cpu"] = len(count)
    for phase, epoch in epochs.items():
        want = expected_launches(model_name, graph, n_layers, n, 0, phase=phase)
        state = model.epoch_begin(params, rec.state, graph, torch.Generator().manual_seed(1),
                                  epoch)

        def counted(fn, name):
            """``fn``'s (state, loss) after the loss's host read, its host
            µs a step, its launches held to ``want`` (a replay's added to
            ``replayed``)."""
            reset_counts()
            t = time.perf_counter()
            st, loss = fn()
            float(loss)
            host_us = (time.perf_counter() - t) * 1e6 / n
            if all_counts() != want:
                raise RuntimeError(f"{label} {name} epoch launches {all_counts()}, "
                                   f"expected {want}")
            if name == "captured":
                replayed.update(all_counts())
            return st, loss, host_us

        warm = counted(lambda: runner.run(state, draws), "warm-up")
        rec.state = warm[0]
        start, start_draws = train_snapshot(params, opt, warm[0]), draws.get_state()
        draw = check_epoch_draw(f"{label} phase {phase}", graph, batch, start_draws)

        def from_start(name, fn):
            """GRAPHED_REPEATS consecutive epochs of ``fn(state)`` from
            the start: (snapshot, loss) and host µs a step of each, the
            generator's state after them."""
            put_back(params, opt, start)
            draws.set_state(start_draws)
            st, snaps, hosts = dict(start[2]), [], []
            for k in range(GRAPHED_REPEATS):
                if k:
                    st = model.epoch_begin(params, st, graph,
                                           torch.Generator().manual_seed(20 + k), epoch)
                    if rate_moves:
                        set_learning_rate(opt, float(opt.param_groups[0]["lr"]) * 1.05)
                st, loss, host_us = counted(lambda: fn(st), name)
                snaps.append((train_snapshot(params, opt, st), loss.clone()))
                hosts.append(host_us)
            return snaps, hosts, draws.get_state()

        def captured(st):
            return runner.run(st, draws)

        def eager(st):
            return train_epoch(model, opt, graph, params, st, draws, batch,
                               placement=rec._placement)

        got, want_run = from_start("captured", captured), from_start("eager", eager)
        diff = {f"captured_vs_eager_{k}": snapshot_diff(g[0], w[0], g[1], w[1])
                for k, (g, w) in enumerate(zip(got[0], want_run[0]))}
        if not torch.equal(got[2], want_run[2]):
            diff["generator_state"] = ["differs"]
        words_only = torch.Generator(device="cuda")
        words_only.set_state(start_draws)
        for _ in range(GRAPHED_REPEATS):
            epoch_words(words_only, graph, batch)
        past_words = not torch.equal(got[2], words_only.get_state())
        masks = (draws_masks if draws_masks is not None else
                 model_name not in GRAPHED_ZOO_DRAWLESS and (model_name, phase) != ("esrf", 0))
        losses = [float(loss) for _, loss in got[0]]
        rates = [[float(g["lr"]) for g in snap[3] if "lr" in g] for snap, _ in got[0]]
        if (any(diff.values()) or not all(math.isfinite(x) for x in losses)
                or torch.equal(got[2], start_draws) or past_words != masks
                or (rate_moves and rates[0] == rates[-1])):
            raise RuntimeError(f"{label} phase {phase}: the epochs differ: {diff}, losses "
                               f"{losses}, the generator moved past the words: {past_words}")
        out["phases"][phase] = {
            "epoch": epoch, "same_bits": sorted(diff), "losses": losses, "epoch_draw": draw,
            "generator_moved_past_the_words": past_words, "launches_per_epoch": want,
            "warm_up_host_us_per_step": warm[2],
            "host_us_per_step": {"eager": want_run[1], "captured": got[1]},
            "rates": rates}
    put_back(params, opt, start)
    draws.set_state(start_draws)
    reset_counts()
    prof = device_profile(lambda: captured(dict(start[2]))[1], n)
    replayed.update(all_counts())
    if prof["htod_copies"]:
        raise RuntimeError(f"{label}: a replayed epoch copied from the host: "
                           f"{prof['htod_copies']} copies")
    dev, timing = prof["device_us_per_step"], {}
    for mode, hosts in (("eager", want_run[1]), ("captured", got[1])):
        host = float(np.median(hosts))
        timing[mode] = {"host_us_per_step": host, "device_idle_share": (
            1.0 - dev / host if isinstance(dev, float) else dev)}
        if isinstance(dev, float):
            timing[mode]["device_busy_idle_share"] = 1.0 - prof["device_busy_us_per_step"] / host
    out.update(timing, device=prof, captures=runner.captures,
               replayed_launches={k: v for k, v in replayed.items() if v},
               seconds=time.perf_counter() - t0)
    GRAPHED.append(out)
    print(f"graphed: {label}: {sum(len(p['same_bits']) for p in out['phases'].values())} "
          f"comparisons bit for bit in phases {sorted(out['phases'])}; host us/step eager "
          f"{timing['eager']['host_us_per_step']:.1f} captured "
          f"{timing['captured']['host_us_per_step']:.1f}; device us/step {dev} (busy "
          f"{prof.get('device_busy_us_per_step')}); idle eager "
          f"{timing['eager']['device_idle_share']} captured "
          f"{timing['captured']['device_idle_share']}; capture s "
          f"{[round(c['seconds'], 3) for c in runner.captures]}, pool MB "
          f"{[round(c['pool_bytes'] / 2**20, 1) for c in runner.captures]}; "
          f"{out['seconds']:.1f} s")
    del rec, runner, model, params, opt
    torch.cuda.empty_cache()
    return out


def graphed_fused_check(data, graph):
    """A fused block of two epochs (``eval.interval`` 2, its losses read
    once) against two unfused epochs, both captured, and against the eager
    trainer (``train_epoch`` from the same device generator): the same
    tables, moments, losses, evaluations, launches and generator state."""
    runs = {}
    for mode in (False, "auto", "eager"):
        config = default_config(**{
            "embedding.size": EMB, "LightGCN.n_layers": LAYERS, "batch.size": BATCH,
            "learning.rate": LR, "optimizer": "adam", "max.epoch": 2, "eval.interval": 2,
            "item.ranking.topN": [20], "graph.compute_dtype": graph.compute_dtype,
            "train.fuse_epochs": "auto" if mode == "auto" else False})
        rec = GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                               log=Log(echo=False), device="cuda")
        rec.build()
        if mode == "eager":
            rec._graphed = None  # the eager loop: the reference
        reset_counts()
        rec.train()
        torch.cuda.synchronize()
        runs[mode] = (rec, all_counts())
    (fused, fused_launches), (unfused, unfused_launches) = runs["auto"], runs[False]
    lines = fused.log.contents()
    snap = {k: train_snapshot(r.params, r.optimizer, r.state) for k, (r, _) in runs.items()}
    losses = [[e["loss"] for e in r.epoch_stats] for r, _ in runs.values()]
    diff = {other: snapshot_diff(snap["auto"], snap[other], torch.zeros(()), torch.zeros(()))
            for other in (False, "eager")}
    recs = [r for r, _ in runs.values()]
    if (any(diff.values()) or any(x != losses[0] for x in losses)
            or any(r.history != fused.history for r in recs)
            or any(not torch.equal(r._draws.get_state(), fused._draws.get_state()) for r in recs)
            or any(launches != fused_launches for _, launches in runs.values())
            or not fused._can_fuse_epochs() or sum("fused x2" in line for line in lines) != 2):
        raise RuntimeError(f"the fused block differs from two epochs: {diff}, losses {losses}, "
                           f"launches {fused_launches} / {unfused_launches} / "
                           f"{runs['eager'][1]}")
    out = {"config": "lightgcn dense float32, eval.interval 2", "fused_epochs": 2,
           "same_bits": {str(k): v for k, v in diff.items()}, "losses": losses[0],
           "launches": fused_launches, "captures": fused._graphed.captures}
    print(f"graphed: fused block of 2 epochs equals 2 captured and 2 eager epochs: "
          f"{out['losses']}")
    return out


T_START = time.perf_counter()
PHASES = {}  # phase -> seconds since the start when it ended


def stamp(name):
    """Record (and print to stderr) when a phase ended and its seconds: the
    script's time budget is read from these."""
    now = time.perf_counter() - T_START
    took = now - max(PHASES.values(), default=0.0)
    PHASES[name] = now
    print(f"chip_smoke: {name} done at {now:.1f} s ({took:.1f} s)", file=sys.stderr, flush=True)


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
    lse_wide = kernel_phase_lse_wide(data.item_num)
    for row in lse_rows:
        for d, wide in lse_wide.items():
            row[f"wide_{d}"] = {"shape": wide["shape"], **wide[row["name"]]}
    stamp("kernels")
    one_step = one_step_check(graphs, params)
    ncl_one_step = ncl_one_step_check(graphs, params)
    ncl_one_step[f"float32_d{NCL_WIDE_D}"] = ncl_wide_one_step(graphs[torch.float32])

    stamp("one_step")
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

    stamp("serve")
    training = []
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        launches, stats = train_phase(name, data)
        rows[dtype]["launches"] = launches["chain_mean"]
        rows[dtype]["launches_train"] = launches["chain_mean"]
        bwd_rows[dtype]["launches"] = launches["chain_mean_bwd"]
        bwd_rows[dtype]["launches_train"] = launches["chain_mean_bwd"]
        stats["card"] = card
        training.append(stats)

    stamp("train")
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

    stamp("ncl")
    t_graphed = time.perf_counter()
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        graphed_check(f"lightgcn dense {name}", "lightgcn", data, graphs[dtype], BATCH)
    graphed_check("ncl dense float32", "ncl", data, graphs[torch.float32], BATCH)
    fused = graphed_fused_check(data, graphs[torch.float32])
    graphed_dense_s = time.perf_counter() - t_graphed

    stamp("graphed_dense")
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

    stamp("large")
    (clustered_info, clustered_one_step, clustered_runs, bucketed_zoo,
     clustered_nb, (int8, q1_row, p1_int8_row, fused_row), sharded) = clustered_phase()
    for run in clustered_runs:
        for row in lse_rows + [k7_row, p1_row]:
            row["launches"] += run["launches"][row["name"]]
            row[f"launches_clustered_{run['model']}"] = run["launches"][row["name"]]
        run["card"] = card
    for dtype, run in int8["train"].items():
        for row in (k7_row, p1_row):
            row["launches"] += run["launches"][row["name"]]
            row[f"launches_clustered_lightgcn_d{INT8_D}_{dtype}"] = run["launches"][row["name"]]
        run["card"] = card
    for row in (q1_row, p1_int8_row, fused_row):
        row["card"] = card
    hard, zoo, hard_nb = hard_phase()
    stamp("hard")
    for run in hard["train"] + zoo["train"] + list(bucketed_zoo.values()) + hard_nb["train"]:
        run["card"] = card
    add_zoo_launches((rows[torch.float32], bwd_rows[torch.float32]), (k7_row, p1_row), zoo,
                     bucketed_zoo)
    p2_row = segment_sum_row(clustered_nb, card)
    add_neighbor_launches(k7_row, p1_row, p2_row, hard_nb, clustered_nb)
    social = social_phase(card)
    stamp("social")
    add_social_launches(k7_row, p1_row, social)
    dense_lightgcn = hard_nb["lightgcn_backends"]["runs"][0]["launches"]
    for row in (rows[torch.float32], bwd_rows[torch.float32]):
        row["launches"] += dense_lightgcn[row["name"]]
        row["launches_hard_lightgcn_dense"] = dense_lightgcn[row["name"]]
    seg_rows = segment_kernel_rows(hard_nb, clustered_nb, card)
    kernel_rows = (list(rows.values()) + list(bwd_rows.values()) + list(layer_rows.values())
                   + list(layer_bwd_rows.values()) + lse_rows + [k7_row, p1_row, p2_row]
                   + seg_rows + [q1_row, p1_int8_row, fused_row])
    add_sharded_launches(kernel_rows, sharded)
    add_graphed_launches(kernel_rows)
    for row in kernel_rows:
        if row.get("library_ms") is None:
            row["library_note"] = LIBRARY_NOTES.get(row["name"], "not measured in this run")
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
    print(json.dumps({"social": social}))
    print(json.dumps({"int8": int8}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"graphed": {
        "card": card, "repeats": GRAPHED_REPEATS, "configs": GRAPHED, "fused": fused,
        "seconds": graphed_dense_s + sum(c["seconds"] for c in GRAPHED[3:]),
        "zoo_seconds": sum(c["seconds"] for c in GRAPHED if "phases" in c),
        "script_seconds": time.perf_counter() - T_START, "phases_at_s": PHASES,
        "phase_seconds": dict(zip(PHASES, np.diff([0.0] + list(PHASES.values())).tolist()))}}))
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-checks"]:  # one rank of the sharded phase's checks
        sharded_checks_worker(*sys.argv[2:5])
        raise SystemExit(0)
    if sys.argv[1:2] == ["--sharded-data"]:  # one rank of the (2, 1) world
        sharded_data_worker(*sys.argv[2:5])
        raise SystemExit(0)
    if sys.argv[1:2] == ["--sharded-nccl"]:  # the rank of the (1, 1) world
        sharded_nccl_worker(*sys.argv[2:5])
        raise SystemExit(0)
    raise SystemExit(main())
