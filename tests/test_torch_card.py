"""Kernels K1 and K2 (``csrc/chain_mean.cu``) against their plain versions,
on the card; ``ChainMean``'s gradient on the card; one training step
through the kernels against the same step through the plain chain. The
same for NCL's kernels: K3 and K4 (``csrc/chain_mean.cu``), K5 and K6
(``csrc/catalog_lse.cu``), ``ChainMeanLayer``'s and ``CatalogLSE``'s
gradients, and one NCL step with the layer contrast at unit weight; K1-K6
repeat bit for bit, across their reduction slices, tiles and splits (K5 up
to a 100,000-item catalog; K6's two sides against their split arithmetic,
up to B = 8192 against 100,000 items with its workspace bounded). And for
the bucketed backend's kernels (``csrc/gather.cu``): K7, the row gather,
bit for bit; each variant of P1, the bucket pull, its epilogue's too,
against its plain version and against itself; ``BucketedChainMean``'s gradient on the card; one LightGCN step on
a bucketed graph; one DirectAU step on a bucketed graph (P1's value path);
one step of each zoo model that reaches a kernel (SelfCF dense through
K1/K2 and bucketed through K7/P1; BUIR, GCL and BGRL bucketed, P1's value
path) against its plain path on the same masks. The segment kernels
(``csrc/segment.cu``): S1 (the multi-head weighted pull) and S2 (the
segment softmax and its backward, on given logits and with GAT's logits,
dropout scale, slope and mask fused in) against their plain versions and
bit for bit across two calls, on a segment view with split hub rows, on
bucket rows, and at head counts 1 to 12 on rows that are empty, hold no
live slot, fit one work item or split into many pieces; S1 at every group
width and head count with a hub row of 12,000 slots; S1 with the head dot
(S3 folded into the transpose pull) against its plain version on both GAT
structures and at heads of 130 and 1024 f32, the forward slots no live
slot reaches exactly 0; K5 and K6 at d = 1024; one step of GAT (dense,
segment and bucketed backends, and at 3 heads and a hidden width of 1024
against the plain path in float64), GraphSAGE, LightGCN on the segment
backend and GRACE and G-BT on a bucketed graph against their plain paths.
P2, the pull over a row-sorted view (``csrc/segment_sum.cu``), bit for bit
against P1 over the same view and itself and against its plain version, on
a view with empty rows, rows of 1 to 128 slots and split hub rows, at d = 1
to 1000, with and without values and row scales, over row cuts and on two
streams. The social models: one step of DiffNet and of MHCN on a bucketed
and on a segment ``SocialDeviceGraph`` (P1 and K7, or P2, over the trust
matrix, the motif channels and the rectangular [U, I]
``interaction_norm``, both ways) against the plain COO product in
float64, and the rectangular pull and its transpose against their plain
versions.
The int8 path of the bucketed backend: Q1 (the row quantizer) bit for bit
against its plain version at d = 250, 256 and 1024, with and without its
pre-scale, and P1 with an int8 source against its plain version (the
separable and the value path, node and row space, split rows); the int8
chain's fused layer (P1's int8 epilogue: the running sum and the next
layer's codes) bit for bit against P1, Q1 and an add in three launches,
at the clustered tables and on split rows, d = 250 to 1024.
Calls on two streams at once equal the same calls in turn (the chain's tile
counters, P1's, S1's and S2's piece counters, K5's and K6's partials, the
fused pull's dot, P1's int8 source, its fused layer and Q1).
NCL's k-means (Lloyd and mini-batch) twice on the same rows gives the same
bits (the sorted segment sums, no atomics).
The epoch as CUDA graphs (``train/graphed.py``): a replayed epoch (whole
or chunked) of LightGCN (dense, bucketed, segment) and NCL (dense,
bucketed) equals the eager epoch bit for bit, its replay adding the
epoch's launches; a trainer captures again after a checkpoint restore;
the trainer's captured epochs equal its eager ones with the bold
driver's rate moving, in fused blocks and in chunks; the card's
capturable Adam holds optax's arithmetic (``train.loop.adam_plain``).

These tests need a CUDA device and ``nvcc``; elsewhere they skip. This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import (
    ArrayInteraction,
    make_clustered_interactions,
    make_flat_interactions,
    make_synthetic_dataset,
)
from recommendation_tpu_torch.graph.bucketed import (
    bucketed_chain_mean,
    bucketed_chain_mean_plain,
    packer,
)
from recommendation_tpu_torch.data.social import synthesize_social
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.bgrl import PlainBucketedBGRL
from recommendation_tpu_torch.models.buir import PlainBucketedBUIR
from recommendation_tpu_torch.models.directau import PlainBucketedDirectAU
from recommendation_tpu_torch.models.gat import PlainGAT, attention_structure
from recommendation_tpu_torch.models.graphsage import PlainGraphSAGE
from recommendation_tpu_torch.models.gcl import PlainBucketedGCL
from recommendation_tpu_torch.models.selfcf import PlainSelfCF
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.ops.gather import (
    gather_rows,
    gather_sum,
    gather_sum_plain,
    pull_schedule,
    quantize_rows,
    quantize_rows_plain,
)
from recommendation_tpu_torch.ops.lse import (
    CatalogLSE,
    catalog_lse,
    catalog_lse_bwd,
    catalog_lse_bwd_plain,
    catalog_lse_bwd_split_plain,
    catalog_lse_plain,
    catalog_lse_split_plain,
    lse_bwd_plan,
    lse_bwd_workspace,
    lse_fwd_plan,
)
from recommendation_tpu_torch.ops.prop import (
    ChainMean,
    ChainMeanLayer,
    chain_mean,
    chain_mean_bwd,
    chain_mean_bwd_plain,
    chain_mean_layer,
    chain_mean_layer_bwd,
    chain_mean_layer_bwd_plain,
    chain_mean_layer_plain,
    chain_mean_plain,
)
from recommendation_tpu_torch.ops.kmeans import (
    _segment_sums,
    kmeans,
    kmeans_batches,
    kmeans_init,
    kmeans_minibatch,
)
from recommendation_tpu_torch.ops import segment as seg_ops
from recommendation_tpu_torch.ops import spmm
from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
from recommendation_tpu_torch.train.loop import make_optimizer, run_steps

pytestmark = pytest.mark.cuda

# the JAX kernel's own test bounds (tests/test_pallas_prop.py), values and grads
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _check_against_plain(r, u0, i0, n_layers, tol):
    before = chain_mean.launches
    got = chain_mean(r, u0, i0, n_layers)
    torch.cuda.synchronize()
    assert chain_mean.launches == before + n_layers
    want = chain_mean_plain(r, u0, i0, n_layers)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 53, 8), (5, 3, 130)])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_kernel_matches_plain_unaligned(card, dtype, shape, n_layers):
    """Random O(1) inputs at ragged shapes, as the JAX kernel's own test."""
    n_u, n_i, d = shape
    rng = np.random.default_rng(n_u + n_i + d + n_layers)
    r = torch.from_numpy(rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1).to(card, dtype)
    u0 = torch.from_numpy(rng.normal(size=(n_u, d)).astype(np.float32)).to(card)
    i0 = torch.from_numpy(rng.normal(size=(n_i, d)).astype(np.float32)).to(card)
    _check_against_plain(r, u0, i0, n_layers, TOL[dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 3])
def test_kernel_matches_plain_on_a_graph(card, compute_dtype, n_layers):
    """A real normalized R̂ (the propagation stays bounded, as in serving)
    with LightGCN's xavier init: f32 holds rtol 1e-5 / atol 1e-6 whatever
    the order of the sums."""
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    graph = DeviceGraph(Interaction(train, test), compute_dtype=compute_dtype, device=card)
    params, _ = build("lightgcn", default_config()).init(torch.Generator().manual_seed(1), graph)
    _check_against_plain(graph.propagation_matrix, params["user_emb"], params["item_emb"],
                         n_layers, TOL[graph.propagation_matrix.dtype])


def test_kernel_refuses_what_it_does_not_take(card):
    r = torch.zeros(4, 3, device=card)
    u0, i0 = torch.zeros(4, 2, device=card), torch.zeros(3, 2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        chain_mean(r.T.contiguous().T, u0, i0, 1)
    with pytest.raises(ValueError, match="devices"):
        chain_mean(r, u0.cpu(), i0, 1)
    with pytest.raises(TypeError):
        chain_mean(r.half(), u0, i0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 53, 8), (5, 3, 130)])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_backward_kernel_matches_plain(card, dtype, shape, n_layers):
    """K2 on random O(1) inputs at ragged shapes."""
    n_u, n_i, d = shape
    rng = np.random.default_rng(n_u * n_i + d + n_layers)
    r = torch.from_numpy(rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1).to(card, dtype)
    gu = torch.from_numpy(rng.normal(size=(n_u, d)).astype(np.float32)).to(card)
    gi = torch.from_numpy(rng.normal(size=(n_i, d)).astype(np.float32)).to(card)
    before = chain_mean_bwd.launches
    got = chain_mean_bwd(r, gu, gi, n_layers)
    torch.cuda.synchronize()
    assert chain_mean_bwd.launches == before + n_layers
    for g, w in zip(got, chain_mean_bwd_plain(r, gu, gi, n_layers)):
        assert g.is_cuda and g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **GRAD_TOL[dtype])


def _grads_close(got, want, dtype, floor=0.0):
    """GRAD_TOL with its atol relative to the reference's largest entry: the
    JAX bounds are for O(1) cotangents, a batch-mean loss's gradients are of
    order 1/B. ``floor`` adds an absolute term (rounding of what the values
    were computed from)."""
    tol = GRAD_TOL[dtype]
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        atol = tol["atol"] * scale + floor
        if not (scale > 0 and torch.allclose(g, w, rtol=tol["rtol"], atol=atol)):
            return False
    return True


def _graph(card, compute_dtype):
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    return DeviceGraph(Interaction(train, test), compute_dtype=compute_dtype, device=card)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chain_mean_has_a_gradient_on_the_card(card, compute_dtype):
    """The regression test for the port's first fault: ``chain_mean`` writes
    its outputs through ctypes, so alone it carries no gradient on the
    card; ``ChainMean`` gives it one, through K2."""
    graph = _graph(card, compute_dtype)
    params, _ = build("lightgcn", default_config()).init(torch.Generator().manual_seed(2), graph)
    u0 = params["user_emb"].requires_grad_()
    i0 = params["item_emb"].requires_grad_()
    r = graph.propagation_matrix
    assert not chain_mean(r, u0, i0, 3)[0].requires_grad
    before = chain_mean_bwd.launches
    a, b = ChainMean.apply(r, u0, i0, 3)
    assert a.grad_fn is not None and b.grad_fn is not None
    (a.square().sum() + b.sin().sum()).backward()
    torch.cuda.synchronize()
    assert chain_mean_bwd.launches == before + 3
    u1 = u0.detach().clone().requires_grad_()
    i1 = i0.detach().clone().requires_grad_()
    pa, pb = chain_mean_plain(r, u1, i1, 3)
    (pa.square().sum() + pb.sin().sum()).backward()
    tol = GRAD_TOL[r.dtype]
    torch.testing.assert_close(u0.grad, u1.grad, **tol)
    torch.testing.assert_close(i0.grad, i1.grad, **tol)


class _PlainLightGCN(LightGCN):
    """LightGCN with the plain chain (autograd through torch ops) in place
    of ChainMean."""

    def propagate(self, params, graph):
        return chain_mean_plain(graph.propagation_matrix, params["user_emb"],
                                params["item_emb"], self.n_layers)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_training_step_kernel_vs_plain(card, compute_dtype):
    """One step's loss and gradients through K1 + K2 against the plain
    chain's, then two SGD steps of the trainer's loop on each, from the same
    parameters and batches (SGD: an update proportional to the gradient, so
    the updates stay as close as the gradients are, up to the f32 rounding of
    the parameters; the rate is large enough that an update is far above
    that rounding). The bounds reject zero gradients and zero updates."""
    graph = _graph(card, compute_dtype)
    config = default_config(**{"batch.size": 512, "optimizer": "sgd", "learning.rate": 10.0})
    models = (build("lightgcn", config), _PlainLightGCN(config))
    init, _ = models[0].init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 512), graph, 512)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    window = (users[:2], items[:2], negs[:2], weights[:2], 2)
    out = []
    for m in models:
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        k1, k2 = chain_mean.launches, chain_mean_bwd.launches
        loss, _ = m.loss(p, {}, batch, graph)
        grads = torch.autograd.grad(loss, list(p.values()))
        run_steps(m, make_optimizer(config, p), graph, p, {}, window)
        torch.cuda.synchronize()
        out.append((loss.item(), grads, p, chain_mean.launches - k1, chain_mean_bwd.launches - k2))
    (loss_k, g_k, p_k, n1, n2), (loss_p, g_p, p_p, m1, m2) = out
    assert (n1, n2, m1, m2) == (9, 9, 0, 0)  # 3 steps x L=3 through the kernels
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 + 1e-5 * abs(loss_p)
    dtype = graph.propagation_matrix.dtype
    assert _grads_close(g_k, g_p, dtype)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, dtype)
    steps_k = [p_k[k].detach() - init[k] for k in init]
    steps_p = [p_p[k].detach() - init[k] for k in init]
    rounding = 4 * torch.finfo(torch.float32).eps * max(v.abs().max().item() for v in init.values())
    assert min(s.abs().max().item() for s in steps_p) > 100 * rounding
    assert _grads_close(steps_k, steps_p, dtype, floor=rounding)
    assert not _grads_close([torch.zeros_like(s) for s in steps_p], steps_p, dtype, floor=rounding)


# -- NCL's kernels: K3, K4 (chain with a layer), K5, K6 (catalog logsumexp) ---

LAYER_CASES = [(3, 1), (3, 2), (3, 3), (1, 1)]


def _random(card, rng, *shapes):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(card) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 53, 8), (5, 3, 130)])
@pytest.mark.parametrize("n_layers,k", LAYER_CASES)
def test_layer_kernels_match_plain(card, dtype, shape, n_layers, k):
    """K3's four outputs and K4's two on random O(1) inputs at ragged shapes."""
    n_u, n_i, d = shape
    rng = np.random.default_rng(n_u + n_i + d + 10 * n_layers + k)
    r = torch.from_numpy(rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1).to(card, dtype)
    u0, i0, gu, gi, gku, gki = _random(card, rng, (n_u, d), (n_i, d), (n_u, d), (n_i, d),
                                       (n_u, d), (n_i, d))
    before = chain_mean_layer.launches, chain_mean_layer_bwd.launches
    got = chain_mean_layer(r, u0, i0, n_layers, k)
    got_b = chain_mean_layer_bwd(r, gu, gi, gku, gki, n_layers, k)
    torch.cuda.synchronize()
    assert (chain_mean_layer.launches, chain_mean_layer_bwd.launches) == (
        before[0] + n_layers, before[1] + n_layers)
    for g, w in zip(got, chain_mean_layer_plain(r, u0, i0, n_layers, k)):
        assert g.is_cuda and g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL[dtype])
    for g, w in zip(got_b, chain_mean_layer_bwd_plain(r, gu, gi, gku, gki, n_layers, k)):
        torch.testing.assert_close(g, w, **GRAD_TOL[dtype])


def _unit_rows(card, rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(card)


# K5/K6 on l2-normalized rows (what NCL feeds them), τ = 0.1: scores within
# ±10. The kernel and the plain version sum each score's d products in
# another order, which moves a score by about 1e-6, exp(s - lse) by as much
# relatively, and the sums over N or B terms keep that relative size.
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
LSE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,n,d", [(2048, 943, 64), (2048, 1675, 64), (37, 700, 24),
                                   (1, 1, 1), (70, 65, 520), (300, 700, 1024), (37, 130, 600)])
def test_lse_kernels_match_plain(card, b, n, d):
    """K5 and K6 against their plain versions, past K6's one 512-column
    slab too (520, 600 and 1024: two slabs)."""
    rng = np.random.default_rng(b + n + d)
    q, x = _unit_rows(card, rng, b, d), _unit_rows(card, rng, n, d)
    (g,) = _random(card, rng, (b,))
    before = catalog_lse.launches, catalog_lse_bwd.launches
    lse = catalog_lse(q, x, 0.1)
    dq, dx = catalog_lse_bwd(q, x, 0.1, lse, g)
    torch.cuda.synchronize()
    assert (catalog_lse.launches, catalog_lse_bwd.launches) == (
        before[0] + catalog_lse.launches_per_call, before[1] + catalog_lse_bwd.launches_per_call)
    want = catalog_lse_plain(q, x, 0.1)
    assert lse.shape == (b,) and lse.is_cuda
    torch.testing.assert_close(lse, want, **LSE_TOL)
    for got, w in zip((dq, dx), catalog_lse_bwd_plain(q, x, 0.1, want, g)):
        assert got.shape == w.shape
        torch.testing.assert_close(got, w, **LSE_GRAD_TOL)


def test_lse_kernels_on_gaussian_inputs(card):
    """The JAX kernel's own test inputs (normal q, x; τ = 0.5) and bound."""
    rng = np.random.default_rng(0)
    q, x = _random(card, rng, (8, 16), (300, 16))
    torch.testing.assert_close(catalog_lse(q, x, 0.5), catalog_lse_plain(q, x, 0.5),
                               rtol=0, atol=1e-4)
    qa, xa = q.clone().requires_grad_(), x.clone().requires_grad_()
    torch.sum(CatalogLSE.apply(qa, xa, 0.5) ** 2).backward()
    qp, xp = q.clone().requires_grad_(), x.clone().requires_grad_()
    torch.sum(catalog_lse_plain(qp, xp, 0.5) ** 2).backward()
    torch.testing.assert_close(qa.grad, qp.grad, rtol=0, atol=1e-3)
    torch.testing.assert_close(xa.grad, xp.grad, rtol=0, atol=1e-3)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_layer_and_lse_functions_have_gradients_on_the_card(card, compute_dtype):
    graph = _graph(card, compute_dtype)
    params, _ = build("ncl", default_config()).init(torch.Generator().manual_seed(2), graph)
    u0 = params["user_emb"].requires_grad_()
    i0 = params["item_emb"].requires_grad_()
    outs = ChainMeanLayer.apply(graph.propagation_matrix, u0, i0, 3, 2)
    assert all(o.grad_fn is not None for o in outs)
    q = torch.nn.functional.normalize(outs[2][:64], dim=1)
    lse = CatalogLSE.apply(q, torch.nn.functional.normalize(i0[:500], dim=1), 0.1)
    assert lse.grad_fn is not None
    before = chain_mean_layer_bwd.launches, catalog_lse_bwd.launches
    (lse.sum() + outs[0].square().sum() + outs[3].sin().sum()).backward()
    torch.cuda.synchronize()
    assert (chain_mean_layer_bwd.launches, catalog_lse_bwd.launches) == (
        before[0] + 3, before[1] + catalog_lse_bwd.launches_per_call)
    assert torch.isfinite(u0.grad).all() and i0.grad.abs().max() > 0


class _PlainNCL(NCL):
    """NCL with the plain chain and the plain logsumexp (autograd through
    torch ops) in place of ChainMeanLayer and CatalogLSE."""

    def _chain_layer(self, r, u0, i0, k):
        return chain_mean_layer_plain(r, u0, i0, self.n_layers, k)

    def _catalog_lse(self, q, x):
        return catalog_lse_plain(q, x, self.ssl_temp)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_ncl_step_kernel_vs_plain(card, compute_dtype):
    """One NCL loss with the layer contrast at unit weight: K3, K4, K5 and
    K6 on the path; gradients against the plain path's, the bound rejecting
    zeros."""
    graph = _graph(card, compute_dtype)
    config = default_config(**{"batch.size": 512, "NCL.ssl_reg": 1.0, "NCL.proto_reg": 1.0})
    models = (build("ncl", config), _PlainNCL(config))
    init, state = models[0].init(torch.Generator().manual_seed(3), graph)
    state = models[0].epoch_begin(init, state, graph, torch.Generator().manual_seed(5), 0)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 512), graph, 512)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    out = []
    for m in models:
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        counts = (chain_mean_layer.launches, chain_mean_layer_bwd.launches,
                  catalog_lse.launches, catalog_lse_bwd.launches)
        loss, _ = m.loss(p, state, batch, graph)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out.append((loss.item(), grads, (chain_mean_layer.launches - counts[0],
                                         chain_mean_layer_bwd.launches - counts[1],
                                         catalog_lse.launches - counts[2],
                                         catalog_lse_bwd.launches - counts[3])))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    assert n_k == (3, 3, 2 * catalog_lse.launches_per_call,
                   2 * catalog_lse_bwd.launches_per_call) and n_p == (0, 0, 0, 0)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    dtype = graph.propagation_matrix.dtype
    assert _grads_close(g_k, g_p, dtype)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, dtype)


# -- repeatability and the redesigned tiles: K1-K4 (reduction slices), K6 ----


def _graph_like(rng, n_u, n_i, density=0.05):
    """A normalized random bipartite R̂ (non-negative, as the graph's)."""
    a = (rng.random((n_u, n_i)) < density).astype(np.float32)
    a[np.arange(n_u), rng.integers(0, n_i, n_u)] = 1.0  # no empty row
    du, di = a.sum(1), a.sum(0)
    di[di == 0] = 1.0
    return a / np.sqrt(du)[:, None] / np.sqrt(di)[None, :]


def _plan(card, r, d):
    from recommendation_tpu_torch.ops import prop

    lib = prop._kernel_lib()
    return prop.chain_plan(r.shape[0], r.shape[1], d,
                           prop._slots(lib, card, r.dtype == torch.bfloat16))


def _four_kernels(r, t, n_layers=3, k=2):
    u0, i0, gu, gi, gku, gki = t
    return {
        "K1": lambda: chain_mean(r, u0, i0, n_layers),
        "K2": lambda: chain_mean_bwd(r, gu, gi, n_layers),
        "K3": lambda: chain_mean_layer(r, u0, i0, n_layers, k),
        "K4": lambda: chain_mean_layer_bwd(r, gu, gi, gku, gki, n_layers, k),
    }


def _plain_four(r, t, n_layers=3, k=2):
    u0, i0, gu, gi, gku, gki = t
    return {
        "K1": chain_mean_plain(r, u0, i0, n_layers),
        "K2": chain_mean_bwd_plain(r, gu, gi, n_layers),
        "K3": chain_mean_layer_plain(r, u0, i0, n_layers, k),
        "K4": chain_mean_layer_bwd_plain(r, gu, gi, gku, gki, n_layers, k),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chain_kernels_repeat_bit_for_bit(card, dtype):
    """K1-K4 on a graph's R̂ with its padded rows: the slices' partial sums
    are added in slice order by whichever block finishes last, so two calls
    give the same bits."""
    graph = _graph(card, "bfloat16" if dtype == torch.bfloat16 else "float32")
    r = graph.propagation_matrix
    rng = np.random.default_rng(21)
    t = _random(card, rng, *[(n, 64) for n in (r.shape[0], r.shape[1]) * 3])
    assert _plan(card, r, 64).slices_u > 1  # the combine runs
    for name, fn in _four_kernels(r, t).items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,many", [((5, 3, 130), False), ((40, 3000, 8), True)],
                         ids=["shorter-than-a-slice", "many-slices"])
def test_chain_kernels_across_slices(card, dtype, shape, many):
    """A reduction shorter than one slice (no partial sums) and one cut into
    many slices (94 on the user side): K1-K4 against their plain versions,
    and two calls equal bit for bit. Non-negative tables on a normalized R̂,
    so the sums do not cancel and f32 holds TOL in any order."""
    n_u, n_i, d = shape
    rng = np.random.default_rng(n_u + n_i + d)
    r = torch.from_numpy(_graph_like(rng, n_u, n_i)).to(card, dtype)
    t = [torch.from_numpy(rng.random(s).astype(np.float32)).to(card)
         for s in [(n_u, d), (n_i, d)] * 3]
    plan = _plan(card, r, d)
    assert (plan.slices_u > 8) if many else (plan.slices_u == plan.slices_i == 1)
    want = _plain_four(r, t)
    for name, fn in _four_kernels(r, t).items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), name
        tol = GRAD_TOL[dtype] if name in ("K2", "K4") else TOL[dtype]
        for g, w in zip(first, want[name]):
            torch.testing.assert_close(g, w, **tol)


@pytest.mark.parametrize("d", [1, 24, 64, 130, 512, 1024])
@pytest.mark.parametrize("b,n", [(70, 130), (1, 700), (200, 40)],
                         ids=["ragged", "one-query", "under-one-item-tile"])
def test_lse_backward_across_tiles(card, b, n, d):
    """K6 where B and N are not multiples of its 64-row tiles, N is below
    one tile, B is 1, and d is cut into 64-column slices (130, 512), into
    two 512-column slabs (1024) or below one slice (1, 24): dq and dx
    against the plain version, and two calls equal bit for bit."""
    rng = np.random.default_rng(b + n + d)
    q, x = _unit_rows(card, rng, b, d), _unit_rows(card, rng, n, d)
    (g,) = _random(card, rng, (b,))
    lse = catalog_lse_plain(q, x, 0.1)
    before = catalog_lse_bwd.launches
    first = catalog_lse_bwd(q, x, 0.1, lse, g)
    second = catalog_lse_bwd(q, x, 0.1, lse, g)
    torch.cuda.synchronize()
    assert catalog_lse_bwd.launches == before + 2 * catalog_lse_bwd.launches_per_call
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    for got, w in zip(first, catalog_lse_bwd_plain(q, x, 0.1, lse, g)):
        assert got.shape == w.shape
        torch.testing.assert_close(got, w, **LSE_GRAD_TOL)


@pytest.mark.parametrize("b,n,d", [(2048, 943, 64), (2048, 1675, 64), (37, 700, 24),
                                   (2048, 100_000, 64), (70, 130, 130), (200, 3000, 1024)])
def test_lse_forward_across_splits(card, b, n, d):
    """K5 at NCL's two step shapes, a ragged one, a 100,000-item catalog (a
    split of 196 item tiles) and d past one 64-column slice: against the
    plain version and against its own split arithmetic in plain torch, two
    calls equal bit for bit, and launches_per_call launches a call."""
    from recommendation_tpu_torch.ops import lse as lse_mod

    rng = np.random.default_rng(b + n + d)
    q, x = _unit_rows(card, rng, b, d), _unit_rows(card, rng, n, d)
    w, splits = lse_fwd_plan(b, n, lse_mod._slots(lse_mod._kernel_lib(), "fwd", card, d))
    before = catalog_lse.launches
    first, second = catalog_lse(q, x, 0.1), catalog_lse(q, x, 0.1)
    torch.cuda.synchronize()
    assert catalog_lse.launches == before + 2 * catalog_lse.launches_per_call
    assert torch.equal(first, second)
    torch.testing.assert_close(first, catalog_lse_plain(q, x, 0.1), **LSE_TOL)
    torch.testing.assert_close(first, catalog_lse_split_plain(q, x, 0.1, w), **LSE_TOL)
    if n == 100_000:
        assert w > 1 and splits * b * 2 * 4 <= 1 << 20  # the partials stay small


@pytest.mark.parametrize("b,n,d", [(2048, 943, 64), (2048, 1675, 64), (8192, 100_000, 64),
                                   (37, 700, 24), (70, 130, 130), (2048, 1675, 1024)])
def test_lse_backward_sides_match_their_split_arithmetic(card, b, n, d):
    """K6's two sides (query tiles walking split item tiles for dq, item
    tiles walking split query tiles for dx) at NCL's dense pair, at B = 8192
    against 100,000 items, and at ragged shapes: against the plain backward
    and the plain split arithmetic of the same plan, two calls equal bit for
    bit, and the workspace that a call takes on the card (the caching
    allocator's peak during the call less what it holds after): the plan's
    ``lse_bwd_workspace`` floats up to the allocator's rounding, at most
    max(sq, sx) x (B + N) x d floats, and at most 256 MB at the large shape
    (it was 6.55 GB with a partial per tile pair)."""
    from recommendation_tpu_torch.ops import lse as lse_mod

    rng = np.random.default_rng(b + n + d)
    q, x = _unit_rows(card, rng, b, d), _unit_rows(card, rng, n, d)
    (g,) = _random(card, rng, (b,))
    lse = catalog_lse_plain(q, x, 0.1)
    slots = lse_mod._slots(lse_mod._kernel_lib(), "bwd", card, d)
    plan = lse_bwd_plan(b, n, slots)
    before = catalog_lse_bwd.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = catalog_lse_bwd(q, x, 0.1, lse, g)
    torch.cuda.synchronize()
    taken = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    second = catalog_lse_bwd(q, x, 0.1, lse, g)
    torch.cuda.synchronize()
    assert catalog_lse_bwd.launches == before + 2 * catalog_lse_bwd.launches_per_call
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    for got, w, sp in zip(first, catalog_lse_bwd_plain(q, x, 0.1, lse, g),
                          catalog_lse_bwd_split_plain(q, x, 0.1, lse, g, plan)):
        torch.testing.assert_close(got, w, **LSE_GRAD_TOL)
        torch.testing.assert_close(got, sp, **LSE_GRAD_TOL)
    floats = lse_bwd_workspace(b, n, d, slots)
    # the allocator rounds to 512 B and leaves a segment's tail of up to 1 MB in the block
    assert floats * 4 <= taken <= floats * 4 + 511 + (1 << 20)
    assert floats <= max(plan[1], plan[3]) * (b + n) * d
    if n == 100_000:
        assert taken <= 256 * 2**20


def test_directau_bucketed_step_kernel_vs_plain(card):
    """One DirectAU step on a bucketed graph: the binarized adjacency has no
    separable scales, so the chain's P1 pulls take the value path; K7 4 and
    P1 4 launches (L = 2), no plain propagation; the loss and gradients
    against the plain chain's, the bound rejecting zeros."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=2)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="bucketed", device=card)
    config = default_config(**{"batch.size": 1024})
    models = (build("directau", config), PlainBucketedDirectAU(config))
    assert models[0]._adj(graph).pull.sep_dst is None
    init, _ = models[0].init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    out = []
    for m in models:
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        before = gather_rows.launches, gather_sum.launches
        loss, _ = m.loss(p, {}, batch, graph)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out.append((loss.item(), grads, (gather_rows.launches - before[0],
                                         gather_sum.launches - before[1])))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    assert n_k == (4, 4) and n_p == (0, 0)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 + 1e-5 * abs(loss_p)
    assert _grads_close(g_k, g_p, torch.float32)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, torch.float32)


def test_normalized_bipartite_repeats_on_the_card(card):
    """The dense re-normalized bipartite adjacency is built by scatter on
    the card: each coordinate holds one real value (the padding adds exact
    zeros) and the degrees are sums of 0/1 values, so two builds are equal
    bit for bit, and equal the CPU's build at the f32 bound."""
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    data = Interaction(train, test)
    graph, cpu = DeviceGraph(data, device=card), DeviceGraph(data, device="cpu")
    keep = (torch.rand(graph.edge_valid.shape[0], generator=torch.Generator().manual_seed(0))
            >= 0.3).float()
    a, b = (graph.normalized_bipartite(keep.to(card)).dense for _ in range(2))
    assert a.is_cuda and torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), cpu.normalized_bipartite(keep).dense,
                               **TOL[torch.float32])


# a zoo step's K1/K2 (dense) or K7/P1 (bucketed) launches at L = 2
ZOO_CASES = {
    ("selfcf", "dense", "float32"): (PlainSelfCF, {"chain_mean": 2, "chain_mean_bwd": 2}),
    ("selfcf", "dense", "bfloat16"): (PlainSelfCF, {"chain_mean": 2, "chain_mean_bwd": 2}),
    ("selfcf", "bucketed", "float32"): (PlainSelfCF, {"gather_rows": 4, "gather_sum": 4}),
    ("buir", "bucketed", "float32"): (PlainBucketedBUIR, {"gather_rows": 6, "gather_sum": 6}),
    ("gcl", "bucketed", "float32"): (PlainBucketedGCL, {"gather_rows": 8, "gather_sum": 8}),
    ("bgrl", "bucketed", "float32"): (PlainBucketedBGRL, {"gather_rows": 12, "gather_sum": 12}),
}


@pytest.mark.parametrize("name,backend,compute_dtype", list(ZOO_CASES),
                         ids=["-".join(c) for c in ZOO_CASES])
def test_zoo_step_kernel_vs_plain(card, monkeypatch, name, backend, compute_dtype):
    """One step of a zoo model through its kernels against its plain path,
    on the same parameters, batch and masks (every augmentation draw from
    one seeded host generator): the launches, the loss and the gradients
    to every parameter, the bound rejecting zeros."""
    plain_cls, want = ZOO_CASES[name, backend, compute_dtype]
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=2)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend=backend,
                        compute_dtype=compute_dtype, device=card)
    config = default_config(**{"batch.size": 1024})
    models = (build(name, config), plain_cls(config))
    init, state = models[0].init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    counters = {f.__name__: f for f in (chain_mean, chain_mean_bwd, gather_rows, gather_sum)}
    out = []
    for m in models:
        draws = torch.Generator().manual_seed(5)
        monkeypatch.setattr(augment, "uniform", lambda g, shape, device: torch.rand(
            tuple(shape), generator=draws).to(device))
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        before = {k: f.launches for k, f in counters.items()}
        loss, _ = m.loss(p, state, batch, graph, torch.Generator().manual_seed(6))
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out.append((loss.item(), grads,
                    {k: f.launches - before[k] for k, f in counters.items() if
                     f.launches != before[k]}))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    assert n_k == want and n_p == {}, (n_k, n_p, want)
    tol = TOL[dtype]
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= tol["atol"] + tol["rtol"] * abs(loss_p)
    if name == "bgrl":
        # ReLU units within an f32 rounding of their kink and whole-graph batch
        # norms: each gradient by its relative Frobenius error; the projection's
        # bias, whose exact gradient is 0 (the batch norm after it), by size
        names = list(init)
        largest = max(w.abs().max().item() for w in g_p)
        for k, g, w in zip(names, g_k, g_p):
            if k == "online.proj.b":
                assert max(g.abs().max().item(), w.abs().max().item()) < 1e-3 * largest
            else:
                assert torch.isfinite(g).all(), k
                assert torch.linalg.norm(g - w) <= 1e-2 * torch.linalg.norm(w), k
        return
    assert _grads_close(g_k, g_p, dtype)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, dtype)


def _two_calls(card, kernel):
    """Two calls of one kernel on different inputs, as functions."""
    rng = np.random.default_rng(31)
    if kernel == "chain":
        r = _graph(card, "float32").propagation_matrix
        assert _plan(card, r, 64).slices_u > 1  # the tile counters are used
        a = _random(card, rng, (r.shape[0], 64), (r.shape[1], 64))
        b = _random(card, rng, (r.shape[0], 64), (r.shape[1], 64))
        return [lambda t=t: chain_mean(r, *t, 3) for t in (a, b)]
    if kernel == "lse":
        q = [_unit_rows(card, rng, 2048, 64) for _ in range(2)]
        x = _unit_rows(card, rng, 1675, 64)
        return [lambda q=q_: [catalog_lse(q, x, 0.1)] for q_ in q]
    if kernel == "lse_bwd":
        q = [_unit_rows(card, rng, 2048, 64) for _ in range(2)]
        x = _unit_rows(card, rng, 1675, 64)
        lse = [catalog_lse_plain(q_, x, 0.1) for q_ in q]
        g = _random(card, rng, (2048,))[0]
        return [lambda q=q_, lse=l_: list(catalog_lse_bwd(q, x, 0.1, lse, g))
                for q_, l_ in zip(q, lse)]
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    if kernel == "attention_softmax":
        st = _attention(card, "bucketed")
        assert st.schedule[2] > 0  # split rows: the pieces' counters are used
        n = int(st.dst.max().item()) + 1
        alphas = [_random(card, rng, (n, 4), (n, 4)) for _ in range(2)]
        datt = _random(card, rng, (st.idx.numel(), 4))[0]

        def s2(a_src, a_dst):
            args = (a_src, a_dst, st.idx, st.dst, st.row_ptr, st.live, 0.2, st.schedule)
            att, _ = seg_ops.attention_softmax(*args)
            return [att, seg_ops.attention_softmax_bwd(att, datt, *args)]

        return [lambda a=a: s2(*a) for a in alphas]
    if kernel == "weighted_pull_dot":
        st = _attention(card, "bucketed")
        assert st.t_schedule[2] > 0  # split rows: the pieces' counters are used
        w = _random(card, rng, (st.idx.numel(), 4))[0]
        gs = _random(card, rng, *[(st.dst.max().item() + 1, 4 * 64)] * 2)
        return [lambda g=g: list(seg_ops.weighted_pull_dot(g, w, st.t_idx, st.t_row_ptr,
                                                           st.t_fpos, g, st.t_node,
                                                           st.t_schedule)) for g in gs]
    if kernel == "segment_sum":
        view, _ = p2_views_of(card)
        assert view.sums[2] > 0  # split rows: the pieces' counters are used
        v = _random(card, rng, (view.n_slots,))[0]
        xs = _random(card, rng, *[(view.n_cols, 64)] * 2)
        return [lambda x=x: [seg_ops.segment_sum(x, view, v)] for x in xs]
    if kernel == "weighted_pull":
        view = _segment_view(card)
        assert view.n_partials > 0  # split rows: the pieces' counters are used
        w = _random(card, rng, (view.n_slots, 4))[0]
        xs = _random(card, rng, *[(view.n_cols, 4 * 64)] * 2)
        return [lambda x=x: [seg_ops.weighted_pull(x, w, view.idx, view.row_ptr, view.schedule)]
                for x in xs]
    csr = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="bucketed",
                      device=card).norm_adj.pull
    assert csr.n_partials > 0  # split rows: the pieces' counters are used
    if kernel in ("pull_int8", "quantize", "pull_int8_fused"):
        srcs = _random(card, rng, *[(csr.total_rows + 1, 256)] * 2)
        if kernel == "quantize":
            return [lambda y=y: list(quantize_rows(y, csr.sep_src_row)) for y in srcs]
        q = [quantize_rows(y, csr.sep_src_row) for y in srcs]
        if kernel == "pull_int8_fused":
            return [lambda c=c, s=s, a=a: list(gather_sum(
                c, csr.ridx, csr.row_ptr, post=csr.sep_dst, skip=csr.total_rows,
                schedule=csr.schedule, scale=s, acc=a, requant=True, pre=csr.sep_src_row))
                for (c, s), a in zip(q, srcs)]
        return [lambda c=c, s=s: [gather_sum(c, csr.ridx, csr.row_ptr, post=csr.sep_dst,
                                             skip=csr.total_rows, schedule=csr.schedule,
                                             scale=s)] for c, s in q]
    srcs = _random(card, rng, *[(csr.total_rows + 1, 64)] * 2)
    return [lambda y=y: [gather_sum(y, csr.ridx, csr.row_ptr, post=csr.sep_dst,
                                    skip=csr.total_rows, schedule=csr.schedule)] for y in srcs]


@pytest.mark.parametrize("kernel", ["chain", "lse", "lse_bwd", "pull", "weighted_pull",
                                    "weighted_pull_dot", "attention_softmax", "pull_int8",
                                    "quantize", "pull_int8_fused", "segment_sum"])
def test_calls_on_two_streams_equal_calls_in_turn(card, kernel):
    """Two calls launched on two streams at once give what the same calls
    give one after the other on one stream, bit for bit, ten times over:
    the chain's tile counters, P1's, P2's, S1's and S2's piece counters and
    S2's piece statistics, K5's and K6's partials and the fused pull's zeroed
    dot are not mixed between streams. The chain's calls on the two streams
    hold tile counter buffers of their own (``prop._COUNTS`` is keyed by
    device and stream)."""
    from recommendation_tpu_torch.ops import prop

    fns = _two_calls(card, kernel)
    want = [fn() for fn in fns]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in fns]
    for _ in range(10):
        got = []
        for fn, stream in zip(fns, streams):
            with torch.cuda.stream(stream):
                got.append(fn())
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), kernel
    if kernel == "chain":
        bufs = [prop._COUNTS[(torch.device(card), s.cuda_stream)] for s in streams]
        assert bufs[0].data_ptr() != bufs[1].data_ptr()
        assert all(int(b.abs().sum()) == 0 for b in bufs)  # every counter back at zero


# -- the bucketed backend's kernels: K7 (row gather), P1 (bucket pull) --------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,s", [(1000, 64, 5000), (999, 129, 3000), (50, 3, 700),
                                   (1500, 128, 4096), (10, 1, 1)])
def test_row_gather_is_exact(card, dtype, n, d, s):
    """K7 equals x[idx] bit for bit, rows carrying their ids as the TPU
    probe's do, from a table and from an offset view of one (which takes
    the narrower copy units where the offset is not 16-byte aligned)."""
    rng = np.random.default_rng(n + d + s)
    x = torch.from_numpy(rng.normal(size=(n + 1, d)).astype(np.float32))
    x[:, 0] = torch.arange(n + 1, dtype=torch.float32)
    x = x.to(card, dtype)
    idx = torch.from_numpy(rng.integers(0, n, s).astype(np.int32)).to(card)
    before = gather_rows.launches
    got = gather_rows(x, idx)
    shifted = gather_rows(x[1:], idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 2
    assert torch.equal(got, x[idx.long()]) and torch.equal(shifted, x[1:][idx.long()])


@pytest.fixture(scope="module")
def bucket_adj():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    return DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="bucketed",
                       device="cuda").norm_adj


P1_VARIANTS = ["separable", "value", "add", "value_add", "bf16", "bf16_value", "node",
               "acc", "acc_keep_y", "final", "acc_final", "add_final"]


@pytest.mark.parametrize("variant", P1_VARIANTS)
@pytest.mark.parametrize("d", [64, 128, 24, 5])
def test_bucket_pull_matches_plain(card, bucket_adj, variant, d):
    """Each P1 variant against its plain version on a normalized graph's
    tables, the epilogue's too (the chain's running sum ``acc + y`` and its
    last scaling ``final``). The two sum each row's slots in another order,
    which moves a result by a few ulps of the row's largest partial sum:
    rtol 1e-5 with an atol of 1e-5 times the table's largest entry. Two
    calls agree bit for bit (no atomics)."""
    csr = bucket_adj.pull
    r = csr.total_rows
    rng = np.random.default_rng(d)
    src, add, acc = (torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32)).to(card)
                     for _ in range(3))
    src[r] = add[r] = 0.0
    kw = dict(idx=csr.ridx, skip=r)
    if variant in ("separable", "add", "bf16", "acc", "acc_keep_y", "final", "acc_final",
                   "add_final"):
        kw["post"] = csr.sep_dst
    if variant in ("value", "value_add", "bf16_value", "node"):
        kw["val"] = csr.val
    if variant in ("add", "value_add", "add_final"):
        kw["add"] = add
    if variant in ("acc", "acc_keep_y", "acc_final"):
        kw["acc"] = acc
    if variant == "acc_keep_y":
        kw["keep_y"] = True
    if variant in ("final", "acc_final", "add_final"):
        kw["final"] = torch.from_numpy(rng.random(r + 1).astype(np.float32)).to(card)
    if variant.startswith("bf16"):
        src = src.to(torch.bfloat16)
    if variant == "node":
        src = torch.from_numpy(rng.normal(size=(csr.n_cols, d)).astype(np.float32)).to(card)
        kw.update(idx=csr.idx, skip=-1)
    before = gather_sum.launches
    got = gather_sum(src, row_ptr=csr.row_ptr, schedule=csr.schedule, **kw)
    again = gather_sum(src, row_ptr=csr.row_ptr, schedule=csr.schedule, **kw)
    torch.cuda.synchronize()
    assert gather_sum.launches == before + 2
    want = gather_sum_plain(src, row_ptr=csr.row_ptr, **kw)
    got, again, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, again, want))
    assert len(got) == len(want) == (2 if variant == "acc_keep_y" else 1)
    for g, a, w in zip(got, again, want):
        assert g.shape == (r + 1, d) and g.dtype == torch.float32
        assert torch.equal(g, a)
        if "acc" not in variant:
            assert torch.all(g[r] == 0)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("pre", [False, True], ids=["plain", "pre"])
@pytest.mark.parametrize("d", [250, 256, 1024])
def test_row_quantizer_is_exact(card, d, pre):
    """Q1 equals its plain version bit for bit (codes, padding codes 0,
    scales), on normal rows, rows on half quanta (ties, rounded half to
    even), a zero row and an offset view's unaligned rows; one launch a
    call."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(3000, d)).astype(np.float32)
    s = (np.abs(x).max(axis=1) * np.float32(1 / 127)).astype(np.float32)
    half = ((np.clip(np.round(x / s[:, None]), -126, 126) + np.float32(0.5)) * s[:, None])
    half[np.arange(3000), np.argmax(np.abs(x), axis=1)] = np.abs(x).max(axis=1)
    x = torch.from_numpy(np.concatenate([x, half.astype(np.float32)])).to(card)
    x[7] = 0.0
    p = torch.from_numpy(rng.random(len(x)).astype(np.float32)).to(card) if pre else None
    for src, scl in ((x, p), (x[1:], None if p is None else p[1:])):  # x[1:]: d·4-byte offset
        before = quantize_rows.launches
        codes, scale = quantize_rows(src, scl)
        torch.cuda.synchronize()
        assert quantize_rows.launches == before + 1
        want_codes, want_scale = quantize_rows_plain(src.cpu(), None if scl is None else scl.cpu())
        assert codes.stride(0) % 16 == 0 and codes.data_ptr() % 16 == 0
        table = torch.as_strided(codes, (codes.shape[0], codes.stride(0)), (codes.stride(0), 1))
        assert torch.equal(codes.cpu(), want_codes) and torch.equal(scale.cpu(), want_scale)
        assert not table[:, d:].any()
    assert not codes.cpu()[6].any()  # row 7 of x is zero: its codes are 0


@pytest.mark.parametrize("variant", ["separable", "value", "node"])
@pytest.mark.parametrize("d", [256, 250, 1024])
def test_int8_pull_matches_plain(card, bucket_adj, variant, d):
    """P1 with an int8 source (Q1's codes and scales) against its plain
    version at P1's bound, twice bit for bit, on the separable and the
    value path in row space and the value path in node space."""
    csr = bucket_adj.pull
    r = csr.total_rows
    rng = np.random.default_rng(d + 1)
    x = torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32)).to(card)
    x[r] = 0.0
    kw = dict(idx=csr.ridx, skip=r)
    if variant == "separable":
        codes, scale = quantize_rows(x, csr.sep_src_row)
        kw["post"] = csr.sep_dst
    else:
        kw["val"] = csr.val
        if variant == "node":
            x = torch.from_numpy(rng.normal(size=(csr.n_cols, d)).astype(np.float32)).to(card)
            kw.update(idx=csr.idx, skip=-1)
        codes, scale = quantize_rows(x)
    assert packer("int8", d) == "int8"
    before = gather_sum.launches
    got = gather_sum(codes, row_ptr=csr.row_ptr, schedule=csr.schedule, scale=scale, **kw)
    again = gather_sum(codes, row_ptr=csr.row_ptr, schedule=csr.schedule, scale=scale, **kw)
    torch.cuda.synchronize()
    assert gather_sum.launches == before + 2
    want = gather_sum_plain(codes, row_ptr=csr.row_ptr, scale=scale, **kw)
    assert got.shape == (r + 1, d) and torch.equal(got, again)
    if variant != "node":
        assert torch.all(got[r] == 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    with pytest.raises(TypeError, match="no add, final"):
        gather_sum(codes, row_ptr=csr.row_ptr, scale=scale, acc=got,
                   final=torch.ones(r + 1, device=card), **kw)


@pytest.fixture(scope="module")
def clustered_adj():
    """The clustered large set's normalized adjacency (chip_smoke.py's
    CLUSTERED_SHAPE) on the bucketed backend: the int8 chain's tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pairs = make_clustered_interactions(50_000, 100_000, 1_000_000, seed=3)
    return DeviceGraph(ArrayInteraction(pairs, 50_000, 100_000, test_fraction=0.1),
                       backend="bucketed", device="cuda").norm_adj


@pytest.mark.parametrize("d", [250, 256, 512, 1024])
@pytest.mark.parametrize("graph", ["clustered", "split"])
def test_int8_fused_layer_is_the_three_launches(card, request, graph, d):
    """The int8 chain's fused layer (P1's int8 epilogue: the running sum and
    the next layer's codes and scale) against the three launches it
    replaces (P1 with an int8 source, Q1 on its output, a torch add), bit
    for bit, and twice bit for bit: the first layer (no running sum), a
    middle one and the last (no codes), on the separable path (Q1's
    pre-scale) and the value path, at the clustered tables and at a graph
    with split rows; one pass a row up to d = 512, several past it."""
    adj = request.getfixturevalue("clustered_adj" if graph == "clustered" else "bucket_adj")
    csr = adj.pull
    r = csr.total_rows
    if graph == "split":
        assert csr.n_partials > 0
    rng = np.random.default_rng(d)
    x, acc = (torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32)).to(card)
              for _ in range(2))
    x[r] = 0.0
    for sep in (True, False):
        pre = csr.sep_src_row if sep else None
        kw = dict(idx=csr.ridx, row_ptr=csr.row_ptr, skip=r, schedule=csr.schedule,
                  post=csr.sep_dst if sep else None, val=None if sep else csr.val)
        codes, scale = quantize_rows(x, pre)
        y = gather_sum(codes, scale=scale, **kw)
        want = quantize_rows(y, pre)
        for a in (None, acc):
            before = gather_sum.launches_fused
            got = gather_sum(codes, scale=scale, acc=a, requant=True, pre=pre, **kw)
            again = gather_sum(codes, scale=scale, acc=a, requant=True, pre=pre, **kw)
            torch.cuda.synchronize()
            assert gather_sum.launches_fused == before + 2
            total = y if a is None else a + y
            for g, w in zip((got, again), ((total, *want),) * 2):
                assert all(torch.equal(p, q) for p, q in zip(g, w)), (sep, a is None)
            table = torch.as_strided(got[1], (r + 1, got[1].stride(0)), (got[1].stride(0), 1))
            assert not table[:, d:].any() and not got[1][r].any()
        last = gather_sum(codes, scale=scale, acc=acc, **kw)
        assert torch.equal(last, acc + y) and torch.equal(last, gather_sum(codes, scale=scale,
                                                                           acc=acc, **kw))


def test_int8_chain_quantizes_each_forward_layer(card, bucket_adj):
    """The int8 chain at d = 256 on the card: Q1 once a forward (layer 0's
    source) and never backward, the later layers' sources quantized in the
    fused pulls' epilogue (every layer one fused launch), and the f32
    chain's gradient bit for bit. Against the
    plain chain: layer 1 quantizes the same rows, but P1 and the plain pull
    round a layer's sums in other orders, so a later layer's code at a tie
    may flip by one quantum; held by relative Frobenius error (1e-4) with
    under 1e-3 of the elements past P1's bound."""
    d = 256
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(bucket_adj.n_rows, d)).astype(np.float32)).to(card)
    probe = torch.from_numpy(rng.normal(size=(bucket_adj.n_rows, d)).astype(np.float32)).to(card)
    grads, before, fused = [], quantize_rows.launches, gather_sum.launches_fused
    for dt in ("int8", "float32"):
        xt = x.clone().requires_grad_()
        out = bucketed_chain_mean(3, dt, bucket_adj.pull, bucket_adj.pull_t, xt)
        if dt == "int8":
            torch.cuda.synchronize()
            assert quantize_rows.launches == before + 1
            assert gather_sum.launches_fused == fused + 3
            plain = bucketed_chain_mean_plain(3, dt, bucket_adj.pull, x)
            diff = (out - plain).abs()
            past = diff > 1e-5 * plain.abs() + 1e-5 * plain.abs().max()
            assert torch.isfinite(out).all() and past.float().mean().item() < 1e-3
            assert (torch.linalg.norm(out - plain) / torch.linalg.norm(plain)).item() < 1e-4
        (out * probe).sum().backward()
        grads.append(xt.grad)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1 and gather_sum.launches_fused == fused + 3
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("compute_dtype,d", [("float32", 64), ("bfloat16", 128)])
def test_bucketed_chain_has_a_gradient_on_the_card(card, bucket_adj, compute_dtype, d):
    """``BucketedChainMean`` on the card: its output carries a gradient; the
    forward launches K7 twice and P1 L times, the backward as many; values
    and gradients against autograd through the plain chain. In bf16 the
    plain chain's autograd rounds the cotangent where the kernels' backward
    rounds the operand, so the gradient holds the bf16 bound."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(bucket_adj.n_rows, d)).astype(np.float32) * 0.1)
    x = x.to(card).requires_grad_()
    probe = torch.from_numpy(rng.normal(size=(bucket_adj.n_rows, d)).astype(np.float32)).to(card)
    before = gather_rows.launches, gather_sum.launches
    out = bucketed_chain_mean(3, compute_dtype, bucket_adj.pull, bucket_adj.pull_t, x)
    assert out.grad_fn is not None
    (out * probe).sum().backward()
    torch.cuda.synchronize()
    assert (gather_rows.launches, gather_sum.launches) == (before[0] + 4, before[1] + 6)
    got_g = x.grad.clone()
    x.grad = None
    plain = bucketed_chain_mean_plain(3, compute_dtype, bucket_adj.pull, x)
    (plain * probe).sum().backward()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item())
    dtype = torch.bfloat16 if packer(compute_dtype, d) else torch.float32
    assert _grads_close([got_g], [x.grad], dtype)
    assert not _grads_close([torch.zeros_like(got_g)], [x.grad], dtype)


class _PlainBucketedLightGCN(LightGCN):
    """LightGCN with the plain bucketed chain (autograd through torch ops)."""

    def propagate(self, params, graph):
        n_users = params["user_emb"].shape[0]
        ego = torch.cat([params["user_emb"], params["item_emb"]])
        adj = graph.norm_adj
        mean = bucketed_chain_mean_plain(self.n_layers, adj.compute_dtype, adj.pull, ego)
        return mean[:n_users], mean[n_users:]


def test_bucketed_training_step_kernel_vs_plain(card):
    """One LightGCN step on a bucketed graph: K7 4 and P1 6 launches, the
    loss and gradients against the plain chain's, the bound rejecting
    zeros."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="bucketed", device=card)
    config = default_config(**{"batch.size": 1024})
    models = (build("lightgcn", config), _PlainBucketedLightGCN(config))
    init, _ = models[0].init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    out = []
    for m in models:
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        before = gather_rows.launches, gather_sum.launches
        loss, _ = m.loss(p, {}, batch, graph)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out.append((loss.item(), grads, (gather_rows.launches - before[0],
                                         gather_sum.launches - before[1])))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    assert n_k == (4, 6) and n_p == (0, 0)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 + 1e-5 * abs(loss_p)
    assert _grads_close(g_k, g_p, torch.float32)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, torch.float32)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros(6, 4, device=card)
    idx = torch.zeros(3, dtype=torch.int32, device=card)
    ptr = torch.tensor([0, 1, 3], device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(x[:, ::2], idx)
    with pytest.raises(ValueError, match="devices"):
        gather_rows(x, idx.cpu())
    with pytest.raises(TypeError):
        gather_rows(x.half(), idx)
    with pytest.raises(TypeError):
        gather_sum(x, idx.long(), ptr)
    with pytest.raises(ValueError, match="contiguous"):
        gather_sum(x[:, ::2], idx, ptr)


# -- the segment kernels: S1 (weighted pull, and with the head dot), S2 (segment softmax) --


def _segment_view(card):
    """The destination view of a power-law graph's bidirectional edges: its
    hub rows hold more than one CHUNK of slots, so S1 splits them."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="segment", device=card)
    return graph.bipartite_views()[1]


def _attention(card, backend):
    """GAT's structure (``models/gat.py::attention_structure``) over a
    power-law graph's edges: the segment views, or the bucket rows."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend=backend, device=card)
    return attention_structure(graph)


def _segment_inputs(card, view, heads, d, seed):
    rng = np.random.default_rng(seed)
    x, w, e, g = _random(card, rng, (view.n_cols, heads * d), (view.n_slots, heads),
                         (view.n_slots, heads), (view.n_slots, heads))
    live = torch.from_numpy(rng.random(view.n_slots) > 0.1).to(card)
    return x, w, e * 3, g, live


def _repeats_and_agrees(name, fn, plain, rtol=1e-5):
    """Two kernel calls equal bit for bit, and the plain version at rtol
    and an atol of 1e-5 of the plain result's largest entry (the kernel
    sums in slot order, the plain version in its own); each output where
    ``fn`` returns a tuple."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    want = plain()
    if not isinstance(got, tuple):
        got, again, want = (got,), (again,), (want,)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b), name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, c, rtol=rtol, atol=1e-5 * c.abs().max().item(), msg=name)


@pytest.mark.parametrize("heads,d", [(1, 64), (4, 64), (4, 5), (2, 3)])
def test_segment_kernels_match_plain(card, heads, d):
    view = _segment_view(card)
    x, w, e, g, live = _segment_inputs(card, view, heads, d, heads * 100 + d)
    before = (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches,
              seg_ops.segment_softmax_rows_bwd.launches)
    _repeats_and_agrees("S1", lambda: seg_ops.weighted_pull(x, w, view.idx, view.row_ptr,
                                                            view.schedule),
                        lambda: seg_ops.weighted_pull_plain(x, w, view.idx, view.row_ptr))
    _repeats_and_agrees("S2", lambda: seg_ops.segment_softmax_rows(e, view.row_ptr, live),
                        lambda: seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live))
    att = seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live)
    _repeats_and_agrees("S2 bwd", lambda: seg_ops.segment_softmax_rows_bwd(att, g, view.row_ptr),
                        lambda: seg_ops.segment_softmax_rows_bwd_plain(att, g, view.row_ptr))
    after = (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches,
             seg_ops.segment_softmax_rows_bwd.launches)
    # S2 without a schedule builds one; a split row adds its pieces' launch
    s2 = 2 * (1 + (view.n_partials > 0))
    assert view.n_partials > 0 and [a - b for a, b in zip(after, before)] == [2, s2, s2]
    # no live slot in a row: its weights are 0
    none = seg_ops.segment_softmax_rows(e, view.row_ptr, torch.zeros_like(live))
    assert not none.any()


def _hub_view(card):
    """A segment view whose row 0 holds 12,000 slots (94 CHUNK pieces),
    among 300 rows of 0 to 40 slots."""
    rng = np.random.default_rng(8)
    rows = np.concatenate([np.zeros(12_000, np.int64), rng.integers(1, 300, 6000)])
    cols = rng.integers(0, 500, len(rows))
    return seg_ops.segment_csr(torch.from_numpy(rows).to(card), torch.from_numpy(cols).to(card),
                               300, 500)


# (heads, d): 16 lanes a row (H*D <= 64), a warp with 1, 2 or 4 16-byte
# units a lane (H*D 128, 256, 320), two column passes (H*D 640), one f32
# at a time (d not a multiple of 4), and heads wider than a column pass
# (the fused pull's dot over several passes: 1024 f32, and 130 one at a
# time)
S1_WIDTHS = [(1, 64), (2, 32), (4, 16), (1, 128), (4, 64), (2, 160), (4, 160), (1, 7), (4, 9),
             (1, 1024), (2, 1024), (1, 130), (3, 130)]


@pytest.mark.parametrize("heads,d", S1_WIDTHS)
def test_weighted_pull_across_pieces(card, heads, d):
    """S1 and its fused variant at every group width, on a hub row split
    into 94 pieces: against their plain versions, twice bit for bit; the
    fused variant's dot written at the live slots' forward slots only."""
    view = _hub_view(card)
    assert view.n_partials >= 90
    rng = np.random.default_rng(heads * 1000 + d)
    x, w, hsrc = _random(card, rng, (view.n_cols, heads * d), (view.n_slots + 7, heads),
                         (view.n_rows, heads * d))
    _repeats_and_agrees("S1", lambda: seg_ops.weighted_pull(x, w[:view.n_slots].contiguous(),
                                                            view.idx, view.row_ptr,
                                                            view.schedule),
                        lambda: seg_ops.weighted_pull_plain(x, w[:view.n_slots], view.idx,
                                                            view.row_ptr))
    # each slot's forward slot: a permutation of the forward slots, 10% dead
    fpos = torch.from_numpy(rng.permutation(view.n_slots + 7)[:view.n_slots].astype(np.int32))
    fpos[torch.from_numpy(rng.random(view.n_slots) < 0.1)] = -1
    fpos = fpos.to(card)
    before = seg_ops.weighted_pull_dot.launches
    _repeats_and_agrees(
        "S1 with the head dot",
        lambda: seg_ops.weighted_pull_dot(x, w, view.idx, view.row_ptr, fpos, hsrc,
                                          schedule=view.schedule),
        lambda: seg_ops.weighted_pull_dot_plain(x, w, view.idx, view.row_ptr, fpos, hsrc))
    assert seg_ops.weighted_pull_dot.launches - before == 2
    dh, dot = seg_ops.weighted_pull_dot(x, w, view.idx, view.row_ptr, fpos, hsrc,
                                        schedule=view.schedule)
    unreached = torch.ones(w.shape[0], dtype=torch.bool, device=card)
    unreached[fpos[fpos >= 0].long()] = False
    assert not dot[unreached].any() and dot[~unreached].abs().max() > 0


@pytest.mark.parametrize("backend", ["segment", "bucketed"])
@pytest.mark.parametrize("heads", [1, 4])
def test_weighted_pull_dot_on_gat_structures(card, backend, heads):
    """The fused pull over GAT's transpose views (the bidirectional edges'
    source view, the bucket rows of Aᵀ with their row nodes): dh and the
    dot against the plain version, twice bit for bit; the dead slots
    (``tpos`` sends the bucketed padding to one forward slot) write
    nothing, and every forward slot no live slot reaches is exactly 0."""
    st = _attention(card, backend)
    dead = st.t_fpos < 0
    assert torch.equal(st.t_fpos[~dead], st.t2f[~dead])
    if backend == "bucketed":  # tpos sends every padding slot to one forward slot
        assert st.t_node is not None and st.t2f[dead].unique().numel() < int(dead.sum())
    rng = np.random.default_rng(heads)
    n = int(st.dst.max().item()) + 1
    g, hsrc, w = _random(card, rng, (n, heads * 64), (n, heads * 64), (st.idx.numel(), heads))
    w = torch.where(st.live[:, None], w, torch.zeros((), device=card))
    _repeats_and_agrees(
        f"S1 with the head dot, {backend}",
        lambda: seg_ops.weighted_pull_dot(g, w, st.t_idx, st.t_row_ptr, st.t_fpos, hsrc,
                                          st.t_node, st.t_schedule),
        lambda: seg_ops.weighted_pull_dot_plain(g, w, st.t_idx, st.t_row_ptr, st.t_fpos, hsrc,
                                                st.t_node))
    _, dot = seg_ops.weighted_pull_dot(g, w, st.t_idx, st.t_row_ptr, st.t_fpos, hsrc, st.t_node,
                                       st.t_schedule)
    assert not dot[~st.live].any() and dot[st.live].abs().max() > 0


@pytest.mark.parametrize("heads", [1, 4])
def test_segment_kernels_on_bucket_rows(card, heads):
    """S1 and S2 over the bucketed tables' flat slots (each bucket row a
    segment, the zero row empty), dead slots masked."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    csr = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="bucketed",
                      device=card).norm_adj.pull
    rng = np.random.default_rng(heads)
    x, e = _random(card, rng, (csr.n_rows, heads * 64), (csr.n_slots, heads))
    live = (csr.edge >= 0) & (csr.val != 0)
    att = seg_ops.segment_softmax_rows(e, csr.row_ptr, live)
    _repeats_and_agrees("S2 bucket rows", lambda: seg_ops.segment_softmax_rows(e, csr.row_ptr,
                                                                               live),
                        lambda: seg_ops.segment_softmax_rows_plain(e, csr.row_ptr, live))
    _repeats_and_agrees("S1 bucket rows", lambda: seg_ops.weighted_pull(
        x, att, csr.idx, csr.row_ptr, csr.schedule),
        lambda: seg_ops.weighted_pull_plain(x, att, csr.idx, csr.row_ptr))


def _s2_rows(card):
    """Rows for S2: 400 rows of 0 to 60 slots (one work item each), row 7
    empty, row 9 with no live slot, and three hub rows split into pieces
    (300, 1000 and 5000 slots: 3, 8 and 40 pieces of 128), one of them
    with no live slot in its first pieces; each slot's source and
    destination node among 900 nodes, 20% dead."""
    rng = np.random.default_rng(12)
    counts = rng.integers(0, 61, 400)
    counts[7] = 0
    counts[[3, 50, 399]] = (300, 1000, 5000)
    rows = np.repeat(np.arange(400), counts)
    view = seg_ops.segment_csr(torch.from_numpy(rows).to(card),
                               torch.from_numpy(rng.integers(0, 900, len(rows))).to(card), 400, 900)
    ptr = view.row_ptr.cpu().numpy()
    live = rng.random(view.n_slots) > 0.2
    live[ptr[9]:ptr[10]] = False
    live[ptr[50]:ptr[50] + 400] = False  # the row's first three pieces hold no live slot
    dst = torch.from_numpy(rng.integers(0, 900, view.n_rows).astype(np.int32)).to(card)
    return rng, view, torch.from_numpy(live).to(card), dst[view.slot_row.long()].contiguous()


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 8, 12])
def test_segment_softmax_any_heads_across_pieces(card, heads):
    """S2 on given logits and with GAT's logits fused in, forward and
    backward, with and without the dropout scale, at any head count, on
    rows that are empty, hold no live slot, fit one work item or split
    into pieces: twice bit for bit, against the plain versions, two
    launches a call (a row is split), dead slots exactly 0."""
    rng, view, live, dst = _s2_rows(card)
    assert view.n_partials >= 50
    n = 900
    a_src, a_dst, e, g, datt = _random(card, rng, (n, heads), (n, heads), (view.n_slots, heads),
                                       (view.n_slots, heads), (view.n_slots, heads))
    a_src, a_dst, e = a_src * 3, a_dst * 3, e * 3
    keep = torch.from_numpy((rng.random((view.n_slots, heads)) > 0.3) / 0.7).float().to(card)
    sched = view.schedule
    args = (a_src, a_dst, view.idx, dst, view.row_ptr, live, 0.2)
    counters = (seg_ops.segment_softmax_rows, seg_ops.segment_softmax_rows_bwd,
                seg_ops.attention_softmax, seg_ops.attention_softmax_bwd)
    before = [f.launches for f in counters]
    _repeats_and_agrees("S2", lambda: seg_ops.segment_softmax_rows(e, view.row_ptr, live, sched),
                        lambda: seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live))
    att = seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live)
    _repeats_and_agrees("S2 bwd",
                        lambda: seg_ops.segment_softmax_rows_bwd(att, g, view.row_ptr, sched),
                        lambda: seg_ops.segment_softmax_rows_bwd_plain(att, g, view.row_ptr))
    for k in (None, keep):
        _repeats_and_agrees("S2 with the logits", lambda: seg_ops.attention_softmax(
            *args, sched, k), lambda: seg_ops.attention_softmax_plain(*args, keep=k))
        att, _ = seg_ops.attention_softmax_plain(*args, keep=k)
        _repeats_and_agrees("S2 bwd with the logits", lambda: seg_ops.attention_softmax_bwd(
            att, datt, *args, sched, k), lambda: seg_ops.attention_softmax_bwd_plain(
            att, datt, *args, keep=k))
    assert [f.launches - b for f, b in zip(counters, before)] == [4, 4, 8, 8]
    att, w = seg_ops.attention_softmax(*args, sched, keep)
    dz = seg_ops.attention_softmax_bwd(att, datt, *args, sched, keep)
    assert not att[~live].any() and not w[~live].any() and not dz[~live].any()
    ptr = view.row_ptr.cpu().numpy()
    assert not att[ptr[9]:ptr[10]].any() and att[ptr[50]:ptr[51]].abs().max() > 0
    sums = torch.zeros(view.n_rows, heads, device=card).index_add_(0, view.slot_row.long(), att)
    has_live = torch.zeros(view.n_rows, dtype=torch.bool, device=card).index_fill_(
        0, view.slot_row[live].long(), True)
    torch.testing.assert_close(sums[has_live], torch.ones_like(sums[has_live]), rtol=0, atol=1e-5)


def test_segment_wrappers_refuse_what_the_kernels_do_not_take(card):
    ptr = torch.tensor([0, 2, 3], device=card)
    with pytest.raises(TypeError):
        seg_ops.segment_softmax_rows(torch.zeros(3, 2, device=card, dtype=torch.float64), ptr)
    # the fused S2 reads its logits as f32 rows and its node ids as int32
    idx = torch.zeros(3, dtype=torch.int32, device=card)
    a = torch.zeros(4, 3, device=card)
    with pytest.raises(TypeError, match="float32"):
        seg_ops.attention_softmax(a.double(), a, idx, idx, ptr, None, 0.2)
    with pytest.raises(TypeError, match="int32 idx and dst"):
        seg_ops.attention_softmax(a, a, idx.long(), idx, ptr, None, 0.2)
    with pytest.raises(ValueError, match="keep"):
        seg_ops.attention_softmax(a, a, idx, idx, ptr, None, 0.2, keep=torch.zeros(3, 2, device=card))
    with pytest.raises(TypeError):
        seg_ops.weighted_pull(torch.zeros(4, 8, device=card), torch.zeros(3, 2, device=card),
                              idx.long(), ptr)
    # S3 has no kernel: its dot runs in the fused pull
    with pytest.raises(ValueError, match="weighted_pull_dot"):
        seg_ops.segment_dot(torch.zeros(4, 16, device=card), idx,
                            torch.zeros(4, 16, device=card), idx, 2)
    g, w = torch.zeros(4, 16, device=card), torch.zeros(3, 2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        seg_ops.weighted_pull_dot(torch.zeros(4, 32, device=card)[:, ::2], w, idx, ptr, idx, g)
    with pytest.raises(TypeError):
        seg_ops.weighted_pull_dot(g, w, idx, ptr, idx.long(), g)
    # S2 reads row_ptr as 64-bit, S1 its schedule through raw pointers
    with pytest.raises(TypeError, match="int64 row_ptr"):
        seg_ops.segment_softmax_rows(torch.zeros(3, 2, device=card), ptr.int())
    with pytest.raises(TypeError, match="int64 row_ptr"):
        seg_ops.segment_softmax_rows_bwd(torch.zeros(3, 2, device=card),
                                         torch.zeros(3, 2, device=card), ptr.int())
    x, w = torch.zeros(4, 8, device=card), torch.zeros(3, 2, device=card)
    work, work_start, n_partials = pull_schedule(ptr)
    for bad in ((work.long(), work_start, n_partials), (work, work_start.int(), n_partials),
                (work.cpu(), work_start.cpu(), n_partials), (work[:1], work_start, n_partials),
                (work, work_start, -1)):
        with pytest.raises(ValueError, match="schedule"):
            seg_ops.weighted_pull(x, w, idx, ptr, bad)
        with pytest.raises(ValueError, match="schedule"):
            seg_ops.weighted_pull_dot(x, w, idx, ptr, idx, x, schedule=bad)
        with pytest.raises(ValueError, match="schedule"):
            seg_ops.segment_softmax_rows(w, ptr, schedule=bad)
        with pytest.raises(ValueError, match="schedule"):
            seg_ops.attention_softmax(a, a, idx, idx, ptr, None, 0.2, bad)


# -- P2, the pull over a row-sorted view (csrc/segment_sum.cu) -----------------


def p2_views_of(device):
    """A view and its transpose whose rows hold 0, 1, 127, 128, 129, 1,000
    and 4,840 slots (split into CHUNK pieces past 128), 40 empty rows in a
    run (past an item's SUM_ROWS), 3,000 rows of 0 to 19 slots and 500 of 0
    to 8, over 700 columns, the COO in no order."""
    rng = np.random.default_rng(23)
    lens = np.concatenate([[0, 1, 127, 128, 129, 1000], np.zeros(40, np.int64),
                           rng.integers(0, 20, 3000), [4840], rng.integers(0, 9, 500)])
    rows = np.repeat(np.arange(len(lens)), lens)
    rng.shuffle(rows)
    cols = rng.integers(0, 700, len(rows))
    r, c = torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)
    return (seg_ops.segment_csr(r, c, len(lens), 700),
            seg_ops.segment_csr(c, r, 700, len(lens)))


@pytest.fixture(scope="module")
def p2_views():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return p2_views_of("cuda")


# P2 against P1 and the plain version: the plain version sums a row's slots
# in another order (P1_TOL in chip_smoke.py); P1 and P2 in the same order
P2_TOL = dict(rtol=1e-5)


@pytest.mark.parametrize("d", [1, 10, 64, 256, 1000])
@pytest.mark.parametrize("val,post", [(False, False), (True, False), (False, True),
                                      (True, True)], ids=["sum", "val", "post", "val_post"])
def test_segment_sum_is_p1_over_the_view(card, p2_views, d, val, post):
    """P2 over a view with empty rows, rows of one to 128 slots and split
    hub rows: equal to P1 over the same view (``gather_sum`` on its
    ``pull_schedule``) bit for bit, to itself over two calls, and to
    ``gather_sum_plain`` at P2_TOL with an atol of 1e-5 of its largest
    entry; one launch a call."""
    view, _ = p2_views
    rng = np.random.default_rng(d)
    x, v, p = _random(card, rng, (view.n_cols, d), (view.n_slots,), (view.n_rows,))
    v, p = (v if val else None), (p if post else None)
    before = seg_ops.segment_sum.launches
    got, again = seg_ops.segment_sum(x, view, v, p), seg_ops.segment_sum(x, view, v, p)
    assert seg_ops.segment_sum.launches == before + 2
    p1 = gather_sum(x, view.idx, view.row_ptr, val=v, post=p, schedule=view.schedule)
    want = gather_sum_plain(x, view.idx, view.row_ptr, v, p)
    torch.cuda.synchronize()
    assert view.sums[2] > 0 and got.shape == (view.n_rows, d)
    assert torch.equal(got, again) and torch.equal(got, p1)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), **P2_TOL)


@pytest.mark.parametrize("parts", [2, 3, 7])
def test_segment_sum_over_row_cuts(card, p2_views, parts):
    """P2 over each ``row_range_view`` of a row cut gives the whole view's
    rows bit for bit (a row's pieces depend on its length alone), and over
    each ``rows_transpose_view`` equals P1 over the same rows bit for bit."""
    view, view_t = p2_views
    rng = np.random.default_rng(parts)
    x, v, g = _random(card, rng, (view.n_cols, 64), (view.n_slots,), (view.n_rows, 64))
    whole = seg_ops.segment_sum(x, view, v)
    for lo, hi in seg_ops.row_cut(view.row_ptr, parts):
        cut = seg_ops.row_range_view(view, lo, hi)
        s0, s1 = int(view.row_ptr[lo]), int(view.row_ptr[hi])
        assert torch.equal(seg_ops.segment_sum(x, cut, v[s0:s1].contiguous()), whole[lo:hi])
        t = seg_ops.rows_transpose_view(view_t, lo, hi)
        gt = g[lo:hi].contiguous()
        assert torch.equal(seg_ops.segment_sum(gt, t),
                           gather_sum(gt, t.idx, t.row_ptr, schedule=t.schedule))


# a step's segment-kernel, P1/K7 and P2 launches: GAT's two layers (S2 and
# S1 forward; S1 with the head dot, S2's backward and two per-row sums
# backward: P2 over the views, P1 over the bucket rows with K7 once forward
# and three times backward a layer; S2 twice a call where a row is split),
# GraphSAGE's two means (P2; the first takes no backward: the features are
# fixed), LightGCN's three segment matmuls both ways, GRACE's and G-BT's two
# views of two segment matmuls both ways (P2)
_S = {"weighted_pull": 2, "weighted_pull_dot": 2, "attention_softmax": 2,
      "attention_softmax_bwd": 2}
SEGMENT_CASES = {
    ("gat", "dense"): (PlainGAT, {**_S, "segment_sum": 4}),
    ("gat", "segment"): (PlainGAT, {**_S, "segment_sum": 4}),
    ("gat", "bucketed"): (PlainGAT, {**_S, "gather_sum": 4, "gather_rows": 8}),
    ("graphsage", "dense"): (PlainGraphSAGE, {"segment_sum": 3}),
    ("graphsage", "bucketed"): (PlainGraphSAGE, {"segment_sum": 3}),
    ("lightgcn", "segment"): (None, {"segment_sum": 6}),
    ("grace", "bucketed"): (None, {"segment_sum": 8}),
    ("gbt", "bucketed"): (None, {"segment_sum": 8}),
}


@pytest.mark.parametrize("name,backend", list(SEGMENT_CASES),
                         ids=["-".join(c) for c in SEGMENT_CASES])
def test_segment_step_kernel_vs_plain(card, monkeypatch, name, backend):
    """One step through the segment kernels and P2 (P1 and K7) against the
    plain path (``PlainGAT``, ``PlainGraphSAGE``, or the segment matmul's
    plain version in place of ``_segment_matmul``) on the same parameters,
    batch and masks: the launches, the loss, and the gradients, the bound
    rejecting zeros. G-BT's batch norm: by relative Frobenius error."""
    plain_cls, want = SEGMENT_CASES[name, backend]
    pairs = make_flat_interactions(1000, 2000, 20_000, seed=2)
    graph = DeviceGraph(ArrayInteraction(pairs, 1000, 2000), backend=backend, device=card)
    config = default_config(**{"batch.size": 1024})
    model = build(name, config)
    init, state = model.init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    if name == "gat" and attention_structure(graph).schedule[2] > 0:
        want = {**want, "attention_softmax": 4, "attention_softmax_bwd": 4}
    counters = {f.__name__: f for f in (gather_rows, gather_sum, seg_ops.weighted_pull,
                                         seg_ops.weighted_pull_dot, seg_ops.segment_softmax_rows,
                                         seg_ops.segment_softmax_rows_bwd,
                                         seg_ops.attention_softmax,
                                         seg_ops.attention_softmax_bwd, seg_ops.segment_sum)}
    names = [k for k in init if k not in model.frozen]
    out = []
    for plain in (False, True):
        m = plain_cls(config) if plain and plain_cls is not None else model
        if plain and plain_cls is None:
            monkeypatch.setattr(spmm, "_segment_matmul", spmm.segment_matmul_plain)
        draws = torch.Generator().manual_seed(5)
        monkeypatch.setattr(augment, "uniform", lambda g, shape, device: torch.rand(
            tuple(shape), generator=draws).to(device))
        p = {k: v.detach().clone().requires_grad_(k in names) for k, v in init.items()}
        before = {k: f.launches for k, f in counters.items()}
        loss, _ = m.loss(p, state, batch, graph, torch.Generator().manual_seed(6))
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        torch.cuda.synchronize()
        out.append((loss.item(), grads, {k: f.launches - before[k] for k, f in counters.items()
                                         if f.launches != before[k]}))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    assert n_k == want and n_p == {}, (n_k, n_p, want)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 + 1e-5 * abs(loss_p)
    if name == "gbt":
        largest = max(w.abs().max().item() for w in g_p)
        for k, g, w in zip(names, g_k, g_p):
            if k in ("conv1.b", "conv2.b"):  # exact gradient 0 (the batch norm, the standardization)
                assert max(g.abs().max().item(), w.abs().max().item()) < 1e-3 * largest
            else:
                assert torch.isfinite(g).all() and (
                    torch.linalg.norm(g - w) <= 1e-2 * torch.linalg.norm(w)), k
        return
    assert _grads_close(g_k, g_p, torch.float32)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, torch.float32)


def test_gat_steps_repeat_bit_for_bit(card):
    """No atomics on GAT's path: two steps on the same draws give the same
    loss and gradients, bit for bit (segment and bucketed)."""
    pairs = make_flat_interactions(1000, 2000, 20_000, seed=2)
    for backend in ("segment", "bucketed"):
        graph = DeviceGraph(ArrayInteraction(pairs, 1000, 2000), backend=backend, device=card)
        model = build("gat", default_config(**{"batch.size": 1024}))
        init, _ = model.init(torch.Generator().manual_seed(3), graph)
        batch = PairwiseBatch(*(torch.arange(64, device=card) for _ in range(3)),
                              torch.ones(64, device=card))
        runs = []
        for _ in range(2):
            p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
            loss, _ = model.loss(p, {}, batch, graph, torch.Generator().manual_seed(6))
            runs.append([loss] + list(torch.autograd.grad(loss, list(p.values()))))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), backend


@pytest.mark.parametrize("heads,hidden", [(3, 64), (4, 1024)])
def test_gat_step_at_any_width(card, heads, hidden):
    """GAT's shapes that the JAX package takes and the kernels once refused
    (a head count that does not divide 32; a head of 1024 f32, past one
    column pass of the fused pull): one step on the segment and bucketed
    backends against ``PlainGAT`` in float64 by relative Frobenius error
    (the attention gradients are ill-conditioned in f32), and twice bit for
    bit."""
    pairs = make_flat_interactions(1000, 2000, 20_000, seed=2)
    for backend in ("segment", "bucketed"):
        graph = DeviceGraph(ArrayInteraction(pairs, 1000, 2000), backend=backend, device=card)
        config = default_config(**{"batch.size": 1024, "GAT.num_heads": heads,
                                   "GAT.hidden": hidden})
        model, plain = build("gat", config), PlainGAT(config)
        init, _ = model.init(torch.Generator().manual_seed(3), graph)
        users, items, negs, weights, _ = epoch_batches(
            epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
        batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
        runs = []
        for m, dtype in ((model, torch.float32), (model, torch.float32), (plain, torch.float64)):
            p = {k: v.detach().to(dtype).requires_grad_() for k, v in init.items()}
            loss, _ = m.loss(p, {}, batch, graph, torch.Generator().manual_seed(6))
            runs.append([loss] + list(torch.autograd.grad(loss, list(p.values()))))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])), backend
        for got, want in zip(runs[0], runs[2]):
            assert torch.isfinite(got).all()
            err = torch.linalg.norm(got.double() - want) / torch.linalg.norm(want)
            assert err <= 1e-5, (backend, err.item())


# -- the social models ---------------------------------------------------------------

@pytest.fixture(scope="module")
def social_set():
    """A small set with its synthesized trust triples."""
    train, test = make_synthetic_dataset(n_users=300, n_items=500, n_interactions=12_000, seed=6)
    data = Interaction(train, test)
    return data, synthesize_social(data)


# one step's P1 (and on the bucketed backend K7) launches at L = 2: DiffNet's
# L products over the trust matrix and one over R̂, MHCN's five a layer and
# three in its MIM loss, each both ways
SOCIAL_CASES = {"diffnet": 2 * 3, "mhcn": 2 * 13}


@pytest.mark.parametrize("backend", ["bucketed", "segment"])
@pytest.mark.parametrize("name", list(SOCIAL_CASES))
def test_social_step_kernel_vs_plain(card, social_set, name, backend):
    """One step of a social model through P1 and K7 (bucketed) or P2
    (segment) against the same step with the plain COO product for every ``adj_matmul`` in float64:
    the launches, the loss, and each gradient by relative Frobenius error
    (MHCN's MIM loss sums over every user: f32-ill-conditioned), the bound
    rejecting zeros; MHCN's unused fourth supervised gate's bias exactly 0."""
    data, triples = social_set
    graph = SocialDeviceGraph(data, triples, backend=backend, device=card)
    model = build(name, default_config())
    init, state = model.init(torch.Generator().manual_seed(3), graph)
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(4), graph, 1024), graph, 1024)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])
    n = SOCIAL_CASES[name]
    want = ({"gather_sum": n, "gather_rows": n} if backend == "bucketed"
            else {"segment_sum": n})
    counters = (gather_rows, gather_sum, seg_ops.segment_sum)
    out = []
    for dtype in (torch.float32, torch.float64):
        p = {k: v.detach().clone().to(dtype).requires_grad_() for k, v in init.items()}
        before = [f.launches for f in counters]
        with spmm.plain_products() if dtype == torch.float64 else contextlib.nullcontext():
            loss, _ = model.loss(p, state, batch, graph, torch.Generator().manual_seed(6))
            grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out.append((loss.item(), dict(zip(p, grads)),
                    {f.__name__: f.launches - b for f, b in zip(counters, before)
                     if f.launches != b}))
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = out
    assert n_k == want and n_p == {}, (n_k, n_p, want)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-6 + 1e-5 * abs(loss_p)
    for k, w in g_p.items():
        g = g_k[k].double()
        if k == "sgating_b.3":
            assert not g.abs().max() and not w.abs().max()
            continue
        assert torch.isfinite(g).all() and w.abs().max() > 0, k
        assert torch.linalg.norm(g - w) <= 1e-5 * torch.linalg.norm(w), k


@pytest.mark.parametrize("backend", ["bucketed", "segment"])
def test_rectangular_interaction_pull(card, social_set, backend):
    """``interaction_norm`` ([U, I], one-sided row-normalized) and its
    transpose (MHCN's item convolution) through P1 and K7 (bucketed) or P2
    (segment), forward and backward, against the plain COO product: one P1
    and one K7, or one P2, a product,
    rtol 1e-5 with an atol of 1e-5 of the plain result's largest entry;
    twice, bit for bit."""
    data, triples = social_set
    graph = SocialDeviceGraph(data, triples, backend=backend, device=card)
    rng = np.random.default_rng(7)
    for adj in (graph.interaction_norm, graph.interaction_norm.transpose()):
        x = torch.tensor(rng.normal(size=(adj.n_cols, 64)), dtype=torch.float32, device=card)
        g = torch.tensor(rng.normal(size=(adj.n_rows, 64)), dtype=torch.float32, device=card)
        got = []
        for _ in range(2):
            xk = x.clone().requires_grad_()
            counters = (gather_rows, gather_sum, seg_ops.segment_sum)
            before = [f.launches for f in counters]
            y = spmm.adj_matmul(adj, xk)
            dx, = torch.autograd.grad(y, xk, g)
            torch.cuda.synchronize()
            launches = tuple(f.launches - b for f, b in zip(counters, before))
            assert launches == ((2, 2, 0) if backend == "bucketed" else (0, 0, 2)), launches
            got.append((y.detach(), dx))
        assert all(torch.equal(a, b) for a, b in zip(*got))
        xp = x.clone().requires_grad_()
        yp = spmm.segment_matmul_plain(adj, xp)
        dxp, = torch.autograd.grad(yp, xp, g)
        for a, b in ((got[0][0], yp.detach()), (got[0][1], dxp)):
            assert a.shape == b.shape and b.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


# -- NCL's E-step: the same bits every run (every rank of a sharded trainer) ----


@pytest.mark.parametrize("minibatch", [False, True], ids=["lloyd", "minibatch"])
def test_kmeans_repeats_bit_for_bit(card, minibatch):
    """k-means twice on the same rows of the clustered set's item count
    gives the same centroids and assignments bit for bit (the segment sums
    add each cluster's rows in row order, no atomics), and its centroids
    are the float64 means of their clusters' rows."""
    g = torch.Generator().manual_seed(3)
    centers = torch.randn(100, 64, generator=g) * 4
    x = (centers[torch.randint(0, 100, (100_000,), generator=g)]
         + torch.randn(100_000, 64, generator=g)).to(card)
    init = kmeans_init(g, x.shape[0], 100)
    batches = kmeans_batches(g, x.shape[0], 10, 65_536) if minibatch else None

    def run():
        if minibatch:
            return kmeans_minibatch(x, init, batches, 10)
        return kmeans(x, init, 10)

    (c1, a1), (c2, a2) = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert a1.dtype == torch.int32 and int(a1.min()) >= 0 and int(a1.max()) < 100
    if not minibatch:  # the last iteration's means (against its assignments' centroids)
        sums, counts = _segment_sums(x, a1.long(), 100)
        want = torch.zeros(100, 64, dtype=torch.float64, device=card).index_add_(
            0, a1.long(), x.double())
        torch.testing.assert_close(sums.double(), want, rtol=1e-5, atol=1e-3)
        assert torch.equal(counts, torch.bincount(a1.long(), minlength=100).float())


# -- the parallel layer on the card: two ranks over gloo on one device ----------


def test_sharded_gloo_world_on_the_card_is_the_single_step(card, tmp_path):
    """A (1, 2) world of two processes over gloo on the one card
    (``parallel.distributed``'s ``fit`` job; NCCL refuses two ranks on a
    device) trains one epoch of LightGCN on a bucketed graph: its tables,
    Adam moments and loss equal the single-device trainer's on the card bit
    for bit, and K7 and P1 launched in both ranks."""
    import json
    import pathlib

    from recommendation_tpu_torch.parallel.distributed import (
        WORKER,
        merged_checkpoint,
        spawn_world,
    )
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    np.savez(tmp_path / "pairs.npz", pairs=pairs, n_users=2000, n_items=4000, test_fraction=0.1)
    conf = {"embedding.size": 64, "batch.size": 2048, "max.epoch": 1, "eval.interval": 1,
            "graph.backend": "bucketed", "item.ranking.topN": [20]}
    data = ArrayInteraction(pairs, 2000, 4000, test_fraction=0.1)
    config = default_config(**conf, **{"checkpoint.dir": str(tmp_path / "single")})
    single = GraphRecommender(LightGCN(config), data, config,
                              graph=DeviceGraph(data, backend="bucketed", device=card),
                              log=Log(echo=False), device=card)
    single.build()
    single.train()
    torch.cuda.synchronize()
    argv = WORKER + ["--jobs", "fit", "--device", "cuda", "--backend", "gloo", "--data",
                     str(tmp_path / "pairs.npz"), "--mesh", "1x2", "--out", str(tmp_path)]
    for k, v in conf.items():
        argv += ["--set", f"{k}={v}"]
    root = pathlib.Path(__file__).resolve().parent.parent
    spawn_world(argv, 2, 300, str(tmp_path / "logs"), env={"PYTHONPATH": str(root)})
    want = merged_checkpoint(str(tmp_path / "single"), 0)
    got = merged_checkpoint(str(tmp_path / "ckpt"), 0)
    assert got["layout"] == {"data": 1, "model": 2, "rank": 0} and got["step"] == want["step"]
    for part in ("params", "exp_avg", "exp_avg_sq"):
        for k, v in want[part].items():
            assert got[part][k].shape == v.shape and torch.equal(got[part][k], v), (part, k)
    for r in range(2):
        rank = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert [e["loss"] for e in rank["epochs"]] == [e["loss"] for e in single.epoch_stats]
        assert rank["launches"]["gather_rows"] > 0 and rank["launches"]["gather_sum"] > 0
        assert rank["shard_rows"] == {"user_emb": 1000, "item_emb": 2000}


# -- the epoch as CUDA graphs (train/graphed.py) ------------------------------


def _graphed_setup(card, name, backend, seed=5):
    """A small graph, the model, its parameters on the card, a capturable
    Adam and the model's first state (NCL's E-step)."""
    from recommendation_tpu_torch.train.loop import make_optimizer

    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000,
                                         seed=seed)
    graph = DeviceGraph(Interaction(train, test), backend=backend, device=card)
    model = build(name, default_config(**{"embedding.size": 64, "NCL.num_clusters": 8}))
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    params = {k: v.requires_grad_() for k, v in params.items()}
    optimizer = make_optimizer(default_config(), params)
    state = model.epoch_begin(params, state, graph, torch.Generator().manual_seed(1), 0)
    return graph, model, params, optimizer, state


def _train_state(params, optimizer, state):
    moments = [{k: v.clone() for k, v in optimizer.state[p].items()} for p in params.values()]
    return ({k: v.detach().clone() for k, v in params.items()}, moments,
            {k: v.clone() for k, v in state.items()})


def _put_back(params, optimizer, saved):
    with torch.no_grad():
        for (k, v), m in zip(params.items(), saved[1]):
            v.copy_(saved[0][k])
            for key, t in m.items():
                optimizer.state[v][key].copy_(t)


def _same_train_state(got, want):
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for g, w in zip(got[1], want[1]):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k


@pytest.mark.parametrize("name,backend,spc", [("lightgcn", "dense", None),
                                              ("lightgcn", "bucketed", None),
                                              ("lightgcn", "bucketed", 4),
                                              ("lightgcn", "segment", None),
                                              ("ncl", "dense", None), ("ncl", "bucketed", None)])
def test_captured_epoch_is_the_eager_epoch(card, name, backend, spc):
    """After its warm-up run, a replayed epoch (or chunked epoch), which
    draws its words inside its graphs, equals ``train_epoch`` from the same
    parameters, moments, state and generator state bit for bit, leaves the
    generator where the eager epoch does, and adds the epoch's launches to
    the counters. A host generator cannot feed the epoch."""
    from recommendation_tpu_torch.ops.counts import count_delta, launch_counts
    from recommendation_tpu_torch.train.graphed import GraphedEpoch
    from recommendation_tpu_torch.train.loop import train_epoch

    graph, model, params, optimizer, state = _graphed_setup(card, name, backend)
    runner = GraphedEpoch(model, optimizer, graph, params, 256, steps_per_call=spc)
    with pytest.raises(ValueError, match="cannot feed"):
        runner.run(state, torch.Generator().manual_seed(2))
    draws = torch.Generator(device=card).manual_seed(2)
    before = launch_counts()
    state, _ = runner.run(state, draws)  # warm-up, capture
    torch.cuda.synchronize()
    eager_launches = count_delta(launch_counts(), before)
    assert runner.captures and eager_launches and not hasattr(runner, "words")
    start, start_draws = _train_state(params, optimizer, state), draws.get_state()
    before = launch_counts()
    got_state, got_loss = runner.run(state, draws)
    torch.cuda.synchronize()
    assert count_delta(launch_counts(), before) == eager_launches
    got, got_draws = _train_state(params, optimizer, got_state), draws.get_state()
    _put_back(params, optimizer, start)
    draws.set_state(start_draws)
    want_state, want_loss = train_epoch(model, optimizer, graph, params,
                                        {k: v.clone() for k, v in start[2].items()}, draws, 256)
    torch.cuda.synchronize()
    _same_train_state(got, _train_state(params, optimizer, want_state))
    assert torch.equal(got_loss, want_loss) and torch.isfinite(got_loss)
    assert torch.equal(got_draws, draws.get_state()) and not torch.equal(got_draws, start_draws)


def _trainer_on_card(card, data, graph, **extra):
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    config = default_config(**{"embedding.size": 64, "batch.size": 512, "eval.interval": 1,
                               "item.ranking.topN": [20], **extra})
    rec = GraphRecommender(LightGCN(config), data, config, graph=graph, log=Log(echo=False),
                           device=card)
    rec.build()
    return rec


def test_capture_again_after_a_checkpoint_restore(card, tmp_path):
    """A trainer whose epochs replay graphs restores a checkpoint
    (``load_state_dict`` gives the optimizer new moment tensors): it
    captures again, and its next epochs (a warm-up, then a replay) equal
    the straight run's."""
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    data = Interaction(train, test)
    graph = DeviceGraph(data, device=card)
    straight = _trainer_on_card(card, data, graph, **{"max.epoch": 3,
                                                      "checkpoint.dir": str(tmp_path / "a")})
    straight.train()
    rec = _trainer_on_card(card, data, graph, **{"max.epoch": 3})
    rec.train()
    assert len(rec._graphed.captures) == 1
    rec._restore(CheckpointManager(str(tmp_path / "a")).restore(0))
    assert not rec._graphed._graphs and rec.start_epoch == 1
    rec.epoch_stats = []
    rec.train()  # epoch 1 warms up and captures, epoch 2 replays
    torch.cuda.synchronize()
    assert len(rec._graphed.captures) == 2
    assert [e["loss"] for e in rec.epoch_stats] == [e["loss"] for e in straight.epoch_stats[1:]]
    for p, q in zip(rec.params.values(), straight.params.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(rec.optimizer.state[p][k], straight.optimizer.state[q][k]), k


@pytest.mark.parametrize("extra", [{"adaptive.lr": True}, {"eval.interval": 2},
                                   {"train.max_steps_per_call": 2, "train.steps_per_call": 4}],
                         ids=["bold_driver", "fused", "chunked"])
def test_captured_trainer_is_the_eager_trainer(card, extra):
    """The trainer's captured epochs, with the bold driver's rate moving
    between replays (a device tensor), in fused blocks, or chunked, equal
    the same trainer's eager epochs bit for bit."""
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    data = Interaction(train, test)
    graph = DeviceGraph(data, device=card)
    runs = []
    for graphed in (True, False):
        rec = _trainer_on_card(card, data, graph, **{"max.epoch": 4, **extra})
        assert rec._graphed is not None
        if not graphed:
            rec._graphed = None
        rec.train()
        torch.cuda.synchronize()
        runs.append(rec)
    assert runs[0]._graphed.captures
    assert [e["loss"] for e in runs[0].epoch_stats] == [e["loss"] for e in runs[1].epoch_stats]
    for k in runs[0].params:
        assert torch.equal(runs[0].params[k], runs[1].params[k]), k
    if "adaptive.lr" in extra:
        rate = runs[0].optimizer.param_groups[0]["lr"]
        assert rate.is_cuda and float(rate) == pytest.approx(runs[0]._bold.lrate, rel=1e-6)


def test_replays_draw_new_masks_and_each_is_the_eager_epoch(card):
    """GRACE (edge and feature masks in every step) on a trainer whose
    epochs replay a graph that registers its generator: two consecutive
    replays start from different generator states, so their words and
    first masks differ, and each replayed epoch equals ``train_epoch`` from
    the same parameters, moments, state and generator state."""
    from recommendation_tpu_torch.graph import augment
    from recommendation_tpu_torch.train.loop import train_epoch
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    data = Interaction(train, test)
    graph = DeviceGraph(data, device=card)
    config = default_config(**{"embedding.size": 64, "batch.size": 512})
    rec = GraphRecommender(build("grace", config), data, config, graph=graph,
                           log=Log(echo=False), device=card)
    rec.build()
    runner, draws = rec._graphed, rec._draws
    assert runner.capture and draws.device.type == "cuda"
    params, opt, model = rec.params, rec.optimizer, rec.model
    state, _ = runner.run(rec.state, draws)  # capture
    masks = []
    for k in range(2):
        start, start_draws = _train_state(params, opt, state), draws.get_state()
        first = torch.Generator(device=card)
        first.set_state(start_draws)
        epoch_words(first, graph, 512)  # the words come first
        masks.append(augment.keep_draw(first, graph.norm_adj_selfloops.vals.shape, 0.7, card))
        got_state, got_loss = runner.run(state, draws)
        torch.cuda.synchronize()
        got, got_draws = _train_state(params, opt, got_state), draws.get_state()
        _put_back(params, opt, start)
        draws.set_state(start_draws)
        want_state, want_loss = train_epoch(model, opt, graph, params, dict(start[2]), draws,
                                            512)
        torch.cuda.synchronize()
        _same_train_state(got, _train_state(params, opt, want_state))
        assert torch.equal(got_loss, want_loss) and torch.isfinite(got_loss)
        assert torch.equal(got_draws, draws.get_state())
        assert not torch.equal(got_draws, start_draws)
        state = want_state
    assert not torch.equal(masks[0], masks[1])
    assert len(runner.captures) == 1


def test_capturable_adam_is_optax(card):
    """The card's Adam (``capturable``: its bias correction on the device)
    against optax's arithmetic (``adam_plain``) on the same gradients,
    within the f32 bound."""
    from recommendation_tpu_torch.train.loop import adam_plain, make_optimizer

    rng = np.random.default_rng(4)
    p0 = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(card)
    grads = [torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(card)
             for _ in range(5)]
    leaf = p0.clone().requires_grad_()
    opt = make_optimizer(default_config(**{"learning.rate": 1e-2}), {"w": leaf})
    assert opt.defaults["capturable"]
    for g in grads:
        leaf.grad = g
        opt.step()
    want, mu, nu = adam_plain(p0, grads, 1e-2)
    torch.testing.assert_close(leaf.detach(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(opt.state[leaf]["exp_avg"], mu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(opt.state[leaf]["exp_avg_sq"], nu, rtol=1e-5, atol=1e-6)


# -- the score block as CUDA graphs; the configurations once eager ----------


def _card_service(card, has_pos_table=True):
    """A service on random tables of a small synthetic graph on the card
    (without the positives table: the host-CSR branch)."""
    import copy

    from recommendation_tpu_torch.serve.service import RecommenderService

    train, test = make_synthetic_dataset(n_users=1500, n_items=2000, n_interactions=40_000,
                                         seed=5)
    data = Interaction(train, test)
    graph = DeviceGraph(data, device=card)
    if not has_pos_table:
        graph = copy.copy(graph)
        graph.has_pos_table = False
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.normal(size=(data.user_num, 64)).astype(np.float32)).to(card)
    i = torch.from_numpy(rng.normal(size=(data.item_num, 64)).astype(np.float32)).to(card)
    return RecommenderService(u, i, data, graph)


@pytest.mark.parametrize("branch", ["table", "host_csr"])
def test_score_block_graphs_replay_the_eager_block(card, branch):
    """Every padded wave size (1 to 1,024 rows, and 1,100 users: a 1,024
    block and a 128 tail), with and without exclusions and at two k: the
    service's replayed graph gives the eager padded block's bits on the
    same inputs; every wave is a replay, one capture a shape."""
    service = _card_service(card, branch == "table")
    eager = service.eager_block()
    rng = np.random.default_rng(3)
    waves = 0
    for b in [1, 2, 3, 4, 8, 16, 32, 64, 100, 256, 512, 1024, 1100]:
        for k, exclude in ((10, True), (10, False), (7, True)):
            uids = rng.integers(0, service.data.user_num, b).tolist()
            got = service._recommend_ids_device(uids, k, exclude)
            padded, pos = service.wave_inputs(uids, exclude)
            want = eager.topk_ids(padded, k, pos)
            waves += 1
            for g, w in zip(got, want):
                assert np.array_equal(g, w[:b]), (b, k, exclude)
    stats = service.block.stats
    assert stats["eager"] == 0 and stats["replays"] >= waves
    assert len(service.block.captures) == len(service.block.keys)


def test_one_evaluation_block_serves_two_threads(card):
    """Two threads evaluate two item tables through one ``ScoreBlock`` (the
    graph's evaluation block, whose graphs read one static item table): each
    call's answers are its own table's, bit for bit the eager block's."""
    from recommendation_tpu_torch.ops.topk import ScoreBlock, topk_with_exclusions

    rng = np.random.default_rng(5)
    users = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32)).to(card)
    tables = [torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(card)
              for _ in range(2)]
    pos = torch.from_numpy(rng.integers(-1, 2000, (300, 8)).astype(np.int32)).to(card)
    want = [topk_with_exclusions(users, t, pos, 10, batch_size=128) for t in tables]
    block = ScoreBlock(tables[0])
    topk_with_exclusions(users, tables[1], pos, 10, batch_size=128, block=block)  # captures
    errors = []

    def evaluate(t):
        for _ in range(20):
            got = topk_with_exclusions(users, tables[t], pos, 10, batch_size=128, block=block)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want[t])):
                errors.append(t)

    threads = [threading.Thread(target=evaluate, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == [] and block.stats["eager"] == 0 and len(block.captures) == 2


def test_segment_sums_capture_without_a_host_read(card):
    """k-means' segment sums (the cluster counts read off the sorted
    assignments) capture in a CUDA graph, whose replay gives the eager
    call's bits and ``torch.bincount``'s counts."""
    from recommendation_tpu_torch.ops.kmeans import _segment_sums

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(5000, 64)).astype(np.float32)).to(card)
    assign = torch.from_numpy(rng.integers(0, 97, 5000)).to(card)
    want_sums, want_counts = _segment_sums(x, assign, 100)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        _segment_sums(x, assign, 100)  # warm-up
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sums, counts = _segment_sums(x, assign, 100)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    assert torch.equal(counts, torch.bincount(assign, minlength=100).float())


@pytest.mark.parametrize("case", ["pointwise", "bce_n_negs_3", "ncl_batch_e_step", "bold_sgd"])
def test_captured_epoch_is_the_eager_epoch_for_the_drawing_steps(card, case):
    """The configurations that trained eagerly before they were captured
    (LightGCN's pointwise loss and ``n_negs`` 3, NCL's per-batch E-step,
    the bold driver's SGD with its tensor rate moved): on the trainer, a
    replayed epoch equals ``train_epoch`` from the same parameters,
    optimizer state, model state and generator state; the steps that draw
    move the generator past the words' share, the bold driver's does not."""
    from recommendation_tpu_torch.train.loop import set_learning_rate, train_epoch
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    name, extra = {"pointwise": ("lightgcn", {"loss": "pointwise"}),
                   "bce_n_negs_3": ("lightgcn", {"loss": "bce", "n_negs": 3}),
                   "ncl_batch_e_step": ("ncl", {"NCL.e_step_cadence": "batch",
                                                "NCL.num_clusters": 8}),
                   "bold_sgd": ("lightgcn", {"adaptive.lr": True, "optimizer": "sgd",
                                             "learning.rate": 0.05})}[case]
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    data = Interaction(train, test)
    graph = DeviceGraph(data, device=card)
    config = default_config(**{"embedding.size": 64, "batch.size": 512, **extra})
    rec = GraphRecommender(build(name, config), data, config, graph=graph, log=Log(echo=False),
                           device=card)
    rec.build()
    runner, draws = rec._graphed, rec._draws
    assert runner is not None and runner.capture
    params, opt, model = rec.params, rec.optimizer, rec.model
    state, _ = runner.run(rec.state, draws)  # capture
    if case == "bold_sgd":
        set_learning_rate(opt, 0.0525)  # the bold driver's move, into the tensor rate
    start, start_draws = _train_state(params, opt, state), draws.get_state()
    got_state, got_loss = runner.run(state, draws)
    torch.cuda.synchronize()
    got, got_draws = _train_state(params, opt, got_state), draws.get_state()
    _put_back(params, opt, start)
    draws.set_state(start_draws)
    want_state, want_loss = train_epoch(model, opt, graph, params, dict(start[2]), draws, 512)
    torch.cuda.synchronize()
    _same_train_state(got, _train_state(params, opt, want_state))
    assert torch.equal(got_loss, want_loss) and torch.isfinite(got_loss)
    assert torch.equal(got_draws, draws.get_state()) and len(runner.captures) == 1
    words_only = torch.Generator(device=card)
    words_only.set_state(start_draws)
    epoch_words(words_only, graph, 512)
    assert torch.equal(got_draws, words_only.get_state()) == (case == "bold_sgd")


def test_tensor_rate_sgd_is_torch_sgd(card):
    """The bold driver's SGD (``make_bold_driver_optimizer``: torch's fused
    SGD, its rate a tensor on the card) against ``torch.optim.SGD`` with the
    float rate: bit for bit over five steps, the rate moved after two; the
    first step eager, the other four replays of one captured step that
    reads the rate where ``set_learning_rate`` fills it."""
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.train.loop import make_bold_driver_optimizer, set_learning_rate

    rng = np.random.default_rng(6)
    p0 = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(card)
    leaves = [p0.clone().requires_grad_() for _ in range(2)]
    ours, _ = make_bold_driver_optimizer(
        default_config(**{"optimizer": "sgd", "learning.rate": 0.0137, "momentum": 0.9}),
        {"w": leaves[0]})
    ref = torch.optim.SGD([leaves[1]], lr=0.0137, momentum=0.9)
    assert ours.param_groups[0]["lr"].is_cuda and ours.param_groups[0]["fused"]
    leaves[0].grad = torch.empty_like(p0)
    graph = None
    for step in range(5):
        g = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(card)
        for opt in (ours, ref):
            set_learning_rate(opt, 0.0137 * (1.05 if step >= 2 else 1.0))
        leaves[0].grad.copy_(g)
        leaves[1].grad = g
        if step == 0:
            ours.step()
        else:
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                stream = torch.cuda.Stream(card)
                stream.wait_stream(torch.cuda.current_stream(card))
                with torch.cuda.graph(graph, stream=stream):
                    ours.step()
            graph.replay()
        ref.step()
        torch.cuda.synchronize()
        assert torch.equal(leaves[0], leaves[1]), step
