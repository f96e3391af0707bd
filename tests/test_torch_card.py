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
(``csrc/segment.cu``): S1 (the multi-head weighted pull), S2 (the segment
softmax and its backward) and S3 (the per-slot head dot) against their
plain versions and bit for bit across two calls, on a segment view with
split hub rows and on bucket rows; one step of GAT (dense, segment and
bucketed backends), GraphSAGE, LightGCN on the segment backend and GRACE
and G-BT on a bucketed graph against their plain paths.
Calls on two streams at once equal the same calls in turn (the chain's tile
counters, P1's and S1's piece counters, K5's and K6's partials).

These tests need a CUDA device and ``nvcc``; elsewhere they skip. This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import (
    ArrayInteraction,
    make_flat_interactions,
    make_synthetic_dataset,
)
from recommendation_tpu_torch.graph.bucketed import (
    bucketed_chain_mean,
    bucketed_chain_mean_plain,
    packs_bf16,
)
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.bgrl import PlainBucketedBGRL
from recommendation_tpu_torch.models.buir import PlainBucketedBUIR
from recommendation_tpu_torch.models.directau import PlainBucketedDirectAU
from recommendation_tpu_torch.models.gat import PlainGAT
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
                                   (1, 1, 1), (70, 65, 520)])
def test_lse_kernels_match_plain(card, b, n, d):
    rng = np.random.default_rng(b + n + d)
    q, x = _unit_rows(card, rng, b, d), _unit_rows(card, rng, n, d)
    (g,) = _random(card, rng, (b,))
    if d > 512:
        with pytest.raises(ValueError, match="d <= 512"):
            catalog_lse(q, x, 0.1)
        return
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


@pytest.mark.parametrize("d", [1, 24, 64, 130, 512])
@pytest.mark.parametrize("b,n", [(70, 130), (1, 700), (200, 40)],
                         ids=["ragged", "one-query", "under-one-item-tile"])
def test_lse_backward_across_tiles(card, b, n, d):
    """K6 where B and N are not multiples of its 64-row tiles, N is below
    one tile, B is 1, and d is cut into 64-column slices (130, 512) or
    below one (1, 24): dq and dx against the plain version, and two calls
    equal bit for bit."""
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
                                   (2048, 100_000, 64), (70, 130, 130)])
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
                                   (37, 700, 24), (70, 130, 130)])
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
    srcs = _random(card, rng, *[(csr.total_rows + 1, 64)] * 2)
    return [lambda y=y: [gather_sum(y, csr.ridx, csr.row_ptr, post=csr.sep_dst,
                                    skip=csr.total_rows, schedule=csr.schedule)] for y in srcs]


@pytest.mark.parametrize("kernel", ["chain", "lse", "lse_bwd", "pull", "weighted_pull"])
def test_calls_on_two_streams_equal_calls_in_turn(card, kernel):
    """Two calls launched on two streams at once give what the same calls
    give one after the other on one stream, bit for bit, ten times over:
    the chain's tile counters, P1's and S1's piece counters and K5's and
    K6's partials are not mixed between streams."""
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
    dtype = torch.bfloat16 if packs_bf16(compute_dtype, d) else torch.float32
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


# -- the segment kernels: S1 (weighted pull), S2 (segment softmax), S3 (head dot) --


def _segment_view(card):
    """The destination view of a power-law graph's bidirectional edges: its
    hub rows hold more than one CHUNK of slots, so S1 splits them."""
    pairs = make_flat_interactions(2000, 4000, 40_000, seed=1)
    graph = DeviceGraph(ArrayInteraction(pairs, 2000, 4000), backend="segment", device=card)
    return graph.bipartite_views()[1]


def _segment_inputs(card, view, heads, d, seed):
    rng = np.random.default_rng(seed)
    x, w, e, g, gy = _random(card, rng, (view.n_cols, heads * d), (view.n_slots, heads),
                             (view.n_slots, heads), (view.n_slots, heads),
                             (view.n_rows, heads * d))
    live = torch.from_numpy(rng.random(view.n_slots) > 0.1).to(card)
    return x, w, e * 3, g, gy, live


def _repeats_and_agrees(name, fn, plain, rtol=1e-5):
    """Two kernel calls equal bit for bit, and the plain version at rtol
    and an atol of 1e-5 of the plain result's largest entry (the kernel
    sums in slot order, the plain version in its own)."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(got, again), name
    want = plain()
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * want.abs().max().item(),
                               msg=name)


@pytest.mark.parametrize("heads,d", [(1, 64), (4, 64), (4, 5), (2, 3)])
def test_segment_kernels_match_plain(card, heads, d):
    view = _segment_view(card)
    x, w, e, g, gy, live = _segment_inputs(card, view, heads, d, heads * 100 + d)
    before = (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches,
              seg_ops.segment_softmax_rows_bwd.launches, seg_ops.segment_dot.launches)
    _repeats_and_agrees("S1", lambda: seg_ops.weighted_pull(x, w, view.idx, view.row_ptr,
                                                            view.schedule),
                        lambda: seg_ops.weighted_pull_plain(x, w, view.idx, view.row_ptr))
    _repeats_and_agrees("S2", lambda: seg_ops.segment_softmax_rows(e, view.row_ptr, live),
                        lambda: seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live))
    att = seg_ops.segment_softmax_rows_plain(e, view.row_ptr, live)
    _repeats_and_agrees("S2 bwd", lambda: seg_ops.segment_softmax_rows_bwd(att, g, view.row_ptr),
                        lambda: seg_ops.segment_softmax_rows_bwd_plain(att, g, view.row_ptr))
    rows = view.slot_row
    _repeats_and_agrees("S3", lambda: seg_ops.segment_dot(gy, rows, x, view.idx, heads),
                        lambda: seg_ops.segment_dot_plain(gy, rows, x, view.idx, heads))
    after = (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches,
             seg_ops.segment_softmax_rows_bwd.launches, seg_ops.segment_dot.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 2]
    # no live slot in a row: its weights are 0
    none = seg_ops.segment_softmax_rows(e, view.row_ptr, torch.zeros_like(live))
    assert not none.any()


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


def test_segment_wrappers_refuse_what_the_kernels_do_not_take(card):
    ptr = torch.tensor([0, 2, 3], device=card)
    with pytest.raises(ValueError, match="divides 32"):
        seg_ops.segment_softmax_rows(torch.zeros(3, 3, device=card), ptr)
    with pytest.raises(TypeError):
        seg_ops.segment_softmax_rows(torch.zeros(3, 2, device=card, dtype=torch.float64), ptr)
    idx = torch.zeros(3, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        seg_ops.weighted_pull(torch.zeros(4, 8, device=card), torch.zeros(3, 2, device=card),
                              idx.long(), ptr)
    with pytest.raises(ValueError, match="contiguous"):
        seg_ops.segment_dot(torch.zeros(4, 16, device=card)[:, ::2], idx,
                            torch.zeros(4, 8, device=card), idx, 2)
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


# a step's segment-kernel and P1/K7 launches: GAT's two layers (S2 and S1
# forward; S3, S2's backward, S1 and two P1 backward; K7 once forward and
# three times backward a layer on the bucket rows), GraphSAGE's two means
# (P1; the first takes no backward: the features are fixed), LightGCN's
# three segment matmuls both ways, GRACE's and G-BT's two views of two
# segment matmuls both ways
_S = {"weighted_pull": 4, "segment_softmax_rows": 2, "segment_softmax_rows_bwd": 2,
      "segment_dot": 2, "gather_sum": 4}
SEGMENT_CASES = {
    ("gat", "dense"): (PlainGAT, _S),
    ("gat", "segment"): (PlainGAT, _S),
    ("gat", "bucketed"): (PlainGAT, {**_S, "gather_rows": 8}),
    ("graphsage", "dense"): (PlainGraphSAGE, {"gather_sum": 3}),
    ("graphsage", "bucketed"): (PlainGraphSAGE, {"gather_sum": 3}),
    ("lightgcn", "segment"): (None, {"gather_sum": 6}),
    ("grace", "bucketed"): (None, {"gather_sum": 8}),
    ("gbt", "bucketed"): (None, {"gather_sum": 8}),
}


@pytest.mark.parametrize("name,backend", list(SEGMENT_CASES),
                         ids=["-".join(c) for c in SEGMENT_CASES])
def test_segment_step_kernel_vs_plain(card, monkeypatch, name, backend):
    """One step through the segment kernels and P1 (and K7) against the
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
    counters = {f.__name__: f for f in (gather_rows, gather_sum, seg_ops.weighted_pull,
                                         seg_ops.segment_softmax_rows,
                                         seg_ops.segment_softmax_rows_bwd, seg_ops.segment_dot)}
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
