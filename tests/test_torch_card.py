"""Kernels K1 and K2 (``csrc/chain_mean.cu``) against their plain versions,
on the card; ``ChainMean``'s gradient on the card; one training step
through the kernels against the same step through the plain chain. The
same for NCL's kernels: K3 and K4 (``csrc/chain_mean.cu``), K5 and K6
(``csrc/catalog_lse.cu``), ``ChainMeanLayer``'s and ``CatalogLSE``'s
gradients, and one NCL step with the layer contrast at unit weight.

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
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.ops.lse import (
    CatalogLSE,
    catalog_lse,
    catalog_lse_bwd,
    catalog_lse_bwd_plain,
    catalog_lse_plain,
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
    assert (catalog_lse.launches, catalog_lse_bwd.launches) == (before[0] + 1, before[1] + 2)
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
        before[0] + 3, before[1] + 2)
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
    assert n_k == (3, 3, 2, 4) and n_p == (0, 0, 0, 0)
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    dtype = graph.propagation_matrix.dtype
    assert _grads_close(g_k, g_p, dtype)
    assert not _grads_close([torch.zeros_like(g) for g in g_p], g_p, dtype)
