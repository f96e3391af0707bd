"""Kernels K1 and K2 through their plain versions (``ops/prop.py``:
``chain_mean_plain``, ``chain_mean_bwd_plain``, and ``chain_mean``,
``chain_mean_bwd`` and ``ChainMean`` on CPU tensors) against the JAX
package's layer chain: the Pallas kernel in interpret mode
(``dense_chain_mean(..., interpret=True)``, whose custom VJP runs the
kernel's backward) and the XLA chain of ``lightgcn_propagate``, values and
gradients. Kernels K3 and K4 likewise: ``ChainMeanLayer`` on CPU tensors
against ``dense_chain_mean_layer(..., interpret=True)``, all four outputs
and the gradients through all four.

Tolerances: where both sides multiply the same real graph, rtol 1e-5 /
atol 1e-6 in both regimes (the two sum in another order; the bf16 regime
rounds the same f32 tables to bf16). On random O(1) inputs the bf16 regime
uses the JAX kernel's own test bounds, rtol 2e-2 / atol 2e-3 on values and
3e-2 / 3e-3 on gradients: a different summation order can move a table
across a bf16 rounding boundary, and the XLA chain's autodiff rounds the
backward products' outputs where the kernels round their operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.lightgcn import lightgcn_propagate as jax_propagate
from recommendation_tpu.ops.pallas_prop import dense_chain_mean, dense_chain_mean_layer
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
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

TIGHT = dict(rtol=1e-5, atol=1e-6)
BF16_RANDOM = dict(rtol=2e-2, atol=2e-3)
BF16_RANDOM_GRAD = dict(rtol=3e-2, atol=3e-3)
SERVE = dict(n_users=943, n_items=1682, n_interactions=100_000, seed=7)


class _Adj:
    """The one attribute of ``DeviceAdj`` the bipartite branch reads."""

    def __init__(self, compute_dtype):
        self.compute_dtype = compute_dtype


def _tables(rng, n_u, n_i, d, scale=None):
    if scale is None:  # xavier-uniform, as LightGCN's init
        lim_u, lim_i = np.sqrt(6.0 / (n_u + d)), np.sqrt(6.0 / (n_i + d))
        return (rng.uniform(-lim_u, lim_u, (n_u, d)).astype(np.float32),
                rng.uniform(-lim_i, lim_i, (n_i, d)).astype(np.float32))
    return (rng.normal(size=(n_u, d)).astype(np.float32) * scale,
            rng.normal(size=(n_i, d)).astype(np.float32) * scale)


def _ours(r_np, u0, i0, n_layers, dtype):
    r = torch.tensor(r_np).to(dtype)  # a copy: JAX's numpy views are read-only
    u, i = chain_mean_plain(r, torch.from_numpy(u0), torch.from_numpy(i0), n_layers)
    return u.numpy(), i.numpy()


def _jax_xla(r_np, u0, i0, n_layers, compute_dtype):
    u, i = jax_propagate(jnp.asarray(u0), jnp.asarray(i0), _Adj(compute_dtype), n_layers,
                         bipartite_dense=jnp.asarray(r_np))
    return np.asarray(u), np.asarray(i)


def _jax_pallas(r_np, u0, i0, n_layers, compute_dtype):
    r = jnp.asarray(r_np)
    if compute_dtype == "bfloat16":
        r = r.astype(jnp.bfloat16)
    u, i = dense_chain_mean(r, jnp.asarray(u0), jnp.asarray(i0), n_layers, True)
    return np.asarray(u), np.asarray(i)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **tol)


DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_unaligned_random_matches_pallas_interpret(n_layers, compute_dtype, dtype):
    rng = np.random.default_rng(0)
    n_u, n_i, d = 37, 53, 8  # deliberately unaligned, as tests/test_pallas_prop.py
    r = rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1
    u0, i0 = _tables(rng, n_u, n_i, d, scale=1.0)
    tol = TIGHT if dtype == torch.float32 else BF16_RANDOM
    want = _jax_pallas(r, u0, i0, n_layers, compute_dtype)
    _close(_ours(r, u0, i0, n_layers, dtype), want, tol)
    _close(_jax_xla(r, u0, i0, n_layers, compute_dtype), want, tol)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_tiny_graph_matches_pallas_and_xla(tiny_graph, n_layers, compute_dtype, dtype):
    rng = np.random.default_rng(1)
    r = np.asarray(tiny_graph.interaction_norm_dense)
    u0, i0 = _tables(rng, r.shape[0], r.shape[1], 16)
    got = _ours(r, u0, i0, n_layers, dtype)
    _close(got, _jax_pallas(r, u0, i0, n_layers, compute_dtype), TIGHT)
    _close(got, _jax_xla(r, u0, i0, n_layers, compute_dtype), TIGHT)


@pytest.fixture(scope="module")
def serve_r_hat():
    """R̂ of the serving shape: synthetic ML-100K as bench.py builds it."""
    train, test = make_synthetic_dataset(**SERVE)
    graph = JaxDeviceGraph(JaxInteraction(train, test), backend="dense")
    return np.asarray(graph.interaction_norm_dense)


@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_serve_shape_matches_xla_chain(serve_r_hat, compute_dtype, dtype):
    assert serve_r_hat.shape == (943, 1676)
    rng = np.random.default_rng(2)
    u0, i0 = _tables(rng, 943, 1676, 64)
    got = _ours(serve_r_hat, u0, i0, 3, dtype)
    _close(got, _jax_xla(serve_r_hat, u0, i0, 3, compute_dtype), TIGHT)
    _close(got, _jax_pallas(serve_r_hat, u0, i0, 3, compute_dtype), TIGHT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_mean_on_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.normal(size=(11, 7)).astype(np.float32)).to(dtype)
    u0 = torch.from_numpy(rng.normal(size=(11, 5)).astype(np.float32))
    i0 = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    before = chain_mean.launches
    for n_layers in (0, 1, 2, 3, 4):
        got = chain_mean(r, u0, i0, n_layers)
        want = chain_mean_plain(r, u0, i0, n_layers)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(chain_mean(r, u0, i0, 0)[0], u0)
    assert chain_mean.launches == before  # the kernel never ran on the CPU


def test_chain_mean_checks_its_inputs():
    r = torch.zeros(4, 3)
    u0, i0 = torch.zeros(4, 2), torch.zeros(3, 2)
    with pytest.raises(TypeError):
        chain_mean(r.half(), u0, i0, 1)
    with pytest.raises(TypeError):
        chain_mean(r, u0.double(), i0, 1)
    with pytest.raises(ValueError):
        chain_mean(r, torch.zeros(5, 2), i0, 1)
    with pytest.raises(ValueError):
        chain_mean(r, u0, torch.zeros(3, 4), 1)
    with pytest.raises(ValueError):
        chain_mean(r[None], u0, i0, 1)
    with pytest.raises(ValueError):
        chain_mean(r, u0, i0, -1)
    with pytest.raises(ValueError):
        chain_mean(r.to("meta"), u0.to("meta"), i0.to("meta"), 1)


# -- gradients: ChainMean (K1 forward + K2 backward) --------------------------


def _scalarize(a, b, lib):
    """The JAX kernel test's loss: sum(a*a) + sum(sin(b))."""
    return lib.sum(a * a) + lib.sum(lib.sin(b))


def _grads_ours(r_np, u0, i0, n_layers, dtype):
    r = torch.tensor(r_np).to(dtype)
    u = torch.tensor(u0, requires_grad=True)
    i = torch.tensor(i0, requires_grad=True)
    a, b = ChainMean.apply(r, u, i, n_layers)
    _scalarize(a, b, torch).backward()
    return u.grad.numpy(), i.grad.numpy()


def _grads_jax(r_np, u0, i0, n_layers, compute_dtype, pallas):
    if pallas:
        r = jnp.asarray(r_np)
        r = r.astype(jnp.bfloat16) if compute_dtype == "bfloat16" else r

        def chain(u, i):
            return dense_chain_mean(r, u, i, n_layers, True)
    else:
        def chain(u, i):
            return jax_propagate(u, i, _Adj(compute_dtype), n_layers,
                                 bipartite_dense=jnp.asarray(r_np))

    g = jax.grad(lambda u, i: _scalarize(*chain(u, i), jnp), argnums=(0, 1))(
        jnp.asarray(u0), jnp.asarray(i0))
    return tuple(np.asarray(x) for x in g)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_grads_unaligned_random_match_jax(n_layers, compute_dtype, dtype):
    rng = np.random.default_rng(4)
    n_u, n_i, d = 37, 53, 8
    r = rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1
    u0, i0 = _tables(rng, n_u, n_i, d, scale=1.0)
    tol = TIGHT if dtype == torch.float32 else BF16_RANDOM_GRAD
    got = _grads_ours(r, u0, i0, n_layers, dtype)
    _close(got, _grads_jax(r, u0, i0, n_layers, compute_dtype, pallas=True), tol)
    _close(got, _grads_jax(r, u0, i0, n_layers, compute_dtype, pallas=False), tol)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_grads_tiny_graph_match_jax(tiny_graph, n_layers, compute_dtype, dtype):
    """On a real normalized R̂ the f32 bounds hold in both regimes for the
    Pallas kernel's backward, which rounds the same operands as K2."""
    rng = np.random.default_rng(5)
    r = np.asarray(tiny_graph.interaction_norm_dense)
    u0, i0 = _tables(rng, r.shape[0], r.shape[1], 16)
    got = _grads_ours(r, u0, i0, n_layers, dtype)
    _close(got, _grads_jax(r, u0, i0, n_layers, compute_dtype, pallas=True), TIGHT)
    xla_tol = TIGHT if dtype == torch.float32 else BF16_RANDOM_GRAD
    _close(got, _grads_jax(r, u0, i0, n_layers, compute_dtype, pallas=False), xla_tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_mean_bwd_on_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(6)
    r = torch.from_numpy(rng.normal(size=(11, 7)).astype(np.float32)).to(dtype)
    gu = torch.from_numpy(rng.normal(size=(11, 5)).astype(np.float32))
    gi = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    before = chain_mean_bwd.launches
    for n_layers in (0, 1, 2, 3, 4):
        got = chain_mean_bwd(r, gu, gi, n_layers)
        want = chain_mean_bwd_plain(r, gu, gi, n_layers)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(chain_mean_bwd(r, gu, gi, 0)[0], gu)
    u = torch.zeros(11, 5, requires_grad=True)
    a, b = ChainMean.apply(r, u, torch.zeros(7, 5), 3)
    (a.sum() + b.sum()).backward()
    assert u.grad is not None
    assert chain_mean_bwd.launches == before  # the kernel never ran on the CPU


def test_chain_mean_bwd_checks_its_inputs():
    r = torch.zeros(4, 3)
    gu, gi = torch.zeros(4, 2), torch.zeros(3, 2)
    with pytest.raises(TypeError):
        chain_mean_bwd(r.half(), gu, gi, 1)
    with pytest.raises(TypeError):
        chain_mean_bwd(r, gu.double(), gi, 1)
    with pytest.raises(ValueError):
        chain_mean_bwd(r, torch.zeros(5, 2), gi, 1)
    with pytest.raises(ValueError):
        chain_mean_bwd(r, gu, gi, -1)
    with pytest.raises(ValueError):
        chain_mean_bwd(r.to("meta"), gu.to("meta"), gi.to("meta"), 1)


# -- ChainMeanLayer: K3 forward + K4 backward, NCL's chain ---------------------

LAYER_CASES = [(3, 1), (3, 2), (3, 3), (1, 1)]


def _scalarize4(outs, lib):
    """tests/test_pallas_prop.py's loss over the four outputs: a distinct
    nonlinearity on each, so each cotangent is distinct."""
    au, ai, uk, ik = outs
    return lib.sum(au ** 2) + lib.sum(lib.sin(ai)) + lib.sum(lib.cos(uk)) + lib.sum(lib.tanh(ik))


def _layer_ours(r_np, u0, i0, n_layers, k, dtype):
    r = torch.tensor(r_np).to(dtype)
    u = torch.tensor(u0, requires_grad=True)
    i = torch.tensor(i0, requires_grad=True)
    outs = ChainMeanLayer.apply(r, u, i, n_layers, k)
    _scalarize4(outs, torch).backward()
    return [o.detach().numpy() for o in outs], (u.grad.numpy(), i.grad.numpy())


def _layer_jax(r_np, u0, i0, n_layers, k, compute_dtype):
    r = jnp.asarray(r_np)
    r = r.astype(jnp.bfloat16) if compute_dtype == "bfloat16" else r

    def chain(u, i):
        return dense_chain_mean_layer(r, u, i, n_layers, k, True)

    outs = chain(jnp.asarray(u0), jnp.asarray(i0))
    g = jax.grad(lambda u, i: _scalarize4(chain(u, i), jnp), argnums=(0, 1))(
        jnp.asarray(u0), jnp.asarray(i0))
    return [np.asarray(o) for o in outs], tuple(np.asarray(x) for x in g)


@pytest.mark.parametrize("n_layers,k", LAYER_CASES)
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_chain_layer_unaligned_random_matches_pallas_interpret(n_layers, k, compute_dtype, dtype):
    rng = np.random.default_rng(7)
    n_u, n_i, d = 37, 53, 8
    r = rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1
    u0, i0 = _tables(rng, n_u, n_i, d, scale=1.0)
    got, got_g = _layer_ours(r, u0, i0, n_layers, k, dtype)
    want, want_g = _layer_jax(r, u0, i0, n_layers, k, compute_dtype)
    f32 = dtype == torch.float32
    _close(got, want, TIGHT if f32 else BF16_RANDOM)
    _close(got_g, want_g, TIGHT if f32 else BF16_RANDOM_GRAD)


@pytest.mark.parametrize("n_layers,k", LAYER_CASES)
@pytest.mark.parametrize("compute_dtype,dtype", DTYPES, ids=["f32", "bf16"])
def test_chain_layer_tiny_graph_matches_pallas_interpret(tiny_graph, n_layers, k,
                                                         compute_dtype, dtype):
    """On a real normalized R̂ the f32 bounds hold in both regimes, as for
    K1/K2: both sides round the same operands."""
    rng = np.random.default_rng(8)
    r = np.asarray(tiny_graph.interaction_norm_dense)
    u0, i0 = _tables(rng, r.shape[0], r.shape[1], 16)
    got, got_g = _layer_ours(r, u0, i0, n_layers, k, dtype)
    want, want_g = _layer_jax(r, u0, i0, n_layers, k, compute_dtype)
    _close(got, want, TIGHT)
    _close(got_g, want_g, TIGHT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_mean_layer_on_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(9)
    r = torch.from_numpy(rng.normal(size=(11, 7)).astype(np.float32)).to(dtype)
    u0 = torch.from_numpy(rng.normal(size=(11, 5)).astype(np.float32))
    i0 = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    g = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (u0, i0, u0, i0)]
    before = chain_mean_layer.launches, chain_mean_layer_bwd.launches
    for n_layers in (1, 2, 3, 4):
        for k in range(1, n_layers + 1):
            got = chain_mean_layer(r, u0, i0, n_layers, k)
            want = chain_mean_layer_plain(r, u0, i0, n_layers, k)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            # the mean is K1's
            assert all(torch.equal(a, b) for a, b in zip(got[:2], chain_mean(r, u0, i0, n_layers)))
            got = chain_mean_layer_bwd(r, *g, n_layers, k)
            want = chain_mean_layer_bwd_plain(r, *g, n_layers, k)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    # without a layer cotangent, K4 is K2
    zeros = [torch.zeros_like(u0), torch.zeros_like(i0)]
    got = chain_mean_layer_bwd(r, g[0], g[1], *zeros, 3, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, chain_mean_bwd(r, g[0], g[1], 3)))
    # the snapshot of layer 1 is one product of layer 0
    _, _, u1, i1 = chain_mean_layer(r, u0, i0, 3, 1)
    rf = r.float()
    cast = (lambda x: x.to(torch.bfloat16).float()) if dtype == torch.bfloat16 else (lambda x: x)
    assert torch.equal(u1, rf @ cast(i0)) and torch.equal(i1, rf.T @ cast(u0))
    assert (chain_mean_layer.launches, chain_mean_layer_bwd.launches) == before


def test_chain_mean_layer_checks_its_inputs():
    r = torch.zeros(4, 3)
    u0, i0 = torch.zeros(4, 2), torch.zeros(3, 2)
    for k in (0, 4, 1.0):
        with pytest.raises(ValueError, match="layer k"):
            chain_mean_layer(r, u0, i0, 3, k)
    with pytest.raises(ValueError, match="layer k"):
        chain_mean_layer_bwd(r, u0, i0, u0, i0, 3, 0)
    with pytest.raises(TypeError):
        chain_mean_layer(r.half(), u0, i0, 3, 1)
    with pytest.raises(ValueError):
        chain_mean_layer_bwd(r, u0, i0, torch.zeros(5, 2), i0, 3, 1)
    with pytest.raises(ValueError):
        chain_mean_layer(r.to("meta"), u0.to("meta"), i0.to("meta"), 3, 1)
