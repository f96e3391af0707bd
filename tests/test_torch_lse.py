"""Kernels K5 and K6 through their plain versions (``ops/lse.py``:
``catalog_lse_plain``, ``catalog_lse_bwd_plain``, and ``catalog_lse``,
``catalog_lse_bwd`` and ``CatalogLSE`` on CPU tensors) against the JAX
package's streaming logsumexp: the Pallas kernels in interpret mode
(``catalog_logsumexp(q, x, tau, block_n, True)``, whose custom VJP runs the
backward kernel) and the XLA oracle ``catalog_logsumexp_reference``.

Tolerances are the JAX kernel's own tests' (tests/test_pallas_losses.py):
values at atol 1e-4; gradients at atol 1e-3 for τ = 0.5, and at rtol 1e-3 /
atol 2e-2 for τ = 0.2, where O(1) inputs give scores of order 20 and the
f32 recompute of exp(s − lse) moves large gradients by about 3e-4 of their
size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendation_tpu.ops.pallas_losses import catalog_logsumexp, catalog_logsumexp_reference
from recommendation_tpu_torch.ops.lse import (
    TILE,
    CatalogLSE,
    catalog_lse,
    catalog_lse_bwd,
    catalog_lse_bwd_plain,
    catalog_lse_plain,
    catalog_lse_split_plain,
    lse_fwd_plan,
)


def _inputs(seed, b, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("b,n,d,block_n", [(16, 700, 32, 256), (37, 700, 24, 256),
                                           (5, 300, 16, 128)])
def test_values_match_pallas_interpret_and_reference(b, n, d, block_n):
    """A partial item block (N not a multiple of block_n) and ragged B."""
    q, x = _inputs(b + n, b, n, d)
    got = CatalogLSE.apply(torch.from_numpy(q), torch.from_numpy(x), 0.2).numpy()
    assert got.shape == (b,) and got.dtype == np.float32
    want = np.asarray(catalog_logsumexp(jnp.asarray(q), jnp.asarray(x), 0.2, block_n, True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(catalog_logsumexp_reference(jnp.asarray(q), jnp.asarray(x), 0.2)),
        rtol=0, atol=1e-4)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


SPLIT_CASES = {
    # (q, x, tau, tiles per split, JAX block_n)
    "ragged-N": lambda rng: (rng.normal(size=(37, 24)), rng.normal(size=(700, 24)), 0.2, 2, 256),
    "one-column-split": lambda rng: (rng.normal(size=(16, 32)), rng.normal(size=(129, 32)), 0.2,
                                     1, 128),
    "B=1": lambda rng: (rng.normal(size=(1, 16)), rng.normal(size=(300, 16)), 0.2, 1, 128),
    "tau0.05-unit-rows": lambda rng: (_unit(rng, 64, 64), _unit(rng, 500, 64), 0.05, 3, 256),
    "scores-past-88": lambda rng: (15 * _unit(rng, 40, 16), _unit(rng, 300, 16), 0.1, 2, 128),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_form_matches_pallas_interpret(case):
    """K5's split arithmetic (per-split (max, sum) pairs merged in split
    order) against the JAX kernel in interpret mode, at the value bound of
    the JAX kernel's tests: a ragged catalog, a last split of one column,
    one query row, tau 0.05 on unit rows, and scores above 88, where a
    plain exp of a score overflows f32."""
    q, x, tau, w, block_n = SPLIT_CASES[case](np.random.default_rng(len(case)))
    q, x = q.astype(np.float32), x.astype(np.float32)
    if case == "one-column-split":
        assert x.shape[0] % (w * TILE) == 1
    if case == "scores-past-88":
        with np.errstate(over="ignore"):
            assert (q @ x.T / tau).max() > 88 and not np.isfinite(np.exp(q @ x.T / tau)).all()
    got = catalog_lse_split_plain(torch.from_numpy(q), torch.from_numpy(x), tau, w).numpy()
    want = np.asarray(catalog_logsumexp(jnp.asarray(q), jnp.asarray(x), tau, block_n, True))
    assert got.shape == (q.shape[0],) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, catalog_lse_plain(torch.from_numpy(q), torch.from_numpy(x),
                                                      tau).numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,n,slots,want", [
    (2048, 943, 264, (2, 8)), (2048, 1675, 264, (4, 7)), (2048, 100_000, 264, (196, 8)),
    (37, 700, 264, (1, 11)), (20_000, 5000, 264, (79, 1)), (64, 64, 132, (1, 1)),
])
def test_forward_plan_fills_one_wave_with_no_empty_split(b, n, slots, want):
    """K5's splits: the fewest 64-row item tiles per split that keep the grid
    within the card's resident blocks (264 = 132 SMs x 2 on an H100), so NCL's
    step shapes get 32 x 8 and 32 x 7 blocks, and a 100,000-item catalog keeps
    its (max, sum) partials at 8 x B x 2 floats. Every split holds a tile."""
    w, splits = lse_fwd_plan(b, n, slots)
    assert (w, splits) == want
    nq, nx = -(-b // TILE), -(-n // TILE)
    assert (splits - 1) * w < nx <= splits * w
    assert nq * splits <= slots or splits == 1
    if n == 100_000:
        assert splits * b * 2 * 4 == 131_072  # bytes of (max, sum) partials


def _grads_ours(q, x, tau):
    qt = torch.tensor(q, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(CatalogLSE.apply(qt, xt, tau) ** 2).backward()
    return qt.grad.numpy(), xt.grad.numpy()


def _grads_jax(q, x, tau, block_n):
    def pallas(q, x):
        return jnp.sum(catalog_logsumexp(q, x, tau, block_n, True) ** 2)

    def ref(q, x):
        return jnp.sum(catalog_logsumexp_reference(q, x, tau) ** 2)

    args = (jnp.asarray(q), jnp.asarray(x))
    return [tuple(np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(*args)) for f in (pallas, ref)]


@pytest.mark.parametrize("tau,tol", [(0.5, dict(rtol=0, atol=1e-3)),
                                     (0.2, dict(rtol=1e-3, atol=2e-2))], ids=["tau0.5", "tau0.2"])
@pytest.mark.parametrize("b,n,d,block_n", [(8, 300, 16, 128), (37, 700, 24, 256)])
def test_grads_match_pallas_interpret_and_reference(tau, tol, b, n, d, block_n):
    q, x = _inputs(2 * b + n, b, n, d)
    got = _grads_ours(q, x, tau)
    for want in _grads_jax(q, x, tau, block_n):
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, **tol)


def test_backward_plain_is_autograd_of_the_plain_forward():
    q, x = (torch.from_numpy(a) for a in _inputs(3, 9, 50, 12))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=9).astype(np.float32))
    qa, xa = q.clone().requires_grad_(), x.clone().requires_grad_()
    lse = catalog_lse_plain(qa, xa, 0.3)
    want = torch.autograd.grad(lse, (qa, xa), g)
    got = catalog_lse_bwd_plain(q, x, 0.3, lse.detach(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_catalog_lse_on_cpu_is_the_plain_version():
    q, x = (torch.from_numpy(a) for a in _inputs(5, 13, 70, 8))
    g = torch.ones(13)
    before = catalog_lse.launches, catalog_lse_bwd.launches
    lse = catalog_lse(q, x, 0.1)
    assert torch.equal(lse, catalog_lse_plain(q, x, 0.1))
    got = catalog_lse_bwd(q, x, 0.1, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, catalog_lse_bwd_plain(q, x, 0.1, lse, g)))
    qa = q.clone().requires_grad_()
    out = CatalogLSE.apply(qa, x, 0.1)
    assert out.grad_fn is not None
    out.sum().backward()
    assert qa.grad is not None and torch.isfinite(qa.grad).all()
    assert (catalog_lse.launches, catalog_lse_bwd.launches) == before  # no kernel on the CPU


def test_catalog_lse_checks_its_inputs():
    q, x = torch.zeros(4, 3), torch.zeros(5, 3)
    with pytest.raises(ValueError):
        catalog_lse(q, torch.zeros(5, 2), 0.1)
    with pytest.raises(ValueError):
        catalog_lse(q[0], x, 0.1)
    with pytest.raises(ValueError):
        catalog_lse(torch.zeros(0, 3), x, 0.1)
    with pytest.raises(TypeError):
        catalog_lse(q.double(), x, 0.1)
    with pytest.raises(ValueError):
        catalog_lse_bwd(q, x, 0.1, torch.zeros(3), torch.zeros(4))
    with pytest.raises(TypeError):
        catalog_lse_bwd(q, x, 0.1, torch.zeros(4), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        catalog_lse(q.to("meta"), x.to("meta"), 0.1)


@pytest.mark.parametrize("b,n,d", [(2048, 943, 64), (2048, 1675, 64), (1, 1, 1), (70, 65, 130)])
def test_backward_workspace_holds_a_chunk_per_tile_pair(b, n, d):
    """K6 writes one [64, d] partial of dq and one of dx for each pair of a
    64-row query tile and a 64-row item tile: 7.9 and 14.2 MB at NCL's step
    shapes. A call of either kernel is two launches: K6's tiles and combine,
    K5's splits and their merge."""
    from recommendation_tpu_torch.ops.lse import TILE, lse_bwd_workspace

    tiles = -(-b // TILE) * -(-n // TILE)
    assert lse_bwd_workspace(b, n, d) == tiles * TILE * d
    assert (catalog_lse.launches_per_call, catalog_lse_bwd.launches_per_call) == (2, 2)
