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

from recommendation_tpu.ops.pallas_losses import (
    _lse_backward,
    catalog_logsumexp,
    catalog_logsumexp_reference,
)
from recommendation_tpu_torch.ops.lse import (
    TILE,
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


def _inputs(seed, b, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("b,n,d,block_n", [(16, 700, 32, 256), (37, 700, 24, 256),
                                           (5, 300, 16, 128), (6, 200, 1024, 128)])
def test_values_match_pallas_interpret_and_reference(b, n, d, block_n):
    """A partial item block (N not a multiple of block_n), ragged B, and
    d = 1024 (NCL's widest tuning width: no width limit on either side).
    Past d = 32 the rows are scaled by (32 / d) ** 0.25 each, so the scores
    keep the narrower cases' order and the absolute atol its meaning (at
    unit scale d = 1024 puts lse near 400, where 1e-4 is 4 ulps)."""
    q, x = (a * min(1.0, (32 / d) ** 0.25) for a in _inputs(b + n, b, n, d))
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


# K6's workspace bytes on a card of 264 resident blocks, worked by hand from
# the plans of test_backward_plan_fills_one_wave_with_no_empty_split: at
# (2048, 943) 4 dq partials of 2048 x 64 floats and 8 dx partials of 943 x 64;
# at (8192, 100000) 2 of 8192 x 64 and 1 of 100000 x 64. The card test
# test_lse_backward_sides_match_their_split_arithmetic holds what a call
# allocates on the card to the same count.
BWD_WORKSPACE_BYTES = {(2048, 943): 4_028_416, (2048, 1675): 4_241_152, (1, 1): 8,
                       (70, 65): 140_400, (8192, 100_000): 29_794_304}


@pytest.mark.parametrize("b,n,d", [(2048, 943, 64), (2048, 1675, 64), (1, 1, 1), (70, 65, 130),
                                   (8192, 100_000, 64)])
def test_backward_workspace_holds_a_chunk_per_tile_pair(b, n, d):
    """K6's partials: at most one [64, d] chunk per (query tile, item tile)
    pair, the form they had before, and in fact far less: one [B, d] per
    query-side split and one [N, d] per item-side split. At NCL's step
    shapes that is 4.0 and 4.2 MB (the per-pair form took 7.9 and 14.2 MB a
    buffer), and at B = 8192 against 100,000 items 29.8 MB (6.55 GB per
    pair): under S x (B + N) x d floats with S the larger split count,
    whatever B x N. A call of either kernel is two launches: K6's two sides
    and their combine, K5's splits and their merge."""
    slots = 264  # an H100's 132 SMs x 2 resident K6 blocks at d <= 64
    _, sq, _, sx = lse_bwd_plan(b, n, slots)
    floats = lse_bwd_workspace(b, n, d, slots)
    assert floats * 4 == BWD_WORKSPACE_BYTES[b, n]
    assert floats <= max(sq, sx) * (b + n) * d
    nq, nx = -(-b // TILE), -(-n // TILE)
    per_pair = 2 * nq * nx * TILE * d
    assert floats <= per_pair
    if n == 100_000:
        assert floats * 4 <= 256 * 2**20 and per_pair * 4 > 6.5e9
    assert (catalog_lse.launches_per_call, catalog_lse_bwd.launches_per_call) == (2, 2)


@pytest.mark.parametrize("b,n,slots,want", [
    (2048, 943, 264, (4, 4, 4, 8)), (2048, 1675, 264, (7, 4, 7, 5)),
    (8192, 100_000, 264, (782, 2, 128, 1)), (8192, 50_000, 264, (391, 2, 128, 1)),
    (37, 700, 264, (1, 11, 1, 1)), (1, 1, 264, (1, 1, 1, 1)), (64, 6400, 132, (2, 50, 1, 1)),
])
def test_backward_plan_fills_one_wave_with_no_empty_split(b, n, slots, want):
    """K6's plan: both sides' blocks together make about one wave of the
    card's resident blocks, each walking about 2·nq·nx / slots tile pairs;
    a side whose own tiles pass a wave takes one split; the splits are
    balanced and none is empty."""
    wq, sq, wx, sx = plan = lse_bwd_plan(b, n, slots)
    assert plan == want
    nq, nx = -(-b // TILE), -(-n // TILE)
    assert (sq - 1) * wq < nx <= sq * wq and (sx - 1) * wx < nq <= sx * wx
    assert nq * sq + nx * sx <= slots or sq == 1 or sx == 1
    assert max(wq, wx) <= max(1, -(-2 * nq * nx // slots))


BWD_SPLIT_CASES = {
    # (b, n, d, tau, plan's slots, JAX block_n): B < 64, N not a multiple of 64
    "ragged": (37, 700, 24, 0.2, 12, 256),
    "B=1": (1, 300, 16, 0.2, 4, 128),
    "one-item-tile": (20, 50, 8, 0.5, 2, 128),
    "many-splits": (50, 1000, 32, 0.3, 64, 512),
    "unit-rows-tau0.1": (60, 333, 64, 0.1, 8, 128),
}


@pytest.mark.parametrize("case", list(BWD_SPLIT_CASES))
def test_backward_split_form_matches_pallas_interpret(case):
    """K6's split arithmetic (each side's split adds its walked tiles' products
    in order, the splits are added in split order) against the JAX kernel's
    backward in interpret mode and against the plain backward, at the
    gradient bound of the JAX kernel's tests (τ = 0.5's atol 1e-3 scaled to
    the gradients' size). Each case's plan cuts both sides into several
    splits."""
    b, n, d, tau, slots, block_n = BWD_SPLIT_CASES[case]
    rng = np.random.default_rng(b + n + d)
    q, x = ((_unit(rng, b, d), _unit(rng, n, d)) if case == "unit-rows-tau0.1"
            else _inputs(b + n, b, n, d))
    g = rng.normal(size=b).astype(np.float32)
    lse = np.array(catalog_logsumexp_reference(jnp.asarray(q), jnp.asarray(x), tau))
    plan = lse_bwd_plan(b, n, slots)
    assert plan[1] > 1 or n <= 64
    got = catalog_lse_bwd_split_plain(*(torch.from_numpy(a) for a in (q, x)), tau,
                                      torch.from_numpy(lse), torch.from_numpy(g), plan)
    want = _lse_backward(jnp.asarray(q), jnp.asarray(x), tau, block_n, True, jnp.asarray(lse),
                         jnp.asarray(g))
    plain = catalog_lse_bwd_plain(*(torch.from_numpy(a) for a in (q, x)), tau,
                                  torch.from_numpy(lse), torch.from_numpy(g))
    for a, w, p in zip(got, want, plain):
        a, w = a.numpy(), np.asarray(w)
        assert a.shape == w.shape and np.isfinite(a).all()
        scale = np.abs(w).max()
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(a, p.numpy(), rtol=1e-5, atol=1e-6 * scale)
