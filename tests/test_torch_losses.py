"""The port's losses (``recommendation_tpu_torch/losses.py``) against the
JAX package's: value and gradient of each on the same numpy inputs,
``jax.value_and_grad`` against autograd, rtol 1e-5 / atol 1e-6 (f32; the
two frameworks reduce in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.losses as jl
from recommendation_tpu_torch import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, n_args, shape=(64, 16), zero_row=False):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32) * 0.5 for _ in range(n_args)]
    if zero_row:
        xs[0][3] = 0.0  # the zero-safe gradients must hold here
    return xs


def _check(fn_jax, fn_torch, xs):
    want, want_g = jax.value_and_grad(fn_jax, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    got = fn_torch(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for t, g in zip(ts, want_g):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["bpr_loss", "bce_loss"])
def test_pairwise_losses(name, seed):
    _check(getattr(jl, name), getattr(tl, name), _inputs(seed, 3))


@pytest.mark.parametrize("weighted", [False, True])
def test_pointwise_bce_loss(weighted):
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(200,)).astype(np.float32) * 3
    labels = (rng.random(200) < 0.3).astype(np.float32)
    weight = (rng.random(200) < 0.9).astype(np.float32)
    if weighted:
        _check(lambda s: jl.pointwise_bce_loss(s, jnp.asarray(labels), jnp.asarray(weight)),
               lambda s: tl.pointwise_bce_loss(s, torch.from_numpy(labels),
                                               torch.from_numpy(weight)), [scores])
    else:
        _check(lambda s: jl.pointwise_bce_loss(s, jnp.asarray(labels)),
               lambda s: tl.pointwise_bce_loss(s, torch.from_numpy(labels)), [scores])


@pytest.mark.parametrize("zero", [False, True])
def test_safe_frobenius_norm(zero):
    x = _inputs(3, 1)[0] * (0.0 if zero else 1.0)
    _check(jl.safe_frobenius_norm, tl.safe_frobenius_norm, [x])


@pytest.mark.parametrize("n_args", [1, 3])
def test_l2_reg_loss(n_args):
    xs = _inputs(4, n_args, zero_row=True)
    _check(lambda *a: jl.l2_reg_loss(1e-2, *a), lambda *a: tl.l2_reg_loss(1e-2, *a), xs)


def test_l2_normalize():
    xs = _inputs(5, 1, zero_row=True)
    _check(lambda x: jnp.sum(jl._l2_normalize(x) * jnp.arange(16.0)),
           lambda x: torch.sum(tl._l2_normalize(x) * torch.arange(16.0)), xs)


@pytest.mark.parametrize("b_cos", [True, False])
@pytest.mark.parametrize("zero_row", [False, True])
def test_info_nce(b_cos, zero_row):
    """NCL's ProtoNCE term: a [B, B] score matrix against the assigned
    centroids; a zero row is an empty centroid of the initial state."""
    xs = _inputs(6, 2, shape=(48, 16), zero_row=zero_row)
    _check(lambda a, b: jl.info_nce(b, a, 0.1, b_cos), lambda a, b: tl.info_nce(b, a, 0.1, b_cos),
           xs)
