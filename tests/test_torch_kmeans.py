"""k-means (``ops/kmeans.py``) against the JAX package's: ``kmeans`` and
``kmeans_minibatch`` given the indices the JAX functions draw inside
(``jax.random.choice(rng, n, (k,), replace=False)`` for the initial rows,
``jax.random.randint`` per iteration for the mini-batch rows), and the
invariants of Lloyd's algorithm. The sorted segment sums equal
``index_add_``'s bit for bit on the CPU.

Tolerances: on well-separated blobs the assignments are equal and the
centroids within atol 1e-5 (f32 sums in another order). On propagated
embeddings of a real graph two centroids can lie almost as near to a row;
there the assignments agree except on rows whose two nearest centroids are
within 1e-5 of a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendation_tpu.models.lightgcn import lightgcn_propagate as jax_propagate
from recommendation_tpu.ops.kmeans import kmeans as jax_kmeans
from recommendation_tpu.ops.kmeans import kmeans_minibatch as jax_kmeans_minibatch
from recommendation_tpu.ops.kmeans import ncl_cluster_cap as jax_cap
from recommendation_tpu_torch.ops.kmeans import (
    _segment_sums,
    cluster_counts,
    kmeans,
    kmeans_batches,
    kmeans_init,
    kmeans_minibatch,
    ncl_cluster_cap,
)

CENTROID_TOL = dict(rtol=0, atol=1e-5)
TIE = 1e-5


def _blobs(seed=0, per=60, d=8, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 10
    x = np.concatenate([c + rng.normal(size=(per, d)).astype(np.float32) for c in centers])
    return x[rng.permutation(len(x))]


def _init_idx(rng, n, k):
    return np.array(jax.random.choice(rng, n, shape=(k,), replace=False))


def _minibatch_idx(rng, n, k, n_iters, bsz):
    k_init, k_iter = jax.random.split(rng)
    batches = [np.array(jax.random.randint(key, (bsz,), 0, n))
               for key in jax.random.split(k_iter, n_iters)]
    return _init_idx(k_init, n, k), np.stack(batches)


def _near_tie(x, centroids):
    d2 = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return two[:, 1] - two[:, 0] <= TIE * np.maximum(1.0, np.abs(two[:, 0]))


def _inertia(x, centroids, assign):
    return float(((x - centroids[assign]) ** 2).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_on_blobs_matches_jax(seed):
    x = _blobs(seed)
    rng = jax.random.PRNGKey(seed)
    want_c, want_a = jax_kmeans(rng, jnp.asarray(x), 4, 10)
    got_c, got_a = kmeans(torch.from_numpy(x), torch.from_numpy(_init_idx(rng, len(x), 4)), 10)
    assert got_a.dtype == torch.int32 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **CENTROID_TOL)


@pytest.fixture(scope="module")
def propagated(tiny_graph):
    """LightGCN mean embeddings of the tiny graph, as NCL's E-step sees them."""
    rng = np.random.default_rng(3)
    r = tiny_graph.interaction_norm_dense
    u0 = rng.normal(size=(r.shape[0], 16)).astype(np.float32) * 0.1
    i0 = rng.normal(size=(r.shape[1], 16)).astype(np.float32) * 0.1

    class _Adj:
        compute_dtype = "float32"

    u, i = jax_propagate(jnp.asarray(u0), jnp.asarray(i0), _Adj(), 3, bipartite_dense=r)
    return np.array(u), np.array(i)


@pytest.mark.parametrize("side", [0, 1], ids=["users", "items"])
@pytest.mark.parametrize("k", [2, 5])
def test_kmeans_on_propagated_embeddings_matches_jax(propagated, side, k):
    x = propagated[side]
    rng = jax.random.PRNGKey(10 + k)
    want_c, want_a = jax_kmeans(rng, jnp.asarray(x), k, 10)
    got_c, got_a = kmeans(torch.from_numpy(x), torch.from_numpy(_init_idx(rng, len(x), k)), 10)
    differ = got_a.numpy() != np.asarray(want_a)
    assert not differ[~_near_tie(x, np.asarray(want_c))].any()
    if not differ.any():
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **CENTROID_TOL)


@pytest.mark.parametrize("assign_chunk", [64, 131_072])
def test_kmeans_minibatch_matches_jax(assign_chunk):
    x = _blobs(4, per=50)
    rng = jax.random.PRNGKey(4)
    want_c, want_a = jax_kmeans_minibatch(rng, jnp.asarray(x), 4, 6, batch=32,
                                          assign_chunk=assign_chunk)
    init, batches = _minibatch_idx(rng, len(x), 4, 6, 32)
    got_c, got_a = kmeans_minibatch(torch.from_numpy(x), torch.from_numpy(init),
                                    torch.from_numpy(batches), 6, assign_chunk)
    assert got_a.dtype == torch.int32 and got_a.shape == (len(x),)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **CENTROID_TOL)


def test_empty_cluster_keeps_its_centroid():
    """Two equal rows chosen as initial centroids: argmin takes the first,
    so in the first iteration the second gets no row and must stay where it
    started. (The mini-batch variant then assigns every row against the
    moved centroids, so only its centroid is checked.)"""
    x = _blobs(5)
    x[7] = x[3]
    init = torch.tensor([3, 7, 11, 20])
    cent, assign = kmeans(torch.from_numpy(x), init, 1)
    assert not (assign == 1).any() and (assign == 0).any()
    assert torch.equal(cent[1], torch.from_numpy(x[7]))
    assert not torch.equal(cent[0], torch.from_numpy(x[3]))
    cent, _ = kmeans_minibatch(torch.from_numpy(x), init, torch.arange(len(x))[None], 1)
    assert torch.equal(cent[1], torch.from_numpy(x[7]))


@pytest.mark.parametrize("n_iters", [1, 3, 10])
def test_inertia_does_not_rise(propagated, n_iters):
    """Lloyd never raises the inertia: the returned (centroids, assignment)
    is no worse than assigning every row to its nearest initial centroid."""
    x = propagated[1]
    init = kmeans_init(torch.Generator().manual_seed(n_iters), len(x), 6)
    cent, assign = kmeans(torch.from_numpy(x), init, n_iters)
    c0 = x[init.numpy()]
    d0 = ((x[:, None, :] - c0[None]) ** 2).sum(-1).min(1).sum()
    assert ((assign >= 0) & (assign < 6)).all()
    assert _inertia(x, cent.numpy(), assign.numpy()) <= d0 * (1 + 1e-6)


def test_draws():
    g = torch.Generator().manual_seed(0)
    init = kmeans_init(g, 50, 7)
    assert init.shape == (7,) and len(set(init.tolist())) == 7 and init.max() < 50
    batches = kmeans_batches(g, 50, 4, 9)
    assert batches.shape == (4, 9) and 0 <= batches.min() and batches.max() < 50
    assert torch.equal(kmeans_init(torch.Generator().manual_seed(0), 50, 7), init)
    with pytest.raises(ValueError):
        kmeans_init(g, 5, 6)
    with pytest.raises(ValueError):
        kmeans(torch.zeros(5, 2), init[:2] % 5, 0)
    with pytest.raises(ValueError):
        kmeans_minibatch(torch.zeros(5, 2), init[:2] % 5, batches % 5, 3)
    for n in (1, 38, 39, 943, 1675, 10**6):
        assert ncl_cluster_cap(n) == jax_cap(n)


@pytest.mark.parametrize("n,k,d", [(5000, 100, 64), (300, 10, 16), (1, 3, 4)])
def test_segment_sums_are_index_add_bit_for_bit(n, k, d):
    """The sorted segment sums equal ``index_add_``'s (sequential in index
    order on the CPU) bit for bit, clusters left empty included."""
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 3).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, max(1, k - 3), n))
    sums, counts = _segment_sums(x, assign, k)
    want = torch.zeros(k, d).index_add_(0, assign, x)
    want_counts = torch.zeros(k).index_add_(0, assign, torch.ones(n))
    assert sums.dtype == torch.float32 and torch.equal(sums, want)
    assert counts.dtype == torch.float32 and torch.equal(counts, want_counts)


@pytest.mark.parametrize("case", ["random", "empty_ends", "one_cluster", "one_row"])
def test_cluster_counts_are_bincount(case):
    """The counts read off the sorted assignments (``cluster_counts``, what
    a CUDA graph can capture) equal ``torch.bincount``'s integers and the
    JAX package's ``segment_sum`` of ones, empty clusters at either end and
    in the middle included."""
    rng = np.random.default_rng(7)
    n, k = {"random": (5000, 100), "empty_ends": (400, 12), "one_cluster": (50, 6),
            "one_row": (1, 3)}[case]
    if case == "empty_ends":
        assign = rng.choice(np.array([2, 3, 5, 8, 9]), n)
    elif case == "one_cluster":
        assign = np.full(n, 4)
    else:
        assign = rng.integers(0, k, n)
    assign = torch.from_numpy(assign.astype(np.int64))
    got = cluster_counts(torch.sort(assign, stable=True).values, k)
    assert got.dtype == torch.int64 and torch.equal(got, torch.bincount(assign, minlength=k))
    want = jax.ops.segment_sum(jnp.ones(n, jnp.int32), jnp.asarray(assign.numpy()), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
