"""The segment backend (``ops/segment.py``, the segment branch of
``ops/spmm.py`` and ``graph/device.py``) on the CPU against the JAX
package's: the segment ``from_scipy`` tables and ``rows_sorted`` bit for
bit, ``with_vals``, ``binarized``, ``transpose``, ``normalized_bipartite``
(its COO bit for bit, its values at the f32 bound), ``adj_matmul`` on ``segment`` and on ``pallas`` with its
gradient, ``segment_softmax`` and ``segment_mean`` (the JAX package's
oracles of tests/test_ops.py:40-57, and random inputs with empty segments,
with gradients); the plain versions of S1, S2 and S3 against loops, S2's
autograd Function against autograd through its plain version; LightGCN's
and NCL's loss and gradients on the segment backend against the JAX
package's on its segment graph; and training through the CLI with
``graph.backend=segment`` and ``=pallas``.

Tolerances: tables bit for bit; f32 math rtol 1e-5 / atol 1e-6, the atol
relative to the reference's largest entry on gradients and on products
(as in tests/test_torch_ncl_bucketed.py): the frameworks sum in other
orders, and a product of the binarized adjacency sums ~40 terms of O(1).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import binarized as jax_binarized
from recommendation_tpu.graph.device import densify as jax_densify
from recommendation_tpu.graph.device import from_scipy as jax_from_scipy
from recommendation_tpu.graph.device import with_vals as jax_with_vals
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu.models.ncl import NCL as JaxNCL
from recommendation_tpu.ops.spmm import adj_matmul as jax_adj_matmul
from recommendation_tpu.ops.spmm import segment_mean as jax_segment_mean
from recommendation_tpu.ops.spmm import segment_softmax as jax_segment_softmax
from recommendation_tpu_torch import cli
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph.device import (
    DeviceGraph,
    binarized,
    densify,
    from_scipy,
    with_vals,
)
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops import segment as seg_ops
from recommendation_tpu_torch.ops.gather import check_schedule
from recommendation_tpu_torch.ops.spmm import adj_matmul, segment_mean, segment_softmax
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.weights import params_from_jax, state_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(jax.device_get(x))


def _grad_close(got, want):
    w = _np(want)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def _rect(seed=0, n_rows=45, n_cols=70, e=400):
    """A rectangular COO with duplicates summed, negative values, empty
    rows, and a count of entries that is not a multiple of the pad."""
    rng = np.random.default_rng(seed)
    mat = sp.coo_matrix((rng.normal(size=e).astype(np.float32),
                         (rng.integers(0, n_rows - 3, e), rng.integers(0, n_cols, e))),
                        shape=(n_rows, n_cols))
    mat.sum_duplicates()
    return sp.csr_matrix(mat)


def _mats(tiny_data):
    return {"norm_adj": tiny_data.norm_adj, "rect": _rect(),
            "unsorted": sp.coo_matrix(_rect(1).T.tocoo())}


@pytest.mark.parametrize("which", ["norm_adj", "rect", "unsorted"])
@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_from_scipy_tables_match_jax(tiny_data, which, backend):
    mat = _mats(tiny_data)[which]
    ours, ref = from_scipy(mat, backend=backend, device="cpu"), jax_from_scipy(mat, backend=backend)
    assert ours.backend == ref.backend == backend and ours.shape == ref.shape
    assert ours.rows_sorted is ref.rows_sorted is True
    for name in ("rows", "cols", "vals"):
        got, want = getattr(ours, name).numpy(), _np(getattr(ref, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert ours.dense is None and ours.pull is None
    # the views: built at upload, a stable sort by rows (identity: the COO is
    # row-sorted) and by columns
    seg, seg_t = ours.seg, ours.seg_t
    assert seg is not None and torch.equal(seg.perm, torch.arange(ours.vals.shape[0]))
    order = np.argsort(ours.cols.numpy(), kind="stable")
    assert np.array_equal(seg_t.perm.numpy(), order)
    assert np.array_equal(seg_t.idx.numpy(), ours.rows.numpy()[order])
    assert np.array_equal(np.diff(seg.row_ptr.numpy()),
                          np.bincount(ours.rows.numpy(), minlength=ours.n_rows))
    assert np.array_equal(densify(ours).numpy(), _np(jax_densify(ref)))


@pytest.mark.parametrize("which", ["norm_adj", "rect", "unsorted"])
@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_adj_matmul_and_grad_match_jax(tiny_data, which, backend):
    mat = _mats(tiny_data)[which]
    ours, ref = from_scipy(mat, backend=backend, device="cpu"), jax_from_scipy(mat, backend=backend)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(mat.shape[1], 12)).astype(np.float32)
    c = rng.normal(size=(mat.shape[0], 12)).astype(np.float32)
    want_y = jax_adj_matmul(ref, jnp.asarray(x))
    want_g = jax.grad(lambda a: jnp.sum(jax_adj_matmul(ref, a) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = adj_matmul(ours, xt)
    (g,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(c)), xt)
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), **TIGHT)
    _grad_close(g, want_g)


def test_edge_values_take_no_gradient(tiny_data):
    adj = from_scipy(tiny_data.norm_adj, backend="segment", device="cpu")
    vals = adj.vals.clone().requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        adj_matmul(with_vals(adj, vals), torch.ones(adj.n_cols, 4))


@pytest.mark.parametrize("which", ["norm_adj", "rect"])
def test_with_vals_binarized_transpose_match_jax(tiny_data, which):
    mat = _mats(tiny_data)[which]
    ours, ref = from_scipy(mat, backend="segment", device="cpu"), jax_from_scipy(
        mat, backend="segment")
    rng = np.random.default_rng(3)
    vals = rng.normal(size=ours.vals.shape[0]).astype(np.float32)
    for got, want in ((with_vals(ours, torch.from_numpy(vals)),
                       jax_with_vals(ref, jnp.asarray(vals))),
                      (binarized(ours), jax_binarized(ref)),
                      (ours.transpose(), ref.transpose()),
                      (binarized(ours).transpose(), jax_binarized(ref).transpose())):
        for name in ("rows", "cols", "vals"):
            assert np.array_equal(getattr(got, name).numpy(), _np(getattr(want, name))), name
        assert got.rows_sorted == want.rows_sorted
        x = rng.normal(size=(got.n_cols, 5)).astype(np.float32)
        _grad_close(adj_matmul(got, torch.from_numpy(x)), jax_adj_matmul(want, jnp.asarray(x)))
    assert with_vals(ours, torch.from_numpy(vals)).seg is ours.seg  # the views are kept


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(tiny_graph_segment, data):
    return tiny_graph_segment, DeviceGraph(data, backend="segment", device="cpu")


@pytest.mark.parametrize("keep", [None, 0.3])
def test_normalized_bipartite_matches_jax(graphs, keep):
    jgraph, graph = graphs
    mask = None
    if keep is not None:
        mask = (np.random.default_rng(4).random(graph.edge_valid.shape[0]) >= keep).astype(
            np.float32)
    got = graph.normalized_bipartite(None if mask is None else torch.from_numpy(mask))
    want = jgraph.normalized_bipartite(None if mask is None else jnp.asarray(mask))
    assert got.backend == want.backend == "segment" and got.rows_sorted is want.rows_sorted
    for name in ("rows", "cols"):
        assert np.array_equal(getattr(got, name).numpy(), _np(getattr(want, name))), name
    # the degrees are exact; XLA's rsqrt and torch's differ by an ulp at some
    # degrees (neither rounds correctly), so the values hold at the f32 bound
    # and their zeros bit for bit
    np.testing.assert_allclose(got.vals.numpy(), _np(want.vals), **TIGHT)
    assert np.array_equal(got.vals.numpy() == 0, _np(want.vals) == 0)
    by_rows, by_cols = graph.bipartite_views()
    assert got.seg is by_rows and got.seg_t is by_cols  # no sort per call
    x = np.random.default_rng(5).normal(size=(graph.n_nodes, 6)).astype(np.float32)
    np.testing.assert_allclose(adj_matmul(got, torch.from_numpy(x)).numpy(),
                               _np(jax_adj_matmul(want, jnp.asarray(x))), **TIGHT)


def test_segment_graph_matches_jax(graphs):
    jgraph, graph = graphs
    assert graph.backend == jgraph.backend == "segment"
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(graph.norm_adj, name).numpy(),
                              _np(getattr(jgraph.norm_adj, name))), name
    assert graph.norm_adj.rows_sorted and graph.interaction_norm_dense is None
    with pytest.raises(NotImplementedError, match="R̂"):
        graph.propagation_matrix  # noqa: B018
    loops, jloops = graph.norm_adj_selfloops, jgraph.norm_adj_selfloops
    assert loops.backend == jloops.backend == "segment"
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(loops, name).numpy(), _np(getattr(jloops, name))), name
    assert graph.ensure_gat_aux() is None and jgraph.ensure_gat_aux() is None


# -- segment_softmax, segment_mean ------------------------------------------------


def test_segment_softmax_oracle():
    scores = torch.tensor([1.0, 2.0, 3.0, -1.0, 0.5])
    out = segment_softmax(scores, torch.tensor([0, 0, 1, 1, 1]), 2).numpy()
    e = np.exp([1.0, 2.0])
    assert np.allclose(out[:2], e / e.sum(), atol=1e-6)
    e2 = np.exp([3.0, -1.0, 0.5])
    assert np.allclose(out[2:], e2 / e2.sum(), atol=1e-6)


def test_segment_mean_oracle():
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = segment_mean(vals, torch.tensor([0, 0, 1, 2]), 3).numpy()
    assert np.allclose(out[0], [1.0, 2.0])
    assert np.allclose(out[1], [4.0, 5.0])
    assert np.allclose(out[2], [6.0, 7.0])


@pytest.mark.parametrize("heads", [None, 1, 4])
def test_segment_softmax_matches_jax(heads):
    """Unsorted segments with empty ones, values and gradients."""
    rng = np.random.default_rng(heads or 0)
    e, n = 300, 40
    segs = rng.integers(0, n - 5, e).astype(np.int32)
    shape = (e,) if heads is None else (e, heads)
    scores = (rng.normal(size=shape) * 3).astype(np.float32)
    c = rng.normal(size=shape).astype(np.float32)
    want = jax_segment_softmax(jnp.asarray(scores), jnp.asarray(segs), n)
    want_g = jax.grad(lambda s: jnp.sum(jax_segment_softmax(s, jnp.asarray(segs), n) * c))(
        jnp.asarray(scores))
    st = torch.from_numpy(scores).requires_grad_()
    got = segment_softmax(st, torch.from_numpy(segs), n)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)), st)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TIGHT)
    _grad_close(g, want_g)


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(7)
    e, n, d = 250, 30, 6
    segs = rng.integers(0, n - 4, e).astype(np.int32)
    values = rng.normal(size=(e, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    want = jax_segment_mean(jnp.asarray(values), jnp.asarray(segs), n)
    want_g = jax.grad(lambda v: jnp.sum(jax_segment_mean(v, jnp.asarray(segs), n) * c))(
        jnp.asarray(values))
    vt = torch.from_numpy(values).requires_grad_()
    got = segment_mean(vt, torch.from_numpy(segs), n)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)), vt)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TIGHT)
    _grad_close(g, want_g)
    assert np.all(got.detach().numpy()[n - 4:] == 0)  # empty segments


# -- the kernels' plain versions ---------------------------------------------------


def _csr(seed, n_rows=25, n_src=30, e=200, empty=(3, 7)):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, e)
    rows = rows[~np.isin(rows, empty)]
    cols = rng.integers(0, n_src, len(rows))
    view = seg_ops.segment_csr(torch.from_numpy(rows), torch.from_numpy(cols), n_rows, n_src)
    return rng, view


@pytest.mark.parametrize("heads", [1, 4])
def test_weighted_pull_plain_matches_a_loop(heads):
    rng, view = _csr(heads)
    d = 3
    x = rng.normal(size=(view.n_cols, heads, d)).astype(np.float32)
    w = rng.normal(size=(view.n_slots, heads)).astype(np.float32)
    got = seg_ops.weighted_pull(torch.from_numpy(x), torch.from_numpy(w), view.idx,
                                view.row_ptr, view.schedule).numpy()
    want = np.zeros((view.n_rows, heads, d), np.float32)
    ptr, idx = view.row_ptr.numpy(), view.idx.numpy()
    for r in range(view.n_rows):
        for s in range(ptr[r], ptr[r + 1]):
            want[r] += w[s][:, None] * x[idx[s]]
    np.testing.assert_allclose(got, want, **TIGHT)
    assert np.all(got[[3, 7]] == 0)


@pytest.mark.parametrize("heads", [1, 4])
def test_softmax_rows_plain_matches_a_loop(heads):
    rng, view = _csr(10 + heads)
    e = (rng.normal(size=(view.n_slots, heads)) * 4).astype(np.float32)
    live = rng.random(view.n_slots) > 0.3
    ptr = view.row_ptr.numpy()
    live[ptr[0]:ptr[1]] = False  # a row with no live slot
    att = seg_ops.segment_softmax_rows(torch.from_numpy(e), view.row_ptr,
                                       torch.from_numpy(live)).numpy()
    g = rng.normal(size=e.shape).astype(np.float32)
    de = seg_ops.segment_softmax_rows_bwd(torch.from_numpy(att), torch.from_numpy(g),
                                          view.row_ptr).numpy()
    for r in range(view.n_rows):
        sl = slice(ptr[r], ptr[r + 1])
        ex = np.where(live[sl, None], np.exp(e[sl] - np.max(np.where(live[sl, None], e[sl],
                                                                      -np.inf), axis=0,
                                                             initial=-np.inf)), 0)
        ex = np.nan_to_num(ex)
        want = ex / (ex.sum(0) + 1e-16)
        np.testing.assert_allclose(att[sl], want, **TIGHT)
        np.testing.assert_allclose(de[sl], want * (g[sl] - np.sum(want * g[sl], 0)), **TIGHT)
    assert np.all(att[~live] == 0) and np.all(att[ptr[0]:ptr[1]] == 0)


@pytest.mark.parametrize("heads", [1, 4])
def test_segment_softmax_function_backward_matches_autograd(heads):
    rng, view = _csr(20 + heads)
    e = (rng.normal(size=(view.n_slots, heads)) * 2).astype(np.float32)
    live = torch.from_numpy(rng.random(view.n_slots) > 0.2)
    c = torch.from_numpy(rng.normal(size=e.shape).astype(np.float32))
    a, b = (torch.from_numpy(e).requires_grad_() for _ in range(2))
    got = seg_ops.SegmentSoftmax.apply(a, view.row_ptr, live)
    want = seg_ops.segment_softmax_rows_plain(b, view.row_ptr, live)
    (ga,) = torch.autograd.grad(torch.sum(got * c), a)
    (gb,) = torch.autograd.grad(torch.sum(want * c), b)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TIGHT)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5,
                               atol=1e-6 * float(gb.abs().max()))


def test_segment_dot_plain_matches_numpy():
    rng = np.random.default_rng(30)
    a = rng.normal(size=(20, 4, 5)).astype(np.float32)
    b = rng.normal(size=(25, 4, 5)).astype(np.float32)
    ia, ib = rng.integers(0, 20, 90).astype(np.int32), rng.integers(0, 25, 90).astype(np.int32)
    got = seg_ops.segment_dot(torch.from_numpy(a), torch.from_numpy(ia), torch.from_numpy(b),
                              torch.from_numpy(ib), 4).numpy()
    np.testing.assert_allclose(got, np.einsum("shd,shd->sh", a[ia], b[ib]), **TIGHT)


def test_wrappers_refuse_what_their_kernels_do_not_take():
    """S2 reads ``row_ptr`` as 64-bit on the card: both its wrappers refuse
    another type on any device. S1's and P1's schedules go to their
    kernels as raw pointers: ``check_schedule`` refuses one of the wrong
    types, shape or device."""
    _, view = _csr(41)
    e = torch.ones(view.n_slots, 2)
    with pytest.raises(TypeError, match="int64 row_ptr"):
        seg_ops.segment_softmax_rows(e, view.row_ptr.int())
    with pytest.raises(TypeError, match="int64 row_ptr"):
        seg_ops.segment_softmax_rows_bwd(e, e, view.row_ptr.int())
    work, start, n = view.schedule
    cpu = torch.device("cpu")
    assert check_schedule("S1", view.schedule, cpu)[2] == n
    for bad in ((work.long(), start, n), (work, start.int(), n), (work[:, :3], start, n),
                (work[:-1], start, n), (work.t().contiguous().t(), start, n), (work, start, -1)):
        with pytest.raises(ValueError, match="S1 schedule"):
            check_schedule("S1", bad, cpu)
    with pytest.raises(ValueError, match="on cuda"):
        check_schedule("S1", view.schedule, torch.device("cuda"))


def test_wrappers_count_no_launch_on_the_cpu():
    _, view = _csr(40)
    before = (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches)
    seg_ops.weighted_pull(torch.ones(view.n_cols, 4), torch.ones(view.n_slots, 1), view.idx,
                          view.row_ptr)
    seg_ops.segment_softmax_rows(torch.ones(view.n_slots, 1), view.row_ptr)
    assert (seg_ops.weighted_pull.launches, seg_ops.segment_softmax_rows.launches) == before


# -- models on the segment backend --------------------------------------------------


def _batch(jgraph, seed=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    arrays = js.epoch_batches(k1, k2, jgraph, 256)
    return (js.PairwiseBatch(*(a[0] for a in arrays[:4])),
            PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in arrays[:4])))


@pytest.mark.parametrize("name", ["lightgcn", "ncl"])
def test_step_matches_jax_on_segment(graphs, name):
    """One loss and its gradients: LightGCN over L segment matmuls (the
    JAX package has no R̂ on this backend), NCL with its context layer from
    the rounds, on the JAX E-step's cluster state."""
    jgraph, graph = graphs
    cfg = {"embedding.size": 16, "batch.size": 256}
    jm = (JaxLightGCN if name == "lightgcn" else JaxNCL)(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    if name == "ncl":
        state = jm.epoch_begin(params, state, jgraph, jax.random.PRNGKey(5), 0)
    jbatch, batch = _batch(jgraph)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, state, jbatch, jgraph, jax.random.PRNGKey(2))[0]))(params)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax(name, jax.device_get(params), device="cpu").items()}
    st = state_from_jax(name, jax.device_get(state), device="cpu") if name == "ncl" else {}
    loss, _ = build(name, default_config(**cfg)).loss(p, st, batch, graph)
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    for g, k in zip(torch.autograd.grad(loss, list(p.values())), p):
        _grad_close(g, want_g[k])
    u, i = build(name, default_config(**cfg)).eval_embeddings(p, st, graph)
    ju, ji = jm.eval_embeddings(params, state, jgraph)
    np.testing.assert_allclose(u.numpy(), _np(ju), **TIGHT)
    np.testing.assert_allclose(i.numpy(), _np(ji), **TIGHT)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    train, test = make_hard_dataset(n_users=120, n_items=200, n_interactions=3000, seed=3)
    path = tmp_path_factory.mktemp("segment_cli")
    write_dataset(str(path), train, test)
    return path


@pytest.mark.parametrize("model,backend", [
    ("lightgcn", "segment"), ("lightgcn", "pallas"), ("ncl", "segment"), ("ncl", "pallas"),
    ("directau", "segment"), ("selfcf", "segment"), ("buir", "segment"),
    ("ssl4rec", "segment"), ("gcl", "segment"), ("grace", "segment"), ("gbt", "segment"),
    ("bgrl", "segment"), ("selfcf", "pallas"), ("bgrl", "pallas"),
])
def test_cli_trains_on_the_segment_backend(files, capsys, model, backend):
    args = ["train", "--model", model, "--train", str(files / "train.txt"), "--test",
            str(files / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--set", f"graph.backend={backend}", "--device", "cpu"]
    assert cli.main(args) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
