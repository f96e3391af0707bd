"""The port's bucketed large-graph backend on the CPU against the JAX
package's (``recommendation_tpu/graph/bucketed.py``, ``graph/device.py``):
the host-built tables bit for bit, the pulls, the row-space chain and its
backward against ``jax.grad`` through the custom VJPs, value refreshes, the
large-graph dataset, LightGCN on a bucketed graph, and the entry points.

Inputs are made with numpy from a seed. Tolerances: f32 rtol 1e-5 / atol
1e-6 (the frameworks sum in other orders); gradients of a batch-mean loss
take the atol relative to the reference's largest entry. Under
``compute_dtype="bfloat16"`` at d = 128 both packages round the gathered
rows to bf16 the same way (round to nearest even) and sum in f32, so only
the order of the sums differs and the f32 bounds hold there too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_tpu.graph.bucketed as jb
import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.data.synthetic import ArrayInteraction as JaxArrayInteraction
from recommendation_tpu.data.synthetic import make_flat_interactions as jax_make_flat
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.graph.device import from_scipy as jax_from_scipy
from recommendation_tpu.graph.device import with_vals as jax_with_vals
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu.models.lightgcn import lightgcn_propagate as jax_propagate
from recommendation_tpu.ops.spmm import adj_matmul as jax_adj_matmul
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import ArrayInteraction, make_flat_interactions
from recommendation_tpu_torch.graph import bucketed as tb
from recommendation_tpu_torch.graph.device import (
    DENSE_MAX_ELEMENTS,
    DeviceGraph,
    from_scipy,
    with_vals,
)
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.lightgcn import lightgcn_propagate_square
from recommendation_tpu_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_sum,
    gather_sum_plain,
)
from recommendation_tpu_torch.ops.spmm import adj_matmul
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.train.loop import make_optimizer, train_epoch
from recommendation_tpu_torch.weights import params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _skewed_coo(n_rows=257, n_cols=181, e=3000, seed=0):
    """COO with hub rows, a power-law tail and empty rows (the JAX test's
    pattern), its values scaled so that no row's absolute sum passes 1: a
    product with O(1) inputs stays O(1), the scale the f32 bounds are for."""
    rng = np.random.default_rng(seed)
    rows = (rng.pareto(0.7, size=e) % (n_rows - 5)).astype(np.int64)  # last 5 rows empty
    cols = rng.integers(0, n_cols, e)
    mat = sp.coo_matrix((rng.normal(size=e).astype(np.float32), (rows, cols)),
                        shape=(n_rows, n_cols))
    mat.sum_duplicates()
    mat.data /= np.float32(np.abs(mat).sum(axis=1).max())
    return mat.tocoo()


def _symmetric(seed):
    """A square symmetric pattern whose values do not factor (value path),
    scaled as ``_skewed_coo``."""
    coo = _skewed_coo(seed=seed)
    mat = sp.csr_matrix(coo @ coo.T)
    mat.data /= np.float32(np.abs(mat).sum(axis=1).max())
    return mat


def _np(t):
    return np.asarray(t)


def _assert_tables_equal(ours, ref):
    assert (ours.n_rows, ours.n_cols, ours.total_rows) == (ref.n_rows, ref.n_cols, ref.total_rows)
    assert len(ours.buckets) == len(ref.buckets)
    for a, b in zip(ours.buckets, ref.buckets):
        assert a.cap == b.cap
        for name in ("idx", "val", "edge", "ridx"):
            got, want = getattr(a, name), getattr(b, name)
            assert (got is None) == (want is None), name
            if want is not None:
                got = got.cpu().numpy()
                assert got.dtype == _np(want).dtype and np.array_equal(got, _np(want)), name
    for name in ("gather_pos", "node_of_row", "sep_dst", "sep_src_row"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if want is not None:
            got = got.cpu().numpy()
            assert got.dtype == _np(want).dtype and np.array_equal(got, _np(want)), name
    # the flat view P1 reads: each row's slots are its bucket row
    ptr = ours.row_ptr.numpy()
    assert len(ptr) == ours.total_rows + 2 and ptr[-1] == ptr[-2] == ours.n_slots
    caps = np.repeat(ours.caps, ours.counts)
    assert np.array_equal(np.diff(ptr)[:-1], caps)


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("with_vals_", [True, False], ids=["vals", "template"])
def test_build_tables_bit_identical_on_skewed_coo(seed, with_vals_):
    coo = _skewed_coo(seed=seed)
    vals = coo.data if with_vals_ else None
    ours = tb.build_bucketed(coo.row, coo.col, vals, *coo.shape, device="cpu")
    _assert_tables_equal(ours, jb.build_bucketed(coo.row, coo.col, vals, *coo.shape))
    assert ours.ridx is None  # a rectangular pattern never chains


def test_build_tables_unsorted_input_and_edge_ids():
    coo = _skewed_coo(seed=7)
    order = np.random.default_rng(0).permutation(len(coo.row))
    eids = np.random.default_rng(1).permutation(len(coo.row)).astype(np.int32)
    args = (coo.row[order], coo.col[order], coo.data[order], *coo.shape)
    _assert_tables_equal(tb.build_bucketed(*args, edge_ids=eids, device="cpu"),
                         jb.build_bucketed(*args, edge_ids=eids))


def test_build_rejects_out_of_range_edges():
    with pytest.raises(ValueError, match="outside"):
        tb.build_bucketed(np.array([0, 3]), np.array([0, 1]), None, 3, 2, device="cpu")


@pytest.mark.parametrize("which", ["tiny_norm_adj", "symmetric"])
def test_from_scipy_tables_bit_identical(tiny_data, which):
    mat = tiny_data.norm_adj if which == "tiny_norm_adj" else _symmetric(2)
    ours = from_scipy(mat, backend="bucketed", device="cpu")
    ref = jax_from_scipy(mat, backend="bucketed")
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ours, name).numpy(), _np(getattr(ref, name))), name
    assert ours.sym_rowspace == ref.sym_rowspace is True
    _assert_tables_equal(ours.pull, ref.pull)
    _assert_tables_equal(ours.pull_t, ref.pull_t)
    # the normalized adjacency factors, the product of two patterns does not
    assert (ours.pull.sep_dst is not None) == (which == "tiny_norm_adj")


@pytest.fixture(scope="module")
def flat_pair():
    """The JAX large-graph test's shape (tests/test_large_graph_paths.py:105):
    12k nodes, past the dense threshold, so ``auto`` picks bucketed."""
    pairs = make_flat_interactions(3000, 9000, 30_000, seed=2)
    ours = ArrayInteraction(pairs, 3000, 9000, test_fraction=0.1)
    ref = JaxArrayInteraction(jax_make_flat(3000, 9000, 30_000, seed=2), 3000, 9000,
                              test_fraction=0.1)
    return ours, ref


def test_flat_interactions_and_array_interaction_equal(flat_pair):
    ours, ref = flat_pair
    assert ours.training_size() == ref.training_size()
    for name in ("training_data", "test_pairs", "edge_users", "edge_items", "edge_weights"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("interaction_mat", "ui_adj", "norm_adj"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert (got != want).nnz == 0 and got.dtype == want.dtype, name
    assert np.array_equal(ours.test_user_ids(), ref.test_user_ids())
    for a, b in zip(ours.test_items_by_user(), ref.test_items_by_user(), strict=True):
        assert np.array_equal(a, b)


def test_auto_backend_large_graph_tables_bit_identical(flat_pair):
    ours_data, ref_data = flat_pair
    assert (3000 + 9000) ** 2 > DENSE_MAX_ELEMENTS
    ours = DeviceGraph(ours_data, backend="auto", device="cpu")
    ref = JaxDeviceGraph(ref_data, backend="auto")
    assert ours.backend == ref.backend == "bucketed"
    for name in ("n_edges", "max_degree", "has_pos_table", "has_pos_bitmap",
                 "has_edge_bitmap_fb", "has_pos_mask"):
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ("edge_users", "edge_items", "edge_valid", "edge_ui", "csr_indptr", "csr_items",
                 "user_fallback_neg", "user_positives", "user_degrees"):
        got, want = getattr(ours, name).numpy(), _np(getattr(ref, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("rows", "cols", "vals"):
        got, want = getattr(ours.norm_adj, name).numpy(), _np(getattr(ref.norm_adj, name))
        assert np.array_equal(got, want), name
    assert ours.norm_adj.sym_rowspace and ref.norm_adj.sym_rowspace
    _assert_tables_equal(ours.norm_adj.pull, ref.norm_adj.pull)
    _assert_tables_equal(ours.norm_adj.pull_t, ref.norm_adj.pull_t)
    assert ours.interaction_norm_dense is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ours.propagation_matrix  # noqa: B018


# -- pulls and the chain against JAX ------------------------------------------

PULL_CASES = [("float32", 24), ("float32", 5), ("bfloat16", 128), ("bfloat16", 64)]


@pytest.mark.parametrize("compute_dtype,d", PULL_CASES)
def test_pull_matches_jax(compute_dtype, d):
    coo = _skewed_coo(seed=13)
    ours = from_scipy(sp.csr_matrix(coo), backend="bucketed", device="cpu")
    ref = jax_from_scipy(sp.csr_matrix(coo), backend="bucketed")
    x = np.random.default_rng(d).normal(size=(coo.shape[1], d)).astype(np.float32)
    got = tb.pull(ours.pull, torch.from_numpy(x), compute_dtype)
    want = jb.pull(ref.pull, jnp.asarray(x), compute_dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == (coo.shape[0], d)
    np.testing.assert_allclose(got.numpy(), _np(want), **TIGHT)
    assert np.abs(got.numpy()[-5:]).max() == 0.0  # empty rows give exact zeros


def _row_input(csr, d, seed):
    xp = np.random.default_rng(seed).normal(size=(csr.total_rows + 1, d)).astype(np.float32)
    xp[-1] = 0.0  # the row-space convention: the last row is zero
    return xp


@pytest.mark.parametrize("compute_dtype,d", PULL_CASES)
@pytest.mark.parametrize("which", ["tiny_norm_adj", "symmetric"])
def test_pull_rowspace_matches_jax(tiny_data, which, compute_dtype, d):
    mat = tiny_data.norm_adj if which == "tiny_norm_adj" else _symmetric(4)
    ours = from_scipy(mat, backend="bucketed", device="cpu").pull
    ref = jax_from_scipy(mat, backend="bucketed").pull
    xp = _row_input(ours, d, seed=d + 1)
    got = tb.pull_rowspace(ours, torch.from_numpy(xp), compute_dtype)
    want = jb.pull_rowspace(ref, jnp.asarray(xp), compute_dtype)
    np.testing.assert_allclose(got.numpy(), _np(want), **TIGHT)
    assert np.abs(got.numpy()[-1]).max() == 0.0
    if which == "tiny_norm_adj" and compute_dtype == "float32":
        # the plain sum the separable chain folds its scales around, on its
        # input b ⊙ x; a sum of up to deg terms, so atol relative to its scale
        y = xp * _np(ref.sep_src_row)[:, None]
        got = tb._gather_sum_rowspace(ours, torch.from_numpy(y))
        want = _np(jb._gather_sum_rowspace(ref, jnp.asarray(y)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


CHAIN_CASES = [("tiny_norm_adj", "float32", 16, 3), ("tiny_norm_adj", "float32", 8, 1),
               ("tiny_norm_adj", "float32", 8, 0), ("tiny_norm_adj", "float32", 8, 2),
               ("tiny_norm_adj", "bfloat16", 128, 3), ("symmetric", "float32", 8, 2),
               ("symmetric", "bfloat16", 128, 2)]


@pytest.mark.parametrize("which,compute_dtype,d,n_layers", CHAIN_CASES)
def test_chain_mean_value_and_grad_match_jax(tiny_data, which, compute_dtype, d, n_layers):
    """The row-space chain and its mirrored Horner backward against
    ``jax.grad`` through ``bucketed_chain_mean``'s custom VJP: the folded
    separable chain (tiny norm_adj in f32), the value path (a symmetric
    pattern that does not factor) and the bf16-rounded chain at d = 128."""
    mat = tiny_data.norm_adj if which == "tiny_norm_adj" else _symmetric(6)
    ours = from_scipy(mat, backend="bucketed", device="cpu")
    ref = jax_from_scipy(mat, backend="bucketed")
    rng = np.random.default_rng(d + n_layers)
    x = rng.normal(size=(mat.shape[0], d)).astype(np.float32)
    probe = rng.normal(size=(mat.shape[0], d)).astype(np.float32)

    def f(x):
        out = jb.bucketed_chain_mean(n_layers, compute_dtype, ref.pull, ref.pull_t, x)
        return jnp.sum(out * probe), out

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tb.bucketed_chain_mean(n_layers, compute_dtype, ours.pull, ours.pull_t, xt)
    assert got.grad_fn is not None
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TIGHT)
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_g), **TIGHT)
    # the plain chain (autograd through the plain primitives) is the same
    # function; its autograd rounds the cotangent to bf16 where the custom
    # VJP rounds the operand, so in bf16 its gradient holds the bf16 bound
    xp_ = torch.from_numpy(x).requires_grad_()
    plain = tb.bucketed_chain_mean_plain(n_layers, compute_dtype, ours.pull, xp_)
    (plain * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(plain.detach().numpy(), _np(want), **TIGHT)
    packed = tb.packs_bf16(compute_dtype, d)
    g_tol = dict(rtol=3e-2, atol=3e-3 * np.abs(_np(want_g)).max()) if packed else TIGHT
    np.testing.assert_allclose(xp_.grad.numpy(), _np(want_g), **g_tol)


@pytest.mark.parametrize("compute_dtype,d", [("float32", 8), ("bfloat16", 128)])
def test_bucketed_matmul_value_and_vjp_match_jax(compute_dtype, d):
    coo = _skewed_coo(seed=5)
    ours = from_scipy(sp.csr_matrix(coo), backend="bucketed", device="cpu")
    ref = jax_from_scipy(sp.csr_matrix(coo), backend="bucketed")
    x = np.random.default_rng(2).normal(size=(coo.shape[1], d)).astype(np.float32)

    def f(x):
        return jnp.sum(jnp.tanh(jb.bucketed_matmul(ref.pull, ref.pull_t, x, compute_dtype)) ** 2)

    want, want_g = jax.value_and_grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = torch.sum(torch.tanh(tb.bucketed_matmul(ours.pull, ours.pull_t, xt, compute_dtype)) ** 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_g), **TIGHT)
    # adj_matmul routes the bucketed adjacency to the same function
    np.testing.assert_allclose(adj_matmul(ours, torch.from_numpy(x)).numpy(),
                               _np(jax_adj_matmul(ref, jnp.asarray(x))), **TIGHT)


def test_bf16_equals_f32_at_d64(tiny_data):
    """At d = 64 neither dtype packs: the bf16 chain is the f32 chain, bit
    for bit, forward and backward."""
    adj = from_scipy(tiny_data.norm_adj, backend="bucketed", device="cpu")
    x = np.random.default_rng(0).normal(size=(adj.n_rows, 64)).astype(np.float32)
    outs = []
    for dt in ("float32", "bfloat16"):
        xt = torch.from_numpy(x).requires_grad_()
        out = tb.bucketed_chain_mean(3, dt, adj.pull, adj.pull_t, xt)
        out.square().sum().backward()
        outs.append((out.detach(), xt.grad, tb.pull(adj.pull, torch.from_numpy(x), dt)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not tb.packs_bf16("bfloat16", 64) and tb.packs_bf16("bfloat16", 127)


# -- value refreshes ----------------------------------------------------------


def test_refresh_and_map_vals_match_jax():
    coo = _skewed_coo(seed=9)
    tpl_ours = tb.build_bucketed(coo.row, coo.col, None, *coo.shape, device="cpu")
    tpl_ref = jb.build_bucketed(coo.row, coo.col, None, *coo.shape)
    ours = tb.refresh_vals(tpl_ours, torch.from_numpy(coo.data))
    ref = jb.refresh_vals(tpl_ref, jnp.asarray(coo.data))
    _assert_tables_equal(ours, ref)
    direct = tb.build_bucketed(coo.row, coo.col, coo.data, *coo.shape, device="cpu")
    assert torch.equal(ours.val, direct.val)
    _assert_tables_equal(tb.map_vals(ours, lambda v: (v > 0).float()),
                         jb.map_vals(ref, lambda v: (v > 0).astype(jnp.float32)))


def test_with_vals_refreshes_both_directions_as_jax(tiny_data):
    ours = from_scipy(tiny_data.norm_adj, backend="bucketed", device="cpu")
    ref = jax_from_scipy(tiny_data.norm_adj, backend="bucketed")
    keep = np.random.default_rng(3).random(ours.vals.shape[0]) > 0.3
    vals = ours.vals.numpy() * keep
    got, want = with_vals(ours, torch.from_numpy(vals)), jax_with_vals(ref, jnp.asarray(vals))
    _assert_tables_equal(got.pull, want.pull)
    _assert_tables_equal(got.pull_t, want.pull_t)
    assert got.sym_rowspace and got.pull.sep_dst is None  # refreshed values take the value path
    x = np.random.default_rng(4).normal(size=(ours.n_rows, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tb.bucketed_chain_mean(2, "float32", got.pull, got.pull_t, torch.from_numpy(x)).numpy(),
        _np(jb.bucketed_chain_mean(2, "float32", want.pull, want.pull_t, jnp.asarray(x))), **TIGHT)


def test_mirrored_transpose_matches_jax(tiny_data):
    graph = JaxDeviceGraph(tiny_data, backend="bucketed")
    tpl = graph._bipartite_pull_tpl
    e_half = graph.edge_users.shape[0]
    users, items = _np(graph.edge_users), _np(graph.edge_items) + graph.n_users
    rows, cols = np.concatenate([users, items]), np.concatenate([items, users])
    ours = tb.build_bucketed(rows, cols, None, graph.n_nodes, graph.n_nodes,
                             edge_ids=np.arange(2 * e_half, dtype=np.int32), device="cpu")
    _assert_tables_equal(ours, tpl)
    _assert_tables_equal(tb.mirrored_transpose(ours, e_half),
                         jb.mirrored_transpose(tpl, e_half))


def test_refresh_vals_debug_check_refuses_resurrection(monkeypatch):
    # 5 interactions: the square pattern's 10 entries are padded to 16 with
    # zero-valued edges, which ridx routes to the zero row
    data = Interaction([[f"u{i}", f"i{i % 3}", 1.0] for i in range(5)], [])
    adj = from_scipy(data.norm_adj, backend="bucketed", device="cpu")
    assert adj.vals.shape[0] == 16 and adj.vals[-1] == 0
    vals = adj.vals.clone()
    vals[-1] = 1.0  # a zero-valued COO padding edge comes back to life
    monkeypatch.delenv("RECTPU_DEBUG_CHECKS", raising=False)
    with_vals(adj, vals)  # unchecked by default
    monkeypatch.setenv("RECTPU_DEBUG_CHECKS", "1")
    with pytest.raises(RuntimeError, match="build-time-zero"):
        with_vals(adj, vals)
    with_vals(adj, adj.vals * 0.5)  # masks and scalings keep the zeros


# -- the wrappers on the CPU ----------------------------------------------------


def test_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 7)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, 80).astype(np.int32))
    before = gather_rows.launches, gather_sum.launches
    assert torch.equal(gather_rows(x, idx), x[idx.long()])
    assert torch.equal(gather_rows(x.bfloat16(), idx), x.bfloat16()[idx.long()])
    assert torch.equal(gather_rows(x, idx), gather_rows_plain(x, idx))
    csr = tb.build_bucketed(*_pattern(rng), 50, 50, device="cpu")
    val, post = csr.val, torch.from_numpy(rng.random(csr.total_rows + 1).astype(np.float32))
    for kw in ({}, {"val": val}, {"post": post}, {"val": val, "post": post, "add": x * 2}):
        assert torch.equal(gather_sum(x, csr.idx, csr.row_ptr, **kw),
                           gather_sum_plain(x, csr.idx, csr.row_ptr, **kw))
    assert (gather_rows.launches, gather_sum.launches) == before  # the CPU launches nothing


@pytest.mark.parametrize("with_acc,with_final,keep_y", [
    (True, False, True), (True, False, False), (False, True, False), (True, True, False),
    (True, True, True)], ids=["acc-keep-y", "acc", "final", "acc-final", "acc-final-keep-y"])
def test_pull_epilogue_equals_the_unfused_composition(with_acc, with_final, keep_y):
    """``gather_sum_plain``'s epilogue, and the wrapper's on the CPU, is the
    chain's elementwise operations after the pull, bit for bit: ``acc + y``,
    ``y · final``, ``(acc + y) · final``, with ``y`` beside it on request."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(50, 7)).astype(np.float32))
    csr = tb.build_bucketed(*_pattern(rng), 50, 50, device="cpu")
    n_out = csr.total_rows + 1
    post = torch.from_numpy(rng.random(n_out).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(n_out, 7)).astype(np.float32)) if with_acc else None
    final = torch.from_numpy(rng.random(n_out).astype(np.float32)) if with_final else None
    kw = dict(val=csr.val, post=post, add=x * 2)
    y = gather_sum_plain(x, csr.idx, csr.row_ptr, **kw)
    total = y if acc is None else acc + y
    total = total * final[:, None] if with_final else total
    want = (y, total) if keep_y else (total,)
    for fn in (gather_sum_plain, gather_sum):
        got = fn(x, csr.idx, csr.row_ptr, **kw, acc=acc, final=final, keep_y=keep_y)
        got = got if keep_y else (got,)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_pull_schedule_covers_the_slots_in_order():
    """P1's work list: one item per row and one per 128-slot piece of a
    longer row, the items' slot ranges back to back from 0 to S, and the
    split rows' partial sums numbered in row order."""
    from recommendation_tpu_torch.ops.gather import CHUNK, pull_schedule

    lens = np.array([0, 5, 128, 129, 300, 1, 0])
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    work, start, n_partials = pull_schedule(ptr)
    assert work.dtype == torch.int32 and start.dtype == torch.int64
    assert start.shape == (work.shape[0] + 1,) and start[0] == 0 and start[-1] == lens.sum()
    rows, piece, first, pieces = work.numpy().T
    assert rows.tolist() == [0, 1, 2, 3, 3, 4, 4, 4, 5, 6]
    assert np.array_equal(start[:-1].numpy(), ptr.numpy()[rows] + piece * CHUNK)
    assert np.all(np.diff(start.numpy()) <= CHUNK) and np.all(np.diff(start.numpy()) >= 0)
    assert n_partials == 5 and first.tolist() == [-1, -1, -1, 0, 0, 2, 2, 2, -1, -1]
    assert pieces.tolist() == [1, 1, 1, 2, 2, 3, 3, 3, 1, 1]


def _pattern(rng):
    rows = rng.integers(0, 50, 400)
    cols = rng.integers(0, 50, 400)
    keep = np.unique(rows * 50 + cols)
    return keep // 50, keep % 50, rng.random(len(keep)).astype(np.float32)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, idx = torch.zeros(4, 3), torch.zeros(2, dtype=torch.int32)
    ptr = torch.tensor([0, 1, 2, 2])
    with pytest.raises(TypeError, match="int32"):
        gather_rows(x, idx.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather_rows(x.double(), idx)
    with pytest.raises(TypeError, match="int64 row_ptr"):
        gather_sum(x, idx, ptr.int())
    with pytest.raises(ValueError, match="val"):
        gather_sum(x, idx, ptr, val=torch.zeros(3))
    with pytest.raises(TypeError, match="second source"):
        gather_sum(x.bfloat16(), idx, ptr, add=x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.packs_bf16("int8", 64)


# -- LightGCN and the entry points on a bucketed graph ---------------------------


@pytest.fixture(scope="module")
def port_data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(tiny_data, port_data):
    """(port bucketed, JAX bucketed, port dense) graphs of tiny_data."""
    return (DeviceGraph(port_data, backend="bucketed", device="cpu"),
            JaxDeviceGraph(tiny_data, backend="bucketed"),
            DeviceGraph(port_data, backend="dense", device="cpu"))


@pytest.mark.parametrize("loss_type", ["bpr", "bce"])
def test_lightgcn_loss_and_grads_on_bucketed_match_jax(graphs, loss_type):
    """The JAX model's parameters carried over by ``weights.params_from_jax``
    (the same names and shapes on either backend) and one batch: the loss
    and its gradients through ``BucketedChainMean``."""
    ours_g, ref_g, _ = graphs
    cfg = {"embedding.size": 16, "batch.size": 256, "loss": loss_type}
    jm = JaxLightGCN(jax_default_config(**cfg))
    params, _ = jm.init(jax.random.PRNGKey(0), ref_g)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    users, items, negs, weights, _ = js.epoch_batches(k1, k2, ref_g, 256)
    jbatch = js.PairwiseBatch(users[0], items[0], negs[0], weights[0])
    want, want_g = jax.value_and_grad(
        lambda p: jm.loss(p, {}, jbatch, ref_g, jax.random.PRNGKey(2))[0])(params)

    p = {k: v.requires_grad_() for k, v in
         params_from_jax("lightgcn", jax.device_get(params), device="cpu").items()}
    model = build("lightgcn", default_config(**cfg))
    mine, _ = model.init(torch.Generator().manual_seed(0), ours_g)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in p.items()}
    batch = PairwiseBatch(*(torch.from_numpy(np.array(a[0]))
                            for a in (users, items, negs, weights)))
    loss, _ = model.loss(p, {}, batch, ours_g)
    grads = torch.autograd.grad(loss, list(p.values()))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for g, name in zip(grads, p):
        w = _np(want_g[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def test_propagate_return_layers_matches_jax(graphs):
    ours_g, ref_g, _ = graphs
    rng = np.random.default_rng(5)
    ue = rng.normal(size=(ours_g.n_users, 8)).astype(np.float32)
    ie = rng.normal(size=(ours_g.n_items, 8)).astype(np.float32)
    got = lightgcn_propagate_square(torch.from_numpy(ue), torch.from_numpy(ie),
                                      ours_g.norm_adj, 2, return_layers=True)
    want = jax_propagate(jnp.asarray(ue), jnp.asarray(ie), ref_g.norm_adj, 2, return_layers=True)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    for a, b in zip(got[2], want[2], strict=True):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    fused = lightgcn_propagate_square(torch.from_numpy(ue), torch.from_numpy(ie),
                                        ours_g.norm_adj, 2)
    for a, b in zip(fused, got[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TIGHT)


def test_eval_embeddings_bucketed_equal_dense(graphs):
    """Port against port: the same parameters through the bucketed chain
    and through the dense R̂ chain give the same eval embeddings."""
    ours_g, _, dense_g = graphs
    model = build("lightgcn", default_config(**{"embedding.size": 16}))
    params, _ = model.init(torch.Generator().manual_seed(4), dense_g)
    for a, b in zip(model.eval_embeddings(params, {}, ours_g),
                    model.eval_embeddings(params, {}, dense_g)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_one_cpu_epoch_on_bucketed_is_finite(graphs):
    ours_g = graphs[0]
    config = default_config(**{"embedding.size": 16, "batch.size": 512})
    model = build("lightgcn", config)
    params, state = model.init(torch.Generator().manual_seed(0), ours_g)
    params = {k: v.requires_grad_() for k, v in params.items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    _, loss = train_epoch(model, make_optimizer(config, params), ours_g, params, state,
                          torch.Generator().manual_seed(1), 512)
    assert np.isfinite(float(loss))
    assert all(not torch.equal(params[k].detach(), before[k]) for k in params)


def test_ncl_and_unported_forms_raise_on_bucketed(graphs, port_data):
    """NCL now builds on the bucketed backend (its parity with the JAX NCL
    there is tests/test_torch_ncl_bucketed.py's); int8 propagation still
    raises; the segment backend is ported now (tests/test_torch_segment.py)
    and builds."""
    ours_g = graphs[0]
    params, state = build("ncl", default_config()).init(torch.Generator().manual_seed(0), ours_g)
    assert params["user_emb"].shape[0] == ours_g.n_users
    assert state["item_2cluster"].shape == (ours_g.n_items,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceGraph(port_data, backend="bucketed", compute_dtype="int8", device="cpu")
    assert from_scipy(port_data.norm_adj, backend="segment", device="cpu").seg is not None


def test_cli_trains_on_the_bucketed_backend(port_data, tmp_path):
    import json
    import subprocess
    import sys

    from recommendation_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path), port_data.training_data, port_data.test_data)
    out = subprocess.run(
        [sys.executable, "-m", "recommendation_tpu_torch", "train", "--model", "lightgcn",
         "--device", "cpu", "--train", str(tmp_path / "train.txt"), "--test",
         str(tmp_path / "test.txt"), "--set", "graph.backend=bucketed", "--set", "max.epoch=2",
         "--set", "batch.size=512", "--set", "embedding.size=16"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "backend=bucketed" in out.stdout + out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_serve_from_saved_parameters_on_bucketed_equals_dense(port_data, tmp_path):
    """``cli.build_service`` with ``graph.backend=bucketed``: the same saved
    parameters serve the same answers as on the dense backend."""
    from recommendation_tpu_torch.cli import build_service
    from recommendation_tpu_torch.ops.topk import topk_agree
    from recommendation_tpu_torch.weights import save_params

    config = default_config(**{"embedding.size": 16})
    dense = DeviceGraph(port_data, backend="dense", device="cpu")
    params, _ = build("lightgcn", config).init(torch.Generator().manual_seed(6), dense)
    save_params(str(tmp_path / "p.npz"), params)
    answers = []
    for backend in ("bucketed", "dense"):
        service = build_service("lightgcn", str(tmp_path / "p.npz"),
                                config.with_overrides(**{"graph.backend": backend}),
                                port_data.training_data, port_data.test_data, device="cpu")
        assert service.graph.backend == backend
        answers.append(service.recommend_ids(list(range(20)), 10))
    (s_b, i_b), (s_d, i_d) = answers
    assert topk_agree(s_b, i_b, s_d, i_d, tol=1e-5)
