"""The port's social data and graph (``data/social.py``,
``graph/social_device.py``) on the CPU against the JAX package's.

``Relation``, ``synthesize_social``, the ten motif matrices, MHCN's
channels, ESRF's motif adjacency and SEPT's views are equal to the JAX
package's bit for bit (the port's module is a copy). ``SocialDeviceGraph``'s
eight matrices are uploaded as the JAX package's on each backend: the COO
bit for bit, and on the bucketed backend the pull tables of A and Aᵀ (the
rectangular [U, I] ``interaction_norm`` too). Then each matrix's
``adj_matmul`` on the dense, bucketed and segment backends against the
dense product, forward and backward (f32 rtol 1e-5 / atol 1e-6), and
``interaction_norm.transpose()``, MHCN's item convolution, likewise, its
segment views carried through the transpose as a fresh build lays them out.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_tpu.data.social as jsocial
from recommendation_tpu.graph.social_device import SocialDeviceGraph as JaxSocialDeviceGraph
from recommendation_tpu_torch.data import social
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import densify
from recommendation_tpu_torch.graph.social_device import SOCIAL_MATRICES, SocialDeviceGraph
from recommendation_tpu_torch.ops.segment import segment_csr
from recommendation_tpu_torch.ops.spmm import adj_matmul

TIGHT = dict(rtol=1e-5, atol=1e-6)
BACKENDS = ("dense", "bucketed", "segment")


def _np(t):
    return np.asarray(t)


def _csr_equal(got, want):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    assert got.shape == want.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def triples(tiny_social, data):
    ours = social.synthesize_social(data, threshold=0.35, top_k=5)
    assert ours == tiny_social
    return ours


@pytest.fixture(scope="module")
def mats(data, triples):
    """(S, Y) of the tiny set's synthesized trust triples."""
    return social.Relation(triples, data.user).get_social_mat(), data.interaction_mat


def _toy():
    user_map = {f"u{i}": i for i in range(5)}
    triples = [["u0", "u1", 1.0], ["u1", "u0", 0.5], ["u0", "u2"], ["u2", "u3", 2.0],
               ["u3", "u0", 1.0], ["u4", "zz", 1.0], ["zz", "u4", 1.0]]
    return triples, user_map


def test_relation_matches_jax():
    triples, user_map = _toy()
    ours, ref = social.Relation(triples, user_map), jsocial.Relation(triples, user_map)
    assert ours.relation == ref.relation and ours.size() == ref.size() == (4, 5)
    assert dict(ours.followees) == dict(ref.followees)
    assert dict(ours.followers) == dict(ref.followers)
    for u1, u2 in (("u0", "u1"), ("u1", "u0"), ("u0", "u2"), ("u2", "u0"), ("u4", "zz")):
        assert ours.weight(u1, u2) == ref.weight(u1, u2)
        assert ours.has_followee(u1, u2) == ref.has_followee(u1, u2)
        assert ours.has_follower(u1, u2) == ref.has_follower(u1, u2)
    _csr_equal(ours.get_social_mat(), ref.get_social_mat())
    _csr_equal(ours.get_bidirectional_social_mat(), ref.get_bidirectional_social_mat())
    _csr_equal(ours.normalize(ours.get_social_mat()), ref.normalize(ref.get_social_mat()))


@pytest.mark.parametrize("threshold,top_k", [(0.35, 5), (0.35, 10), (0.2, 3), (0.9, 0)])
def test_synthesize_social_matches_jax(tiny_data, data, threshold, top_k):
    ours = social.synthesize_social(data, threshold=threshold, top_k=top_k)
    assert ours == jsocial.synthesize_social(tiny_data, threshold=threshold, top_k=top_k)
    assert all(u != v and w >= 0.0 for u, v, w in ours)


@pytest.fixture(scope="module")
def motifs(mats):
    S, Y = mats
    return social.triangular_motif_matrices(S, Y), jsocial.triangular_motif_matrices(S, Y)


@pytest.mark.parametrize("k", range(10))
def test_motif_matrix_matches_jax(motifs, k):
    ours, ref = motifs
    assert len(ours) == len(ref) == 10
    _csr_equal(ours[k], ref[k])


@pytest.mark.parametrize("threshold", [0, 3])
def test_mhcn_channels_match_jax(mats, threshold):
    S, Y = mats
    ours = social.mhcn_hypergraph_channels(S, Y, threshold)
    for got, want in zip(ours, jsocial.mhcn_hypergraph_channels(S, Y, threshold)):
        _csr_equal(got, want)
    assert ours[0].nnz > 0


@pytest.mark.parametrize("threshold", [0, 5])
def test_esrf_motif_and_sept_views_match_jax(mats, threshold):
    S, Y = mats
    _csr_equal(social.esrf_motif_adjacency(S, Y, threshold),
               jsocial.esrf_motif_adjacency(S, Y, threshold))
    _csr_equal(social.row_normalize(S), jsocial.row_normalize(S))
    bi = S.multiply(S.T).tocsr()
    for got, want in zip(social.sept_social_views(bi, Y), jsocial.sept_social_views(bi, Y)):
        _csr_equal(got, want)


@pytest.fixture(scope="module")
def graphs(tiny_data, data, triples):
    return {b: (SocialDeviceGraph(data, triples, backend=b, device="cpu"),
                JaxSocialDeviceGraph(tiny_data, triples, backend=b)) for b in BACKENDS}


def _tables_equal(ours, ref):
    assert (ours.n_rows, ours.n_cols, ours.total_rows) == (ref.n_rows, ref.n_cols, ref.total_rows)
    assert ours.caps == tuple(b.cap for b in ref.buckets)
    for a, b in zip(ours.buckets, ref.buckets):
        for name in ("idx", "val", "edge", "ridx"):
            got, want = getattr(a, name), getattr(b, name)
            assert (got is None) == (want is None), name
            if want is not None:
                assert np.array_equal(got.numpy(), _np(want)), name
    for name in ("gather_pos", "node_of_row"):
        assert np.array_equal(getattr(ours, name).numpy(), _np(getattr(ref, name))), name


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOCIAL_MATRICES)
def test_social_matrix_tables_match_jax(graphs, backend, name):
    graph, jgraph = graphs[backend]
    ours, ref = getattr(graph, name), getattr(jgraph, name)
    assert ours.backend == ref.backend == backend and ours.shape == ref.shape
    for field in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ours, field).numpy(), _np(getattr(ref, field))), field
    nnz = graph.social_nnz[name]
    assert nnz > 0 and nnz <= len(ours.vals) < nnz + 8  # padded to a multiple of 8
    if backend == "bucketed":
        _tables_equal(ours.pull, ref.pull)
        _tables_equal(ours.pull_t, ref.pull_t)
        assert ours.sym_rowspace == ref.sym_rowspace
    if backend == "segment":
        for view, rows, cols in ((ours.seg, ours.rows, ours.cols),
                                 (ours.seg_t, ours.cols, ours.rows)):
            assert np.array_equal(view.idx.numpy(), cols[view.perm].numpy())
            assert np.array_equal(view.slot_row.numpy(), rows[view.perm].numpy())


def _product_and_grad(adj, x, g):
    x = torch.from_numpy(x).requires_grad_()
    y = adj_matmul(adj, x)
    return y.detach().numpy(), torch.autograd.grad(y, x, torch.from_numpy(g))[0].numpy()


def _check_against_dense(adj, dense, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(adj.n_cols, 6)).astype(np.float32)
    g = rng.normal(size=(adj.n_rows, 6)).astype(np.float32)
    y, dx = _product_and_grad(adj, x, g)
    d64 = dense.astype(np.float64)
    np.testing.assert_allclose(y, d64 @ x, **TIGHT)
    np.testing.assert_allclose(dx, d64.T @ g, **TIGHT)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SOCIAL_MATRICES)
def test_adj_matmul_matches_dense_product(graphs, backend, name):
    graph, jgraph = graphs[backend]
    adj = getattr(graph, name)
    dense = densify(adj).numpy()
    np.testing.assert_array_equal(dense, _np(getattr(graphs["dense"][1], name).dense))
    _check_against_dense(adj, dense, seed=len(name))


@pytest.mark.parametrize("backend", BACKENDS)
def test_interaction_norm_transpose(graphs, backend):
    """MHCN's item convolution: Rᵀ on each backend, as the JAX package
    transposes it, against the dense Rᵀ product. The bucketed transpose
    keeps the tables (swapped); the segment one the views (swapped, their
    COO positions carried through the re-sort)."""
    graph, jgraph = graphs[backend]
    adj = graph.interaction_norm
    ours, ref = adj.transpose(), jgraph.interaction_norm.transpose()
    assert ours.shape == ref.shape == (graph.n_items, graph.n_users)
    for field in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(ours, field).numpy(), _np(getattr(ref, field))), field
    if backend == "bucketed":
        assert ours.pull is adj.pull_t and ours.pull_t is adj.pull
    if backend == "segment":
        fresh = (segment_csr(ours.rows, ours.cols, ours.n_rows, ours.n_cols),
                 segment_csr(ours.cols, ours.rows, ours.n_cols, ours.n_rows))
        for got, want in zip((ours.seg, ours.seg_t), fresh):
            for field in ("row_ptr", "idx", "slot_row", "perm", "work", "work_start"):
                assert torch.equal(getattr(got, field), getattr(want, field)), field
    _check_against_dense(ours, densify(adj).numpy().T, seed=7)
    assert torch.equal(densify(ours.transpose()), densify(adj))


def test_social_graph_keeps_the_base_graph(graphs, data):
    """The social graph is the ``DeviceGraph`` of the data plus the social
    matrices: its sampler tables and ``norm_adj`` are the plain graph's."""
    from recommendation_tpu_torch.graph.device import DeviceGraph

    graph = graphs["dense"][0]
    plain = DeviceGraph(data, backend="dense", device="cpu")
    for name in ("edge_users", "edge_items", "edge_valid", "csr_items", "user_positives"):
        assert torch.equal(getattr(graph, name), getattr(plain, name)), name
    assert graph.relation.size() == graphs["dense"][1].relation.size()
    with pytest.raises(ValueError, match="unknown graph backend"):
        SocialDeviceGraph(data, [], backend="sparse", device="cpu")
