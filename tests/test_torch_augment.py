"""On-device graph augmentation (``graph/augment.py``) and the adjacencies it
works on (``DeviceGraph.normalized_bipartite``, ``norm_adj_selfloops``) on
the CPU against the JAX package's.

``normalized_bipartite`` for a numpy keep mask: on the dense backend the
(U+I)² matrix, built at first access and repeating bit for bit; on the
bucketed backend the structure-only templates bit for bit (built at the
first call, not with the graph), the refreshed values at the f32 bound and
the row-space chain through them. ``norm_adj_selfloops`` on the dense
backend, and on the segment backend where the graph is bucketed.
``edge_keep_mask``, ``dropped_norm_adj``, ``drop_edges`` and
``mask_features`` on the same uniform draws as ``jax.random``'s (the
draws replaced by one numpy stream on both sides). f32 rtol 1e-5 / atol
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.graph.augment as jaug
import recommendation_tpu.graph.bucketed as jb
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph import bucketed as tb
from recommendation_tpu_torch.graph.device import DeviceGraph, densify

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.fixture(scope="module")
def sets():
    from recommendation_tpu.data.interaction import Interaction as JaxInteraction

    train, test = make_hard_dataset(n_users=120, n_items=200, n_interactions=4000, seed=3)
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.fixture(scope="module")
def graphs(sets):
    jdata, data = sets
    return {b: (JaxDeviceGraph(jdata, backend=b), DeviceGraph(data, backend=b, device="cpu"))
            for b in ("dense", "bucketed")}


def _keep(graph, seed, rate=0.3):
    return (np.random.default_rng(seed).random(graph.edge_valid.shape[0]) >= rate).astype(
        np.float32)


def _assert_tables_equal(ours, ref):
    assert (ours.n_rows, ours.n_cols, ours.total_rows) == (ref.n_rows, ref.n_cols, ref.total_rows)
    assert len(ours.buckets) == len(ref.buckets)
    for a, b in zip(ours.buckets, ref.buckets):
        assert a.cap == b.cap
        for name in ("idx", "val", "edge", "ridx"):
            got, want = getattr(a, name).numpy(), _np(getattr(b, name))
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("gather_pos", "node_of_row"):
        assert np.array_equal(getattr(ours, name).numpy(), _np(getattr(ref, name))), name
    assert ours.sep_dst is None and ref.sep_dst is None


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_dense_normalized_bipartite_matches_jax(graphs, seed):
    jgraph, graph = graphs["dense"]
    keep = None if seed is None else _keep(graph, seed)
    adj = graph.normalized_bipartite(None if keep is None else torch.from_numpy(keep))
    want = jgraph.normalized_bipartite(None if keep is None else jnp.asarray(keep))
    assert adj._dense is None  # the (U+I)² matrix waits for its first access
    assert adj.vals.shape == (2 * graph.edge_valid.shape[0],) and adj.pull is None
    np.testing.assert_allclose(adj.vals.numpy(), _np(want.vals), **TIGHT)
    np.testing.assert_array_equal(adj.rows.numpy(), _np(want.rows))
    np.testing.assert_array_equal(adj.cols.numpy(), _np(want.cols))
    np.testing.assert_allclose(adj.dense.numpy(), _np(want.dense), **TIGHT)
    again = graph.normalized_bipartite(None if keep is None else torch.from_numpy(keep))
    assert torch.equal(again.dense, adj.dense)  # the scatter repeats bit for bit
    if keep is None:  # no mask: the normalized bipartite adjacency itself
        np.testing.assert_allclose(adj.dense.numpy(), graph.norm_adj.dense.numpy(), **TIGHT)
    else:  # a dropped edge is gone both ways, and the degrees count the kept edges
        dense = adj.dense.numpy()
        assert np.array_equal(dense, dense.T)
        u = graph.edge_users.numpy()[:graph.n_edges]
        i = graph.edge_items.numpy()[:graph.n_edges] + graph.n_users
        kept = keep[:graph.n_edges] > 0
        assert (dense[u[~kept], i[~kept]] == 0).all() and (dense[u[kept], i[kept]] > 0).all()


def test_bucketed_templates_and_refresh_match_jax(graphs):
    jgraph, graph = graphs["bucketed"]
    assert graph._bipartite_tpl is None  # not built with the graph
    keep = _keep(graph, 2)
    adj = graph.normalized_bipartite(torch.from_numpy(keep))
    want = jgraph.normalized_bipartite(jnp.asarray(keep))
    tpl, tpl_t = graph._bipartite_tpl
    _assert_tables_equal(tpl, jgraph._bipartite_pull_tpl)
    _assert_tables_equal(tpl_t, jgraph._bipartite_pull_t_tpl)
    assert graph.normalized_bipartite()._dense is None and graph._bipartite_tpl[0] is tpl
    assert adj.sym_rowspace and adj.pull.sep_dst is None
    for ours, ref in ((adj.pull, want.pull), (adj.pull_t, want.pull_t)):
        for a, b in zip(ours.buckets, ref.buckets):
            np.testing.assert_array_equal(a.edge.numpy(), _np(b.edge))
            np.testing.assert_allclose(a.val.numpy(), _np(b.val), **TIGHT)
    x = np.random.default_rng(4).normal(size=(graph.n_nodes, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tb.bucketed_chain_mean(2, "float32", adj.pull, adj.pull_t, torch.from_numpy(x)).numpy(),
        _np(jb.bucketed_chain_mean(2, "float32", want.pull, want.pull_t, jnp.asarray(x))),
        **TIGHT)
    # the bucketed and the dense backend hold the same matrix
    _, dense_graph = graphs["dense"]
    np.testing.assert_allclose(
        densify(adj).numpy(),
        dense_graph.normalized_bipartite(torch.from_numpy(keep)).dense.numpy(), **TIGHT)
    np.testing.assert_allclose(tb.pull(adj.pull, torch.from_numpy(x)).numpy(),
                               densify(adj).numpy() @ x, rtol=1e-5, atol=1e-5)


def test_norm_adj_selfloops(graphs, sets):
    jgraph, graph = graphs["dense"]
    assert graph._norm_adj_selfloops is None  # built at first access
    adj = graph.norm_adj_selfloops
    assert adj is graph.norm_adj_selfloops and adj.backend == "dense"
    np.testing.assert_allclose(adj.dense.numpy(), _np(jgraph.norm_adj_selfloops.dense), **TIGHT)
    np.testing.assert_array_equal(adj.rows.numpy(), _np(jgraph.norm_adj_selfloops.rows))
    np.testing.assert_allclose(adj.vals.numpy(), _np(jgraph.norm_adj_selfloops.vals), **TIGHT)
    assert (np.diag(adj.dense.numpy()) > 0).all()
    # where the graph is bucketed it lives on the segment backend, as in the
    # JAX package: the same COO, with its row-sorted views
    jbucketed, bucketed = graphs["bucketed"]
    loops = bucketed.norm_adj_selfloops
    assert loops.backend == _np_backend(jbucketed) == "segment" and loops.seg is not None
    for name in ("rows", "cols", "vals"):
        assert torch.equal(getattr(loops, name), getattr(adj, name)), name


def _np_backend(jgraph):
    return jgraph.norm_adj_selfloops.backend


class Draws:
    """One stream of numpy uniforms: recorded by the JAX side's
    ``jax.random.bernoulli`` calls, replayed by the port's ``augment.uniform``."""

    def __init__(self, seed):
        self.rng, self.seq, self.pos = np.random.default_rng(seed), [], 0

    def patch_jax(self, mp):
        def bern(key, p=0.5, shape=None):
            self.seq.append(self.rng.random(tuple(shape)).astype(np.float32))
            return jnp.asarray(self.seq[-1]) < p

        mp.setattr(jax.random, "bernoulli", bern)

    def patch_port(self, mp):
        def replay(generator, shape, device):
            self.pos += 1
            assert self.seq[self.pos - 1].shape == tuple(shape)
            return torch.from_numpy(self.seq[self.pos - 1]).to(device)

        mp.setattr(augment, "uniform", replay)


@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_augment_matches_jax_on_the_same_draws(graphs, monkeypatch, backend):
    jgraph, graph = graphs[backend]
    x = np.random.default_rng(5).normal(size=(graph.n_nodes, 16)).astype(np.float32)
    draws = Draws(3)
    key = jax.random.PRNGKey(0)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want = {
            "keep": jaug.edge_keep_mask(key, jgraph, 0.3),
            "dropped": jaug.dropped_norm_adj(key, jgraph, 0.2),
            "drop": jaug.drop_edges(key, jgraph.norm_adj, 0.25),
            "drop_renorm": jaug.drop_edges(key, jgraph.norm_adj, 0.4, renormalize=True),
            "mask": jaug.mask_features(key, jnp.asarray(x), 0.3),
        }
    g = torch.Generator().manual_seed(0)
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        got = {
            "keep": augment.edge_keep_mask(g, graph, 0.3),
            "dropped": augment.dropped_norm_adj(g, graph, 0.2),
            "drop": augment.drop_edges(g, graph.norm_adj, 0.25),
            "drop_renorm": augment.drop_edges(g, graph.norm_adj, 0.4, renormalize=True),
            "mask": augment.mask_features(g, torch.from_numpy(x), 0.3),
        }
    assert draws.pos == len(draws.seq) == 5
    assert got["keep"].dtype == torch.float32
    np.testing.assert_array_equal(got["keep"].numpy(), _np(want["keep"]))
    np.testing.assert_array_equal(got["mask"].numpy(), _np(want["mask"]))
    for k in ("dropped", "drop", "drop_renorm"):
        np.testing.assert_allclose(got[k].vals.numpy(), _np(want[k].vals), **TIGHT, err_msg=k)
        ref = _np(want[k].dense) if backend == "dense" else \
            _np(jax.numpy.zeros((graph.n_nodes,) * 2).at[want[k].rows, want[k].cols].add(
                want[k].vals))
        np.testing.assert_allclose(densify(got[k]).numpy(), ref, **TIGHT, err_msg=k)
        if backend == "bucketed":
            assert got[k].sym_rowspace and got[k].pull.sep_dst is None
    vals = graph.norm_adj.vals.numpy()
    kept = got["drop"].vals.numpy() != 0
    np.testing.assert_allclose(got["drop"].vals.numpy()[kept], vals[kept] * np.float32(1 / 0.75),
                               **TIGHT)
    assert set(np.unique(got["drop_renorm"].vals.numpy() / np.where(vals > 0, vals, 1))) <= {0, 1}


def test_draws_come_from_a_device_generator_seeded_by_the_trainer(graphs):
    _, graph = graphs["dense"]
    masks = []
    for _ in range(2):
        g = augment.device_generator(torch.Generator().manual_seed(9), graph.device)
        assert g.device.type == graph.device.type
        masks.append(augment.edge_keep_mask(g, graph, 0.25))
    assert torch.equal(masks[0], masks[1])
    assert abs(masks[0].mean().item() - 0.75) < 0.03
    with pytest.raises(ValueError, match="generator"):
        augment.device_generator(None, graph.device)
    x = torch.ones(graph.n_nodes, 64)
    cols = augment.mask_features(augment.device_generator(torch.Generator(), "cpu"), x, 0.5)
    assert ((cols == 0).all(dim=0) | (cols == 1).all(dim=0)).all()  # whole columns
