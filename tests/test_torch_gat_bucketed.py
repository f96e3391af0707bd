"""The bucketed GAT's layers (``models/gat.py``) on the CPU against the
JAX package's: ``gat_layer_bucketed_sf`` (``AttentionPull`` over the bucket
rows of ``norm_adj.pull`` and ``pull_t``, with the slot maps), and the
per-bucket oracle ``gat_layer_bucketed`` with ``bucketed_row_nodes``:
values and gradients to x, w, a_src and a_dst, the attention dropout fed
from one numpy stream on both sides, through the kernel path's Function
and through autograd over the plain S1 and S2. Bounds as
tests/test_torch_gat.py's (its helpers and fixtures): rtol 1e-5, and the
float64 reference at ``NOISE_FACTOR`` times the larger of the f32 atol and
the JAX package's own f32 error.
"""

import numpy as np
import pytest

from recommendation_tpu.models import gat as jgat
from recommendation_tpu_torch.models import gat
from test_torch_gat import _check_layer, _np, graphs, sets  # noqa: F401 (fixtures)


@pytest.mark.parametrize("heads,drop", [(1, 0.0), (4, 0.0), (4, 0.3), (1, 0.5)])
@pytest.mark.parametrize("plain", [False, True], ids=["function", "plain"])
def test_gat_layer_bucketed_sf_matches_jax(graphs, monkeypatch, heads, drop, plain):
    jgraph, graph = graphs[0]["bucketed"], graphs[1]["bucketed"]
    jadj, adj = jgraph.norm_adj, graph.norm_adj
    jaux, aux = jgraph.ensure_gat_aux(), graph.ensure_gat_aux()
    _check_layer(
        monkeypatch,
        lambda x, w, a, b, rng, p: jgat.gat_layer_bucketed_sf(
            x, jadj.pull, jadj.pull_t, jaux, jgraph.n_nodes, w, a, b, heads, 0.2, rng, p),
        lambda x, w, a, b, g, p, pl: gat.gat_layer_bucketed_sf(
            x, adj.pull, adj.pull_t, aux, graph.n_nodes, w, a, b, heads, 0.2, g, p, plain=pl),
        graph.n_nodes, heads, drop, plain)


@pytest.mark.parametrize("heads,drop", [(2, 0.0), (2, 0.3)])
def test_gat_layer_bucketed_oracle_matches_jax(graphs, monkeypatch, heads, drop):
    jgraph, graph = graphs[0]["bucketed"], graphs[1]["bucketed"]
    jadj, adj = jgraph.norm_adj, graph.norm_adj
    jrows = jgat.bucketed_row_nodes(jadj.pull, jgraph.n_nodes)
    rows = gat.bucketed_row_nodes(adj.pull, graph.n_nodes)
    assert np.array_equal(rows.numpy()[:-1], _np(jrows)[:-1])
    _check_layer(
        monkeypatch,
        lambda x, w, a, b, rng, p: jgat.gat_layer_bucketed(
            x, jadj.pull, jrows, jgraph.n_nodes, w, a, b, heads, 0.2, rng, p),
        lambda x, w, a, b, g, p, pl: gat.gat_layer_bucketed(
            x, adj.pull, rows, graph.n_nodes, w, a, b, heads, 0.2, g, p),
        graph.n_nodes, heads, drop)
