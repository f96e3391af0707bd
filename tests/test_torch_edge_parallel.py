"""Edge-parallel propagation's views without a world (``ops/segment.py``:
``row_cut``, ``row_range_view``, ``rows_transpose_view``;
``graph/device.py``: ``shard_rows``, the shard on ``with_vals`` copies):
each rank's block of the row-sorted view put together is the whole view's
P1, the backward shares add up to the whole transpose pull, the cuts fall
on row boundaries and balance the slots, and a cut that leaves a row out
is caught. The world's cases (the trainer at (2, 1), the JAX package's
edge-sharded gradient) are in ``test_torch_parallel_trainer.py``.

The plain P1 sums a row's slots as the whole view's does, so the forward
blocks are held bit for bit here too; the shares of the backward are
summed over the ranks in another order than one pull sums them, and are
held to f32 rounding (rtol 1e-5, atol 1e-6 of the largest magnitude).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_tpu_torch.graph.device import from_scipy, shard_rows, with_vals
from recommendation_tpu_torch.ops.gather import CHUNK, gather_sum, pull_schedule
from recommendation_tpu_torch.ops.segment import (
    check_row_cut,
    row_cut,
    row_range_view,
    rows_transpose_view,
)

PARTS = (1, 2, 3, 4, 7)
D = 12
SHARE_TOL = dict(rtol=1e-5, atol=1e-6)


def _bipartite():
    """The tiny set's normalized bipartite adjacency (60 x 100 x 2500)."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset

    train, test = make_synthetic_dataset(n_users=60, n_items=100, n_interactions=2500, seed=3)
    return Interaction(train, test).norm_adj


def _hubs():
    """A rectangular matrix with empty rows and two hub rows longer than
    ``CHUNK`` (split into pieces by P1's schedule)."""
    rng = np.random.default_rng(5)
    n_rows, n_cols = 90, 400
    rows = rng.integers(0, n_rows, 1500)
    rows = np.concatenate([rows, np.full(3 * CHUNK + 17, 7), np.full(CHUNK + 1, 60)])
    rows[(rows > 20) & (rows < 26)] = 0  # empty rows 21..25
    cols = rng.integers(0, n_cols, len(rows))
    mat = sp.coo_matrix((rng.standard_normal(len(rows)).astype(np.float32), (rows, cols)),
                        shape=(n_rows, n_cols)).tocsr()
    mat.sum_duplicates()
    return mat


GRAPHS = {"bipartite": _bipartite, "hubs": _hubs}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def adj(request):
    return from_scipy(GRAPHS[request.param](), backend="segment", device="cpu")


def _pull(view, x, vals):
    return gather_sum(x, view.idx, view.row_ptr, val=vals[view.perm], schedule=view.schedule)


def _x(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32))


@pytest.mark.parametrize("parts", PARTS)
def test_rank_blocks_are_the_whole_pull(adj, parts):
    x = _x(adj.n_cols)
    whole = _pull(adj.seg, x, adj.vals)
    blocks = []
    for lo, hi in row_cut(adj.seg.row_ptr, parts):
        view = row_range_view(adj.seg, lo, hi)
        assert view.n_rows == hi - lo and view.n_cols == adj.n_cols
        assert torch.equal(view.row_ptr, adj.seg.row_ptr[lo:hi + 1] - adj.seg.row_ptr[lo])
        blocks.append(_pull(view, x, adj.vals))
    assert torch.equal(torch.cat(blocks), whole)


@pytest.mark.parametrize("parts", PARTS)
def test_backward_shares_sum_to_the_transpose_pull(adj, parts):
    g = _x(adj.n_rows, seed=1)
    whole = _pull(adj.seg_t, g, adj.vals)
    shares = []
    for lo, hi in row_cut(adj.seg.row_ptr, parts):
        view = rows_transpose_view(adj.seg_t, lo, hi)
        assert view.n_rows == adj.n_cols and view.n_cols == hi - lo
        shares.append(_pull(view, g[lo:hi].contiguous(), adj.vals))
    total = torch.stack(shares).sum(0)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=SHARE_TOL["rtol"],
                               atol=SHARE_TOL["atol"] * float(whole.abs().max()))


@pytest.mark.parametrize("parts", PARTS)
def test_transpose_views_split_the_slots(adj, parts):
    """The ranks' transpose views hold every slot of the transpose view once,
    each in its stable order, with the schedule P1 builds for its rows."""
    seen = []
    for lo, hi in row_cut(adj.seg.row_ptr, parts):
        view = rows_transpose_view(adj.seg_t, lo, hi)
        fwd_rows = view.idx.long() + lo
        assert bool(((fwd_rows >= lo) & (fwd_rows < hi)).all())
        work, start, n_partials = pull_schedule(view.row_ptr)
        assert torch.equal(view.work, work) and torch.equal(view.work_start, start)
        assert view.n_partials == n_partials
        seen.append(view.perm)
    perm = torch.cat(seen)
    assert torch.equal(torch.sort(perm).values, torch.sort(adj.seg_t.perm).values)
    for p in seen:  # each keeps the transpose view's order
        pos = torch.argsort(adj.seg_t.perm)[p]
        assert bool((pos[1:] > pos[:-1]).all())


@pytest.mark.parametrize("parts", PARTS)
def test_cut_falls_on_row_boundaries_and_balances_the_slots(adj, parts):
    ptr = adj.seg.row_ptr.numpy()
    ranges = row_cut(adj.seg.row_ptr, parts)
    assert len(ranges) == parts and ranges[0][0] == 0 and ranges[-1][1] == adj.n_rows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    longest = int(np.diff(ptr).max())
    target = ptr[-1] / parts
    slots = [int(ptr[hi] - ptr[lo]) for lo, hi in ranges]
    assert sum(slots) == ptr[-1]
    assert all(abs(s - target) <= longest for s in slots), (slots, target, longest)
    # each cut is the row boundary nearest its target
    for k, (lo, _) in enumerate(ranges[1:], start=1):
        want = k * ptr[-1] / parts
        assert abs(ptr[lo] - want) <= np.abs(ptr - want).min()


def test_cut_is_the_same_for_the_same_row_pointers():
    ptr = torch.tensor([0, 5, 5, 5, 9, 30, 31, 40], dtype=torch.int64)
    assert row_cut(ptr, 2) == row_cut(ptr.clone(), 2) == ((0, 5), (5, 7))
    assert row_cut(ptr, 1) == ((0, 7),)
    # equal boundaries (empty rows): the first of them
    assert row_cut(torch.tensor([0, 4, 4, 4, 8]), 2) == ((0, 1), (1, 4))


@pytest.mark.parametrize("fault", ["missing_row", "overlap", "short", "reversed"])
def test_a_cut_that_misses_a_row_is_caught(adj, fault):
    good = list(row_cut(adj.seg.row_ptr, 3))
    (a, b), (c, d), (e, f) = good
    bad = {"missing_row": [(a, b), (c + 1, d), (e, f)],
           "overlap": [(a, b + 1), (c, d), (e, f)],
           "short": [(a, b), (c, d), (e, f - 1)],
           "reversed": [(a, b), (c, c - 1), (c - 1, f)]}[fault]
    with pytest.raises(ValueError, match="row cut"):
        check_row_cut(bad, adj.seg.row_ptr)
    check_row_cut(good, adj.seg.row_ptr)
    if fault == "missing_row":  # the blocks put together lose the row
        x = _x(adj.n_cols)
        blocks = torch.cat([_pull(row_range_view(adj.seg, lo, hi), x, adj.vals)
                            for lo, hi in bad])
        assert blocks.shape[0] == adj.n_rows - 1


def test_shard_rides_with_vals_and_not_transpose(adj):
    sharded = shard_rows(adj, 3, 1)
    assert adj.shard is None  # the caller's adjacency keeps no shard
    lo, hi = sharded.shard.rows
    assert sharded.shard.ranges == row_cut(adj.seg.row_ptr, 3)
    binar = with_vals(sharded, (sharded.vals != 0).to(torch.float32))
    assert binar.shard is sharded.shard
    assert sharded.transpose().shard is None
    # the new values reach the rank's view in its slot order
    x = _x(adj.n_cols)
    want = _pull(binar.seg, x, binar.vals)[lo:hi]
    assert torch.equal(_pull(binar.shard.fwd, x, binar.vals), want)


def test_shard_wants_a_segment_adjacency():
    dense = from_scipy(_hubs(), backend="dense", device="cpu")
    with pytest.raises(ValueError, match="segment"):
        shard_rows(dense, 2, 0)
    with pytest.raises(ValueError, match="segment"):
        shard_rows(dataclasses.replace(from_scipy(_hubs(), backend="segment", device="cpu"),
                                       seg=None), 2, 0)


def test_with_norm_adj_leaves_the_graph_alone():
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
    from recommendation_tpu_torch.graph.device import DeviceGraph

    train, test = make_synthetic_dataset(n_users=60, n_items=100, n_interactions=2500, seed=3)
    graph = DeviceGraph(Interaction(train, test), backend="segment", device="cpu")
    placed = graph.with_norm_adj(shard_rows(graph.norm_adj, 2, 0))
    assert placed.norm_adj.shard is not None and graph.norm_adj.shard is None
    assert placed.edge_users is graph.edge_users and placed.n_nodes == graph.n_nodes
    assert placed.norm_adj.seg is graph.norm_adj.seg
