"""P2's work list and wrapper (``ops/segment.py::sum_schedule``,
``segment_sum``) on the CPU.

The kernel (``csrc/segment_sum.cu``) runs only on the card
(``tests/test_torch_card.py``); here the work list it walks is held to
what makes P2 equal P1 bit for bit: every slot in exactly one item, in
slot order, runs of at most ``CHUNK`` slots and ``SUM_ROWS`` rows, and a
row longer than ``CHUNK`` cut into the pieces P1 cuts it into, alike in a
whole view and in its cuts. ``sum_in_item_order`` replays the kernel's
order of operations in float32 over the work list, so the cuts' sums are
held bit for bit to the whole view's. On CPU tensors the wrapper is
``gather_sum_plain`` and counts no launch. The segment path's parity with
the JAX package (``test_adj_matmul_and_grad_match_jax``,
``test_step_matches_jax_on_segment``, ``test_segment_mean_matches_jax``)
runs through P2's wrapper in ``tests/test_torch_segment.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from recommendation_tpu_torch.ops import segment as seg_ops
from recommendation_tpu_torch.ops.gather import CHUNK, gather_sum, gather_sum_plain, pull_schedule
from recommendation_tpu_torch.ops.segment import SUM_ROWS, segment_sum, sum_schedule

D = 8


def _ptr(lens):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))


def _lengths(case):
    rng = np.random.default_rng(3)
    return {
        "empty": np.zeros(0, np.int64),
        "one_empty_row": np.zeros(1, np.int64),
        "empty_runs": np.concatenate([np.zeros(70, np.int64), [3], np.zeros(40, np.int64)]),
        "edges": np.array([0, 1, 127, 128, 129, 1000, 0, 0, 5, 256, 257]),
        "short": rng.integers(0, 20, 600),
        "hubs": np.concatenate([rng.integers(0, 9, 300), [4840], rng.integers(0, 300, 40)]),
    }[case]


@pytest.mark.parametrize("case", ["empty", "one_empty_row", "empty_runs", "edges", "short", "hubs"])
def test_sum_schedule_covers_every_slot_once_in_order(case):
    """Items cover the slots in order, each slot once; a run holds at most
    CHUNK slots and SUM_ROWS rows, whole rows only, the rows in order and
    each row once; a split row is P1's pieces, partials numbered alike."""
    lens = _lengths(case)
    ptr = _ptr(lens)
    work, start, n_partials = (t.numpy() if isinstance(t, torch.Tensor) else t
                               for t in sum_schedule(ptr))
    p1_work, p1_start, p1_partials = (t.numpy() if isinstance(t, torch.Tensor) else t
                                      for t in pull_schedule(ptr))
    assert work.dtype == np.int32 and work.shape[1] == 4 and start.dtype == np.int64
    assert start[0] == 0 and start[-1] == ptr[-1] and (np.diff(start) >= 0).all()
    assert len(start) == len(work) + 1 and n_partials == p1_partials
    run = work[:, 2] < 0
    sizes = np.diff(start)
    assert (sizes <= CHUNK).all()
    assert (work[run, 1] >= 1).all() and (work[run, 1] <= SUM_ROWS).all()
    assert (work[run, 3] == 0).all()
    # runs hold whole rows: their slot range is their rows' range
    r0, nr = work[run, 0], work[run, 1]
    assert (start[:-1][run] == ptr.numpy()[r0]).all()
    assert (start[1:][run] == ptr.numpy()[r0 + nr]).all()
    # every row once, in order: a run's rows, or all of a split row's pieces
    rows = np.concatenate([np.arange(a, a + b) for a, b in zip(r0, nr)] +
                          [work[~run & (work[:, 1] == 0), 0]]) if len(work) else np.zeros(0)
    assert sorted(rows.tolist()) == list(range(len(lens)))
    assert (np.diff(work[:, 0]) >= 0).all()
    # the split rows' items are P1's, in the same order
    split = p1_work[:, 3] > 1
    assert np.array_equal(work[~run], p1_work[split])
    assert np.array_equal(start[:-1][~run], p1_start[:-1][split])
    assert (lens[work[~run, 0]] > CHUNK).all() and (lens[r0] <= CHUNK).all()


def sum_in_item_order(src, idx, row_ptr, sums, val=None, post=None):
    """The kernel's arithmetic, item by item in float32: a run's rows each
    summed from 0 in slot order, a split row's pieces likewise into their
    partials, added in piece order; each times its row's scale."""
    src, idx, ptr = src.numpy(), idx.numpy(), row_ptr.numpy()
    val = None if val is None else val.numpy()
    post = np.ones(len(ptr) - 1, np.float32) if post is None else post.numpy()
    work, start, n_partials = (t.numpy() if isinstance(t, torch.Tensor) else t for t in sums)
    out = np.zeros((len(ptr) - 1, src.shape[1]), np.float32)
    partial = np.zeros((n_partials, src.shape[1]), np.float32)

    def run_sum(lo, hi):
        acc = np.zeros(src.shape[1], np.float32)
        for s in range(lo, hi):
            term = src[idx[s]] if val is None else np.float32(val[s]) * src[idx[s]]
            acc = acc + term
        return acc

    for (r, k, part, pieces), lo, hi in zip(work, start[:-1], start[1:]):
        if part < 0:
            for row in range(r, r + k):
                out[row] = run_sum(ptr[row], ptr[row + 1]) * post[row]
        else:
            partial[part + k] = run_sum(lo, hi)
            if k == pieces - 1:
                acc = partial[part]
                for c in range(1, pieces):
                    acc = acc + partial[part + c]
                out[r] = acc * post[r]
    return out


@pytest.fixture(scope="module")
def views():
    """A view whose rows hold 0, 1, 127, 128, 129 and 1,000 slots, runs of
    empty rows and short rows, the COO in no order, and its transpose."""
    rng = np.random.default_rng(11)
    lens = np.concatenate([[0, 1, 127, 128, 129, 1000], np.zeros(35, np.int64),
                           rng.integers(0, 12, 200), [300]])
    rows = np.repeat(np.arange(len(lens)), lens)
    rng.shuffle(rows)
    cols = rng.integers(0, 90, len(rows))
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    return seg_ops.segment_csr(r, c, len(lens), 90), seg_ops.segment_csr(c, r, 90, len(lens))


def _inputs(view, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((view.n_cols, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(view.n_slots).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(view.n_rows).astype(np.float32))
    return x, v, p


def test_item_order_is_p1s_order(views):
    """Summed in the work list's order, a view gives P1's arithmetic: each
    row from 0 in slot order (a split row by its pieces), the same float32
    sum whatever rows share an item; within f32 of the plain version."""
    view, _ = views
    x, v, p = _inputs(view, 1)
    got = sum_in_item_order(x, view.idx, view.row_ptr, view.sums, v, p)
    # P1's work list read as P2's: each row not split a run of its own
    w, s, n = pull_schedule(view.row_ptr)
    w = w.clone()
    solo = w[:, 3] == 1
    w[solo, 1], w[solo, 2], w[solo, 3] = 1, -1, 0
    want = sum_in_item_order(x, view.idx, view.row_ptr, (w, s, n), v, p)
    assert view.sums[2] == n and np.array_equal(got, want)
    plain = gather_sum_plain(x, view.idx, view.row_ptr, v, p).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_rows_sum_alike_in_a_view_and_its_cuts(views, parts):
    """A row's pieces depend on its length alone: in each ``row_range_view``
    of a cut the split rows' items are the whole view's, moved, and the
    rows sum to the whole view's bit for bit in the kernel's order; each
    ``rows_transpose_view`` is cut into P1's pieces of its own rows."""
    view, view_t = views
    x, v, p = _inputs(view, parts)
    whole = sum_in_item_order(x, view.idx, view.row_ptr, view.sums, v, p)
    work, start, _ = view.sums
    for lo, hi in seg_ops.row_cut(view.row_ptr, parts):
        cut = seg_ops.row_range_view(view, lo, hi)
        s0, s1 = int(view.row_ptr[lo]), int(view.row_ptr[hi])
        got = sum_in_item_order(x, cut.idx, cut.row_ptr, cut.sums, v[s0:s1], p[lo:hi])
        assert np.array_equal(got, whole[lo:hi])
        cw, cs, _ = cut.sums
        mine = (work[:, 2] >= 0) & (work[:, 0] >= lo) & (work[:, 0] < hi)
        assert np.array_equal(cw[cw[:, 2] >= 0][:, :2].numpy(),
                              (work[mine][:, :2] - torch.tensor([lo, 0], dtype=torch.int32)).numpy())
        assert np.array_equal(cs[:-1][cw[:, 2] >= 0].numpy(), (start[:-1][mine] - s0).numpy())
        t = seg_ops.rows_transpose_view(view_t, lo, hi)
        tw, ts, tn = t.sums
        pw, ps, pn = pull_schedule(t.row_ptr)
        split = pw[:, 3] > 1
        assert tn == pn and torch.equal(tw[tw[:, 2] >= 0], pw[split])
        assert torch.equal(ts[:-1][tw[:, 2] >= 0], ps[:-1][split])


@pytest.mark.parametrize("val,post", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["sum", "val", "post", "val_post"])
def test_wrapper_on_the_cpu_is_gather_sum_plain(views, val, post):
    """On CPU tensors ``segment_sum`` is ``gather_sum_plain`` over the
    view's rows (P1's wrapper gives the same), ``idx`` defaults to the
    view's, and no launch is counted."""
    view, _ = views
    x, v, p = _inputs(view, 7)
    v, p = (v if val else None), (p if post else None)
    before = segment_sum.launches, gather_sum.launches
    got = segment_sum(x, view, v, p)
    assert got.dtype == torch.float32 and got.shape == (view.n_rows, D)
    assert torch.equal(got, gather_sum_plain(x, view.idx, view.row_ptr, v, p))
    assert torch.equal(got, gather_sum(x, view.idx, view.row_ptr, val=v, post=p,
                                       schedule=view.schedule))
    ident = torch.arange(view.n_slots, dtype=torch.int32)
    slots = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (view.n_slots, D)).astype(np.float32))
    assert torch.equal(segment_sum(slots, view, v, p, idx=ident),
                       gather_sum_plain(slots, ident, view.row_ptr, v, p))
    assert (segment_sum.launches, gather_sum.launches) == before


def test_wrapper_refuses_what_p2_does_not_take(views):
    """P2 takes an f32 source, int32 indices, an int64 row pointer and f32
    values and scales of the view's shapes; none of P1's other sources or
    epilogues."""
    view, _ = views
    x, v, p = _inputs(view, 9)
    with pytest.raises(TypeError, match="float32 source"):
        segment_sum(x.bfloat16(), view)
    with pytest.raises(TypeError, match="float32 source"):
        segment_sum(x.to(torch.int8), view)
    with pytest.raises(TypeError, match="int32 idx"):
        segment_sum(x, view, idx=view.idx.long())
    with pytest.raises(TypeError, match="int64 row_ptr"):
        segment_sum(x, dataclasses.replace(view, row_ptr=view.row_ptr.int()))
    with pytest.raises(ValueError, match="val"):
        segment_sum(x, view, v[:-1])
    with pytest.raises(ValueError, match="post"):
        segment_sum(x, view, post=p.double())
    with pytest.raises(ValueError, match=r"src \[N, d\]"):
        segment_sum(x[:, 0], view)
    with pytest.raises(ValueError, match=r"idx \["):
        segment_sum(x, view, idx=view.idx[:-1])
    for epilogue in ("add", "acc", "final", "requant", "scale", "keep_y"):
        with pytest.raises(TypeError):
            segment_sum(x, view, **{epilogue: x})
