"""The port's DeviceGraph against the JAX DeviceGraph: serving and sampler
tables equal bit for bit, the same backend choice. ``user_bitmap_fb`` and
``edge_bitmap_fb`` are compared on their first W + 8 columns: the JAX rows
are padded to 64 words (a TPU form the port drops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.graph.device import choose_backend as jax_choose_backend
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph, choose_backend

TINY = dict(n_users=60, n_items=100, n_interactions=2500, seed=3)
MID = dict(n_users=300, n_items=500, n_interactions=20_000, seed=7)
SERVE = dict(n_users=943, n_items=1682, n_interactions=100_000, seed=7)


def _bf16_as_f32(x_np):
    """f32 numpy R̂ cast to bf16 by JAX, widened back for comparison."""
    return np.asarray(jnp.asarray(x_np).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=[TINY, MID, SERVE], ids=["tiny", "mid", "serve"])
def graph_pair(request):
    """(port graph, JAX graph) from the same triples; SERVE is bench.py's shape."""
    train, test = make_synthetic_dataset(**request.param)
    ours = DeviceGraph(Interaction(train, test), compute_dtype="bfloat16", device="cpu")
    ref = JaxDeviceGraph(JaxInteraction(train, test), backend="dense")
    return ours, ref


def test_graph_tables_bit_identical(graph_pair):
    ours, ref = graph_pair
    assert (ours.n_users, ours.n_items, ours.n_nodes) == (ref.n_users, ref.n_items, ref.n_nodes)
    assert ours.backend == ref.backend == "dense"
    assert ours.max_degree == ref.max_degree and ours.has_pos_table == ref.has_pos_table
    pos, deg = ours.user_positives.numpy(), ours.user_degrees.numpy()
    assert pos.dtype == np.int32 and np.array_equal(pos, np.asarray(ref.user_positives))
    assert deg.dtype == np.int32 and np.array_equal(deg, np.asarray(ref.user_degrees))
    r_ours = ours.interaction_norm_dense.numpy()
    r_ref = np.asarray(ref.interaction_norm_dense)
    assert r_ours.dtype == np.float32 and np.array_equal(r_ours, r_ref)
    assert ours.propagation_matrix.dtype == torch.bfloat16
    assert np.array_equal(ours.propagation_matrix.float().numpy(), _bf16_as_f32(r_ref))


TRAINING_TABLES = ("edge_users", "edge_items", "edge_valid", "edge_ui", "csr_indptr",
                   "csr_items", "user_fallback_neg", "user_pos_bitmap", "user_pos_mask")
FLAGS = ("n_edges", "has_pos_bitmap", "has_edge_bitmap_fb", "has_pos_mask")


def test_training_tables_bit_identical(graph_pair):
    ours, ref = graph_pair
    for name in FLAGS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.has_pos_bitmap and ours.has_edge_bitmap_fb and ours.has_pos_mask
    for name in TRAINING_TABLES:
        got, want = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    width = ours.user_pos_bitmap.shape[1] + ours.user_fallback_neg.shape[1]
    for name in ("user_bitmap_fb", "edge_bitmap_fb"):
        got, want = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == (want.shape[0], width), name
        assert got.dtype == want.dtype and np.array_equal(got, want[:, :width]), name


def test_sampler_tables_without_bitmap():
    """Where the padded positives table is narrower than the bitmap, the
    bitmap and its fused rows are not built, as in the JAX package."""
    rng = np.random.default_rng(2)  # 40 users x 3 items over ~300 items: W = 10 > 3
    train = [[f"u{u}", f"i{i}", 1.0] for u in range(40)
             for i in rng.choice(300, size=3, replace=False)]
    ours = DeviceGraph(Interaction(train, []), device="cpu")
    ref = JaxDeviceGraph(JaxInteraction(train, []), backend="dense")
    assert ours.has_pos_bitmap == ref.has_pos_bitmap is False
    assert ours.has_edge_bitmap_fb == ref.has_edge_bitmap_fb is False
    assert tuple(ours.user_pos_bitmap.shape) == tuple(ours.edge_bitmap_fb.shape) == (1, 1)
    assert np.array_equal(ours.user_fallback_neg.numpy(), np.asarray(ref.user_fallback_neg))


def test_f32_regime_propagates_in_f32():
    train, test = make_synthetic_dataset(**TINY)
    g = DeviceGraph(Interaction(train, test), device="cpu")
    assert g.interaction_norm_bf16 is None
    assert g.propagation_matrix is g.interaction_norm_dense
    assert g.propagation_matrix.dtype == torch.float32


@pytest.mark.parametrize(
    "n_rows,n_cols,requested",
    [(10, 10, "auto"), (11_000, 11_000, "auto"), (12_000, 12_000, "auto"),
     (2, 3, "segment"), (2, 3, "dense")],
)
def test_choose_backend_agrees(n_rows, n_cols, requested):
    assert choose_backend(n_rows, n_cols, requested) == jax_choose_backend(n_rows, n_cols, requested)


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_unported_backends_raise(backend):
    """The segment and pallas backends are ported now
    (tests/test_torch_segment.py): the graph builds on them, with no R̂
    (that still raises, citing the ROADMAP); int8 propagation, which once
    raised here, builds on them now and runs f32 (tests/test_torch_int8.py)."""
    train, test = make_synthetic_dataset(**TINY)
    graph = DeviceGraph(Interaction(train, test), backend=backend, device="cpu")
    assert graph.backend == graph.norm_adj.backend == backend and graph.norm_adj.seg is not None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        graph.propagation_matrix  # noqa: B018
    g8 = DeviceGraph(Interaction(train, test), backend=backend, compute_dtype="int8", device="cpu")
    assert g8.norm_adj.compute_dtype == "int8" and g8.norm_adj.seg is not None


def test_bucketed_backend_builds():
    """The bucketed backend builds its pull tables (their parity with the
    JAX package is tests/test_torch_bucketed.py's) and has no R̂."""
    train, test = make_synthetic_dataset(**TINY)
    g = DeviceGraph(Interaction(train, test), backend="bucketed", device="cpu")
    assert g.backend == "bucketed" and g.interaction_norm_dense is None
    adj = g.norm_adj
    assert (adj.n_rows, adj.n_cols) == (g.n_nodes, g.n_nodes) and adj.sym_rowspace
    assert adj.pull.total_rows == adj.pull_t.total_rows == g.n_nodes  # no isolated node
    assert g.has_pos_table and g.user_positives.shape[0] == g.n_users


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    train, test = make_synthetic_dataset(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceGraph(Interaction(train, test))


def test_bad_compute_dtype_raises():
    train, test = make_synthetic_dataset(**TINY)
    with pytest.raises(ValueError):
        DeviceGraph(Interaction(train, test), compute_dtype="float16", device="cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_r_hat_rows_are_16_byte_aligned(compute_dtype):
    """The dense R̂ is a [U, I] view with a row stride padded to a multiple
    of 8 elements (16 bytes of bf16), the padding zero, for the chain
    kernel's 16-byte loads; its values are those of the unpadded R̂."""
    train, test = make_synthetic_dataset(**SERVE)
    g = DeviceGraph(Interaction(train, test), compute_dtype=compute_dtype, device="cpu")
    for r in (g.interaction_norm_dense, g.propagation_matrix):
        assert r.shape == (g.n_users, g.n_items) and r.stride(1) == 1
        assert r.stride(0) % 8 == 0 and 0 <= r.stride(0) - g.n_items < 8
        buf = torch.as_strided(r, (g.n_users, r.stride(0)), r.stride())
        assert torch.all(buf[:, g.n_items:] == 0)
    dense = g.interaction_norm_dense.contiguous()
    assert torch.equal(g.propagation_matrix.float(),
                       dense.to(g.propagation_matrix.dtype).float())
