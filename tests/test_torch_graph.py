"""The port's DeviceGraph (serving subset) against the JAX DeviceGraph:
tables equal bit for bit, the same backend choice."""

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


@pytest.mark.parametrize("shape", [TINY, MID, SERVE], ids=["tiny", "mid", "serve"])
def test_graph_tables_bit_identical(shape):
    train, test = make_synthetic_dataset(**shape)
    ours = DeviceGraph(Interaction(train, test), compute_dtype="bfloat16", device="cpu")
    ref = JaxDeviceGraph(JaxInteraction(train, test), backend="dense")
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


@pytest.mark.parametrize("backend", ["bucketed", "segment", "pallas"])
def test_unported_backends_raise(backend):
    train, test = make_synthetic_dataset(**TINY)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceGraph(Interaction(train, test), backend=backend, device="cpu")


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
