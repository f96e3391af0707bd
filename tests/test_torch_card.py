"""Kernel K1 (``csrc/chain_mean.cu``) against its plain version, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip. This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops.prop import chain_mean, chain_mean_plain

pytestmark = pytest.mark.cuda

# the JAX kernel's own test bounds (tests/test_pallas_prop.py)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _check_against_plain(r, u0, i0, n_layers, tol):
    before = chain_mean.launches
    got = chain_mean(r, u0, i0, n_layers)
    torch.cuda.synchronize()
    assert chain_mean.launches == before + n_layers
    want = chain_mean_plain(r, u0, i0, n_layers)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 53, 8), (5, 3, 130)])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_kernel_matches_plain_unaligned(card, dtype, shape, n_layers):
    """Random O(1) inputs at ragged shapes, as the JAX kernel's own test."""
    n_u, n_i, d = shape
    rng = np.random.default_rng(n_u + n_i + d + n_layers)
    r = torch.from_numpy(rng.normal(size=(n_u, n_i)).astype(np.float32) * 0.1).to(card, dtype)
    u0 = torch.from_numpy(rng.normal(size=(n_u, d)).astype(np.float32)).to(card)
    i0 = torch.from_numpy(rng.normal(size=(n_i, d)).astype(np.float32)).to(card)
    _check_against_plain(r, u0, i0, n_layers, TOL[dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 3])
def test_kernel_matches_plain_on_a_graph(card, compute_dtype, n_layers):
    """A real normalized R̂ (the propagation stays bounded, as in serving)
    with LightGCN's xavier init: f32 holds rtol 1e-5 / atol 1e-6 whatever
    the order of the sums."""
    train, test = make_synthetic_dataset(n_users=200, n_items=333, n_interactions=8000, seed=5)
    graph = DeviceGraph(Interaction(train, test), compute_dtype=compute_dtype, device=card)
    params, _ = build("lightgcn", default_config()).init(torch.Generator().manual_seed(1), graph)
    _check_against_plain(graph.propagation_matrix, params["user_emb"], params["item_emb"],
                         n_layers, TOL[graph.propagation_matrix.dtype])


def test_kernel_refuses_what_it_does_not_take(card):
    r = torch.zeros(4, 3, device=card)
    u0, i0 = torch.zeros(4, 2, device=card), torch.zeros(3, 2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        chain_mean(r.T.contiguous().T, u0, i0, 1)
    with pytest.raises(ValueError, match="devices"):
        chain_mean(r, u0.cpu(), i0, 1)
    with pytest.raises(TypeError):
        chain_mean(r.half(), u0, i0, 1)
