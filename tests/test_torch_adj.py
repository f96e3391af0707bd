"""The dense backend's ``DeviceAdj`` (``graph/device.py``) and the dense
branch of ``adj_matmul`` (``ops/spmm.py``) on the CPU against the JAX
package's: the COO bit for bit, the (U+I)² matrix built at first access,
``with_vals``, ``binarized``, ``densify`` and ``transpose`` (with and without
bucketed tables), the product in the f32 and the bf16 regime with its
gradient, and ``lightgcn_propagate``'s square branch over it.

Inputs are made with numpy from a seed. Tolerances: matrices and tables bit
for bit (the same values added at the same coordinates, each once);
products f32 rtol 1e-5 / atol 1e-6 (the frameworks sum in other orders).
In the bf16 regime both round the operands to bf16 the same way and sum the
exact products in f32, so the f32 bounds hold there too; gradients take
the bf16 bound of tests/test_pallas_prop.py (rtol 3e-2 / atol 3e-3
relative to the largest entry), since the frameworks round the cotangent
at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.graph.device import binarized as jax_binarized
from recommendation_tpu.graph.device import densify as jax_densify
from recommendation_tpu.graph.device import from_scipy as jax_from_scipy
from recommendation_tpu.graph.device import with_vals as jax_with_vals
from recommendation_tpu.models.lightgcn import lightgcn_propagate as jax_propagate
from recommendation_tpu.ops.spmm import adj_matmul as jax_adj_matmul
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import (
    DeviceGraph,
    binarized,
    densify,
    from_scipy,
    with_vals,
)
from recommendation_tpu_torch.models.lightgcn import lightgcn_propagate_square
from recommendation_tpu_torch.ops.spmm import adj_matmul

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(jax.device_get(x))


def _rect(seed=0, n_rows=45, n_cols=70, e=400):
    """A rectangular COO with duplicates summed, negative values and 13
    entries (not a multiple of the pad)."""
    rng = np.random.default_rng(seed)
    mat = sp.coo_matrix((rng.normal(size=e).astype(np.float32),
                         (rng.integers(0, n_rows, e), rng.integers(0, n_cols, e))),
                        shape=(n_rows, n_cols))
    mat.sum_duplicates()
    return sp.csr_matrix(mat)


@pytest.fixture(scope="module")
def adjs(tiny_data):
    """(port, JAX) dense norm_adj of tiny_data, and of a rectangular matrix."""
    return {"norm_adj": (from_scipy(tiny_data.norm_adj, backend="dense", device="cpu"),
                         jax_from_scipy(tiny_data.norm_adj, backend="dense")),
            "rect": (from_scipy(_rect(), backend="dense", device="cpu"),
                     jax_from_scipy(_rect(), backend="dense"))}


@pytest.mark.parametrize("which", ["norm_adj", "rect"])
def test_dense_adj_matches_jax(adjs, which):
    ours, ref = adjs[which]
    assert ours.backend == ref.backend == "dense" and ours.shape == ref.shape
    for name in ("rows", "cols", "vals"):
        got, want = getattr(ours, name).numpy(), _np(getattr(ref, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert ours._dense is None  # built at first access
    assert np.array_equal(ours.dense.numpy(), _np(ref.dense))
    assert ours.dense is ours.dense  # and kept
    assert ours.pull is None and not ours.sym_rowspace
    assert np.array_equal(densify(ours).numpy(), _np(jax_densify(ref)))


@pytest.mark.parametrize("which", ["norm_adj", "rect"])
def test_with_vals_and_binarized_match_jax(adjs, which):
    ours, ref = adjs[which]
    vals = np.random.default_rng(1).normal(size=ours.vals.shape[0]).astype(np.float32)
    for got, want in ((with_vals(ours, torch.from_numpy(vals)),
                       jax_with_vals(ref, jnp.asarray(vals))),
                      (binarized(ours), jax_binarized(ref))):
        assert np.array_equal(got.vals.numpy(), _np(want.vals))
        assert got._dense is None
        assert np.array_equal(got.dense.numpy(), _np(want.dense))
        assert np.array_equal(densify(got).numpy(), _np(jax_densify(want)))
    assert ours.dense is not None and not np.array_equal(binarized(ours).dense, ours.dense)
    assert set(np.unique(binarized(ours).dense.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("which", ["norm_adj", "rect"])
@pytest.mark.parametrize("built", [False, True], ids=["lazy", "built"])
def test_transpose_matches_jax(tiny_data, adjs, which, built):
    """Without bucketed tables the COO is re-sorted by its new rows (a
    stable sort in both); a matrix already built is carried over transposed,
    one not built yet is built from the transposed COO."""
    _, ref = adjs[which]
    ours = from_scipy(tiny_data.norm_adj if which == "norm_adj" else _rect(), backend="dense",
                      device="cpu")
    if built:
        ours.dense  # noqa: B018
    got, want = ours.transpose(), ref.transpose()
    assert got.shape == want.shape == (ours.n_cols, ours.n_rows)
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(got, name).numpy(), _np(getattr(want, name))), name
    assert (got._dense is not None) == built
    assert np.array_equal(got.dense.numpy(), _np(want.dense))
    back = got.transpose()
    assert np.array_equal(back.dense.numpy(), ours.dense.numpy())


def test_transpose_keeps_positions_with_bucketed_tables(tiny_data):
    ours = from_scipy(tiny_data.norm_adj, backend="bucketed", device="cpu")
    ref = jax_from_scipy(tiny_data.norm_adj, backend="bucketed")
    got, want = ours.transpose(), ref.transpose()
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(got, name).numpy(), _np(getattr(want, name))), name
    assert got.pull is ours.pull_t and got.pull_t is ours.pull and got.dense is None
    assert np.array_equal(densify(ours).numpy(), _np(jax_densify(ref)))
    raw = binarized(ours)
    assert raw.sym_rowspace and raw.pull.sep_dst is None  # refreshed values: the value path
    assert np.array_equal(densify(raw).numpy(), _np(jax_densify(jax_binarized(ref))))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["norm_adj", "rect"])
def test_adj_matmul_dense_matches_jax(adjs, tiny_data, which, compute_dtype):
    mat = tiny_data.norm_adj if which == "norm_adj" else _rect()
    ours = from_scipy(mat, backend="dense", compute_dtype=compute_dtype, device="cpu")
    ref = jax_from_scipy(mat, backend="dense", compute_dtype=compute_dtype)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(ours.n_cols, 12)).astype(np.float32)
    g = rng.normal(size=(ours.n_rows, 12)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    got = adj_matmul(ours, xt)
    (want, vjp) = jax.vjp(lambda v: jax_adj_matmul(ref, v), jnp.asarray(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TIGHT)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    (want_dx,) = vjp(jnp.asarray(g))
    w = _np(want_dx)
    rtol, atol = (1e-5, 1e-6) if compute_dtype == "float32" else (3e-2, 3e-3)
    np.testing.assert_allclose(dx.numpy(), w, rtol=rtol, atol=atol * np.abs(w).max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_square_propagate_matches_jax(tiny_data, compute_dtype, n_layers):
    """``lightgcn_propagate`` without R̂ (DirectAU's encoder) on the dense
    graph's ``norm_adj``: the mean, the layer list, and the gradient of a
    loss on the mean to both tables."""
    ours_g = DeviceGraph(Interaction(tiny_data.training_data, tiny_data.test_data),
                         backend="dense", compute_dtype=compute_dtype, device="cpu")
    ref_g = JaxDeviceGraph(tiny_data, backend="dense", compute_dtype=compute_dtype)
    rng = np.random.default_rng(n_layers)
    ue = rng.normal(size=(ours_g.n_users, 8)).astype(np.float32)
    ie = rng.normal(size=(ours_g.n_items, 8)).astype(np.float32)
    got = lightgcn_propagate_square(torch.from_numpy(ue), torch.from_numpy(ie),
                                    ours_g.norm_adj, n_layers, return_layers=True)
    want = jax_propagate(jnp.asarray(ue), jnp.asarray(ie), ref_g.norm_adj, n_layers,
                         return_layers=True)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    for a, b in zip(got[2], want[2], strict=True):
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    u, i = torch.from_numpy(ue).requires_grad_(), torch.from_numpy(ie).requires_grad_()
    mu, mi = lightgcn_propagate_square(u, i, ours_g.norm_adj, n_layers)
    loss = (mu.sin().sum() + (mi ** 2).sum())
    grads = torch.autograd.grad(loss, (u, i))
    want_g = jax.grad(lambda a, b: (lambda m: jnp.sin(m[0]).sum() + (m[1] ** 2).sum())(
        jax_propagate(a, b, ref_g.norm_adj, n_layers)), argnums=(0, 1))(jnp.asarray(ue),
                                                                        jnp.asarray(ie))
    rtol, atol = (1e-5, 1e-6) if compute_dtype == "float32" else (3e-2, 3e-3)
    for g, w in zip(grads, want_g):
        w = _np(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol * np.abs(w).max())


def test_dense_graph_builds_its_matrix_only_when_asked(tiny_data):
    """R̂-only models (LightGCN, NCL) never touch the square adjacency on the
    dense backend: neither its COO (uploaded at first access) nor its
    (U+I)² matrix (built at the first product)."""
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models import build

    graph = DeviceGraph(Interaction(tiny_data.training_data, tiny_data.test_data),
                        backend="dense", device="cpu")
    for name in ("lightgcn", "ncl"):
        model = build(name, default_config(**{"embedding.size": 8}))
        params, state = model.init(torch.Generator().manual_seed(0), graph)
        model.eval_embeddings(params, state, graph)
    assert graph._norm_adj is None
    assert graph.norm_adj.backend == "dense" and graph.norm_adj._dense is None
    assert graph.norm_adj.dense.shape == (graph.n_nodes, graph.n_nodes)
    assert graph._norm_adj_host is None  # the host matrix is dropped once uploaded


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_operand_is_rounded_once(tiny_data, compute_dtype):
    """``adj_matmul``'s dense operand: in the bf16 regime the matrix rounded
    to bf16 (kept in f32) at the first product and reused by every later
    one, its transpose carried by ``transpose`` and dropped by
    ``with_vals``; in f32 the matrix itself."""
    adj = from_scipy(tiny_data.norm_adj, backend="dense", compute_dtype=compute_dtype,
                     device="cpu")
    x = torch.ones(adj.n_cols, 3)
    first = adj_matmul(adj, x)
    operand = adj.dense_operand
    assert torch.equal(adj_matmul(adj, x), first) and adj.dense_operand is operand
    if compute_dtype == "float32":
        assert operand is adj.dense
        return
    assert operand.dtype == torch.float32
    assert torch.equal(operand, adj.dense.to(torch.bfloat16).float())
    assert not torch.equal(operand, adj.dense)  # the rounding is not a no-op here
    assert torch.equal(adj.transpose()._dense_operand, operand.T)
    assert with_vals(adj, adj.vals * 2)._dense_operand is None


def test_unported_backends_still_raise(tiny_data):
    """The segment and pallas backends are ported now
    (tests/test_torch_segment.py): what is not ported still raises, citing
    the ROADMAP (int8 propagation), and a backend the port does not know
    is refused."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_scipy(tiny_data.norm_adj, backend="segment", compute_dtype="int8", device="cpu")
    adj = from_scipy(tiny_data.norm_adj, backend="dense", device="cpu")
    import dataclasses
    with pytest.raises(ValueError, match="backend"):
        adj_matmul(dataclasses.replace(adj, backend="sparse"), torch.zeros(adj.n_cols, 2))
    with pytest.raises(ValueError, match="backend"):
        from_scipy(tiny_data.norm_adj, backend="sparse", device="cpu")
