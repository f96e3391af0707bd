"""NCL on the bucketed backend (``models/ncl.py``) on the CPU against the
JAX package's ``NCL`` on its bucketed graph: the loss and its gradients to
both tables with the same parameters, cluster state (the JAX E-step's) and
batch, both contrastive terms also at unit weight; the forward's L
``adj_matmul`` rounds with the context layer taken from the list; the
E-step's and the evaluation's embeddings through the bucketed chain; the
draws of an E-step at the large graph's table sizes; a short training run
and the CLI.

Tolerances as tests/test_torch_ncl.py's: the loss at rtol 1e-5 / atol 1e-6,
gradients at rtol 1e-5 with atol 1e-6 taken relative to the JAX gradient's
largest entry (f32; the frameworks sum in another order).
"""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.ncl import NCL as JaxNCL
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.lightgcn import lightgcn_propagate_square
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import params_from_jax, state_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256}
UNIT = {"NCL.ssl_reg": 1.0, "NCL.proto_reg": 1.0}


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(tiny_data, data):
    """(JAX bucketed graph, port bucketed graph, port dense graph)."""
    return (JaxDeviceGraph(tiny_data, backend="bucketed"),
            DeviceGraph(data, backend="bucketed", device="cpu"),
            DeviceGraph(data, backend="dense", device="cpu"))


def _batch(jgraph, seed=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    arrays = js.epoch_batches(k1, k2, jgraph, 256)
    return (js.PairwiseBatch(*(a[0] for a in arrays[:4])),
            PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in arrays[:4])))


@pytest.mark.parametrize("hyper_layers,weights", [(1, "unit"), (1, "default"), (2, "unit"),
                                                  (0, "default")])
def test_loss_and_grads_match_jax_on_bucketed(graphs, hyper_layers, weights):
    """hyper_layers 1 and 2 take layers 2 and 3 of the L = 3 rounds as the
    context; 0 takes layer 0 (its contrast cancels to f32 noise at unit
    weight, so it runs at the default weights only)."""
    jgraph, graph, _ = graphs
    cfg = {**SMALL, "NCL.hyper_layers": hyper_layers, **(UNIT if weights == "unit" else {})}
    jm = JaxNCL(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    state = jm.epoch_begin(params, state, jgraph, jax.random.PRNGKey(5), 0)
    jbatch, batch = _batch(jgraph)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jm.loss(p, state, jbatch, jgraph, jax.random.PRNGKey(2)), has_aux=True)(params)

    p = {k: v.requires_grad_() for k, v in
         params_from_jax("ncl", jax.device_get(params), device="cpu").items()}
    st = state_from_jax("ncl", jax.device_get(state), device="cpu")
    loss, _ = build("ncl", default_config(**cfg)).loss(p, st, batch, graph)
    grads = torch.autograd.grad(loss, list(p.values()))
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    for g, name in zip(grads, p):
        w = np.asarray(want_g[name])
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def test_forward_takes_the_context_from_the_rounds(graphs):
    """``_forward_ctx`` on the bucketed graph: the mean and layer 2 of
    ``lightgcn_propagate_square(return_layers=True)``, and the same
    values as the dense backend's K3 chain gives."""
    _, graph, dense = graphs
    model = build("ncl", default_config(**SMALL))
    params, _ = model.init(torch.Generator().manual_seed(3), dense)
    au, ai, initial, (cu, ci) = model._forward_ctx(params, graph)
    mu, mi, layers = lightgcn_propagate_square(params["user_emb"], params["item_emb"],
                                               graph.norm_adj, 3, return_layers=True)
    assert torch.equal(au, mu) and torch.equal(ai, mi)
    assert torch.equal(torch.cat([cu, ci]), layers[2])
    assert initial[0] is params["user_emb"] and initial[1] is params["item_emb"]
    for a, b in zip((au, ai, cu, ci), (*model._forward_ctx(params, dense)[:2],
                                       *model._forward_ctx(params, dense)[3])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_e_step_and_eval_take_the_bucketed_chain(graphs):
    """``epoch_begin`` clusters, and ``eval_embeddings`` returns, the mean of
    the bucketed chain (no autograd graph), equal to the dense backend's
    within f32 rounding."""
    _, graph, dense = graphs
    model = build("ncl", default_config(**SMALL))
    params, state = model.init(torch.Generator().manual_seed(4), dense)
    u, i = model.eval_embeddings(params, state, graph)
    assert not u.requires_grad and u.grad_fn is None
    for a, b in zip((u, i), model.eval_embeddings(params, state, dense)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    began = model.epoch_begin(params, state, graph, torch.Generator().manual_seed(8), 0)
    again = model.e_step(u, i, model.cluster_draws(torch.Generator().manual_seed(8), graph))
    assert all(torch.equal(began[k], again[k]) for k in began)


def test_e_step_draws_at_the_large_shape_match_jax_routing():
    """At 50,000 users and 100,000 items both tables stay at or under
    ``NCL.kmeans_minibatch_above`` (131,072): the port draws only k distinct
    initial rows per side (full Lloyd), as the JAX package's ``_cluster``
    routes them, with k = 100 each."""

    class Shape:
        n_users, n_items = 50_000, 100_000

    model, ref = build("ncl", default_config()), JaxNCL(jax_default_config())
    draws = model.cluster_draws(torch.Generator().manual_seed(0), Shape)
    for side, n in (("user", Shape.n_users), ("item", Shape.n_items)):
        init, batch = draws[side]
        k = ref._k_for(n)
        assert k == model._k_for(n) == 100
        minibatch = ref.kmeans_minibatch_above >= 0 and n > ref.kmeans_minibatch_above
        assert (batch is not None) == minibatch == False  # noqa: E712
        assert init.shape == (k,) and len(torch.unique(init)) == k
        assert int(init.min()) >= 0 and int(init.max()) < n


def test_trains_on_the_bucketed_backend(data):
    """The trainer's lifecycle with NCL on the bucketed backend: E-steps each
    epoch, a falling loss, finite metrics."""
    cfg = default_config(**{**SMALL, "max.epoch": 3, "eval.interval": 1,
                            "graph.backend": "bucketed", "item.ranking.topN": [20]})
    rec = GraphRecommender(build("ncl", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    assert rec.graph.backend == "bucketed"
    losses = [e["loss"] for e in rec.epoch_stats]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    assert rec.state["user_2cluster"].dtype == torch.int32


def test_cli_trains_ncl_on_the_bucketed_backend(data, tmp_path):
    from recommendation_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path), data.training_data, data.test_data)
    out = subprocess.run(
        [sys.executable, "-m", "recommendation_tpu_torch", "train", "--model", "ncl",
         "--device", "cpu", "--train", str(tmp_path / "train.txt"), "--test",
         str(tmp_path / "test.txt"), "--set", "graph.backend=bucketed", "--set", "max.epoch=2",
         "--set", "batch.size=512", "--set", "embedding.size=16"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
