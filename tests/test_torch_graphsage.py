"""GraphSAGE (``models/graphsage.py``) on the CPU against the JAX package's:
``bidirectional_edges`` bit for bit; ``masked_segment_mean`` (P1 over the
graph's destination view, P1 over the source view backward) against the
JAX package's on the gathered messages, values and gradients; the init's
names and shapes; one loss and its gradients with the JAX parameters carried
over and the same dropout masks on both sides (``jax.random.bernoulli`` and
the port's ``augment.uniform`` fed one numpy stream), on the dense, the
segment and the bucketed backends, BPR and BCE, fixed and learned features;
the fixed features left exactly as they were by training, the step loop
differentiating every parameter but the model's ``frozen`` ones; two epochs
through ``GraphRecommender``; the CLI's train and serve.

f32 rtol 1e-5 / atol 1e-6 (on gradients the atol is relative to the JAX
gradient's largest entry: the frameworks sum in other orders).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.graphsage import GraphSAGE as JaxGraphSAGE
from recommendation_tpu.models.graphsage import bidirectional_edges as jax_edges
from recommendation_tpu.models.graphsage import masked_segment_mean as jax_masked_mean
from recommendation_tpu_torch import cli
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.graphsage import (
    PlainGraphSAGE,
    bidirectional_edges,
    masked_segment_mean,
    masked_segment_mean_plain,
)
from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.loop import run_steps
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256, "GraphSAGE.hidden": 24,
         "GraphSAGE.in_dim": 12}


def _np(x):
    return np.asarray(jax.device_get(x))


def _grad_close(got, want, err_msg=""):
    w = _np(want)
    assert np.abs(w).max() > 0, err_msg
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                               err_msg=err_msg)


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


@pytest.fixture(scope="module")
def sets():
    from recommendation_tpu.data.interaction import Interaction as JaxInteraction

    train, test = make_hard_dataset(n_users=90, n_items=150, n_interactions=2500, seed=5)
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.fixture(scope="module")
def graphs(sets):
    jdata, data = sets
    return JaxDeviceGraph(jdata, backend="dense"), {
        b: DeviceGraph(data, backend=b, device="cpu") for b in ("dense", "segment", "bucketed")}


def test_bidirectional_edges_match_jax(graphs):
    jgraph, ours = graphs
    for graph in ours.values():
        for got, want in zip(bidirectional_edges(graph), jax_edges(jgraph)):
            assert np.array_equal(got.numpy(), _np(want).astype(got.numpy().dtype))
    # padded edges point at user 0 and item 0 with mask 0, both ways
    src, dst, mask = bidirectional_edges(ours["dense"])
    assert (mask.numpy() == 0).sum() == 2 * (ours["dense"].edge_valid.numpy() == 0).sum()


@pytest.mark.parametrize("backend", ["dense", "segment", "bucketed"])
def test_masked_segment_mean_matches_jax(graphs, backend):
    jgraph, ours = graphs
    graph = ours[backend]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(graph.n_nodes, 7)).astype(np.float32)
    c = rng.normal(size=(graph.n_nodes, 7)).astype(np.float32)
    src, dst, mask = jax_edges(jgraph)

    def ref(a):
        return jax_masked_mean(a[src], dst, mask, jgraph.n_nodes)

    want = ref(jnp.asarray(x))
    want_g = jax.grad(lambda a: jnp.sum(ref(a) * c))(jnp.asarray(x))
    by_src, by_dst = graph.bipartite_views()
    tsrc, tdst, tmask = bidirectional_edges(graph)
    for fn in (lambda a: masked_segment_mean(a, by_dst, by_src, tmask),
               lambda a: masked_segment_mean_plain(a, tsrc, tdst, tmask, graph.n_nodes)):
        xt = torch.from_numpy(x).requires_grad_()
        got = fn(xt)
        (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)), xt)
        np.testing.assert_allclose(got.detach().numpy(), _np(want), **TIGHT)
        _grad_close(g, want_g)


def test_init_matches_jax_layout(graphs):
    jgraph, ours = graphs
    jm = JaxGraphSAGE(jax_default_config(**SMALL))
    params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
    ref = flatten_tree(jax.device_get(params))
    got, state = build("graphsage", default_config(**SMALL)).init(
        torch.Generator().manual_seed(0), ours["dense"])
    assert state == {} and set(got) == set(params_from_jax("graphsage", ref, device="cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    assert abs(float(got["features"].std()) - 1.0) < 0.05  # N(0, 1) features


@pytest.mark.parametrize("backend", ["dense", "segment", "bucketed"])
@pytest.mark.parametrize("extra", [{}, {"loss": "bce"}, {"GraphSAGE.learned_features": True},
                                   {"GraphSAGE.n_layers": 3, "GraphSAGE.dropout": 0.5}],
                         ids=["bpr", "bce", "learned", "three_layers"])
def test_step_matches_jax(graphs, monkeypatch, backend, extra):
    jgraph, ours = graphs
    graph = ours[backend]
    cfg = {**SMALL, **extra}
    jm = JaxGraphSAGE(jax_default_config(**cfg))
    params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(11)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, {}, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    want_g = flatten_tree(want_g)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("graphsage", jax.device_get(params), device="cpu").items()}
    model = build("graphsage", default_config(**cfg))
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, _ = model.loss(p, {}, PairwiseBatch(*map(torch.from_numpy, arrays)), graph,
                             torch.Generator().manual_seed(0))
    n_layers = cfg.get("GraphSAGE.n_layers", 2)
    assert draws.pos == len(draws.seq) == n_layers - 1
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
    learned = extra.get("GraphSAGE.learned_features", False)
    for k, g in grads.items():
        if k == "features" and not learned:
            # stop_gradient: JAX's cotangent is zero, the port's is none
            assert g is None and not np.abs(_np(want_g[k])).any()
            continue
        _grad_close(g, want_g[k], k)
    for a, b in zip(model.eval_embeddings(p, {}, graph),
                    jm.eval_embeddings(params, {}, jgraph)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6 * np.abs(_np(b)).max())


def test_plain_model_matches_the_kernel_path(graphs):
    """``PlainGraphSAGE`` (autograd through the plain masked mean) against
    the model on the same draws: the reference ``chip_smoke.py`` holds the
    card's step to."""
    _, ours = graphs
    graph = ours["segment"]
    cfg = default_config(**SMALL)
    params, _ = build("graphsage", cfg).init(torch.Generator().manual_seed(0), graph)
    batch = PairwiseBatch(torch.arange(8), torch.arange(8), torch.arange(8, 16), torch.ones(8))
    out = []
    for model in (build("graphsage", cfg), PlainGraphSAGE(cfg)):
        p = {k: v.clone().requires_grad_() for k, v in params.items() if k != "features"}
        p["features"] = params["features"]
        loss, _ = model.loss(p, {}, batch, graph, torch.Generator().manual_seed(4))
        out.append((loss, torch.autograd.grad(loss, [v for k, v in p.items() if k != "features"])))
    np.testing.assert_allclose(out[0][0].item(), out[1][0].item(), **TIGHT)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * b.abs().max())


def test_training_leaves_fixed_features_and_learns(sets):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "item.ranking.topN": [20],
                            "graph.backend": "segment"})
    rec = GraphRecommender(build("graphsage", cfg), data, cfg, log=Log(echo=False), device="cpu")
    rec.build()
    assert not rec.params["features"].requires_grad
    assert all(v.requires_grad for k, v in rec.params.items() if k != "features")
    before = {k: v.detach().clone() for k, v in rec.params.items()}
    metrics = rec.execute()
    assert torch.equal(rec.params["features"], before["features"])
    assert not torch.equal(rec.params["layers.0.self.w"], before["layers.0.self.w"])
    losses = [e["loss"] for e in rec.epoch_stats]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


@pytest.mark.parametrize("learned", [False, True])
def test_step_loop_differentiates_every_parameter_but_the_frozen(sets, learned):
    """The step loop's gradient is strict: the trainer leaves out only the
    parameters the model names ``frozen`` (the fixed features), and a
    parameter that requires a gradient the loss does not reach is an
    error, not a silent skip."""
    _, data = sets
    cfg = default_config(**{**SMALL, "graph.backend": "segment",
                            "GraphSAGE.learned_features": learned})
    rec = GraphRecommender(build("graphsage", cfg), data, cfg, log=Log(echo=False), device="cpu")
    rec.build()
    assert rec.model.frozen == (() if learned else ("features",))
    assert rec.params["features"].requires_grad == learned
    batches = epoch_batches(epoch_words(torch.Generator().manual_seed(1), rec.graph, 256),
                            rec.graph, 256)
    before = rec.params["features"].detach().clone()
    run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, batches)
    assert torch.equal(rec.params["features"], before) != learned
    if not learned:
        rec.params["features"].requires_grad_()
        with pytest.raises(RuntimeError, match="not have been used"):
            run_steps(rec.model, rec.optimizer, rec.graph, rec.params, rec.state, batches)


def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", "graphsage", "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--device", "cpu"]
    assert cli.main(["train", *args]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args, "--set", "graph.backend=pallas"]) == 0
    (service,) = served
    assert np.isfinite(service.recommend_ids([0, 1], 5)[0]).all()
