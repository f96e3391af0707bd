"""GCL (``models/gcl.py``, alias ``grace_rec``) and ``masked_info_nce`` on the
CPU against the JAX package's.

``masked_info_nce``, values and gradients, with zero rows. GCL with the JAX
parameters carried over and the same edge-dropout draws on both sides (the
JAX package's ``jax.random.bernoulli`` and the port's ``augment.uniform``
replaced by one numpy stream): the init names and shapes, one loss (the
symmetric InfoNCE over all users and all items, BPR and the squared row
regularizer) and its gradients, the eval tables (raw encodings); with the
graph encoder on the dense and the bucketed backend
(``normalized_bipartite``'s refreshed templates, P1's value path), the
bucketed one also against the port's dense backend, and with the linear
encoder. Then two epochs through ``GraphRecommender`` on both backends and
the CLI. f32 rtol 1e-5 / atol 1e-6 (on gradients the atol is relative to the
JAX gradient's largest entry m where m > 1, and cut to m/1000 where m < 1e-3,
so that the bound rejects a zero gradient).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.losses as jl
import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.gcl import GCL as JaxGCL
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.gcl import GCL
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256, "GCL.proj_dim": 16}


def _np(x):
    return np.asarray(jax.device_get(x))


def _grad_atol(w):
    """The f32 atol 1e-6 on a gradient, relative to the JAX gradient's
    largest entry m where m > 1 (f32 noise grows with the entries), cut to
    m/1000 of it where m < 1e-3 (so that the bound rejects zeros)."""
    m = float(np.abs(w).max())
    return 1e-6 * (m if m > 1.0 else min(1.0, m / 1e-3))


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


@pytest.mark.parametrize("n,m,d", [(37, 29, 8), (64, 64, 16)])
def test_masked_info_nce_matches_jax(n, m, d):
    rng = np.random.default_rng(n + m)
    a, s = rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(m, d)).astype(np.float32)
    a[1] = 0.0
    s[4] = 0.0
    pos = (rng.random((n, m)) < 0.1).astype(np.float32)
    pos[np.arange(n), np.arange(n) % m] = 1.0  # every anchor has a positive
    neg = ((rng.random((n, m)) < 0.6) & (pos == 0)).astype(np.float32)
    ta, ts = torch.from_numpy(a).requires_grad_(), torch.from_numpy(s).requires_grad_()
    got = losses.masked_info_nce(ta, ts, torch.from_numpy(pos), torch.from_numpy(neg), 0.2)
    want, want_g = jax.value_and_grad(
        lambda x, y: jl.masked_info_nce(x, y, jnp.asarray(pos), jnp.asarray(neg), 0.2),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(s))
    np.testing.assert_allclose(got.item(), float(want), **TIGHT)
    ga, gs = torch.autograd.grad(got, (ta, ts))
    for g, w in ((ga, want_g[0]), (gs, want_g[1])):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), _np(w), **TIGHT)
    assert float(ga[1].abs().max()) == 0 and float(gs[4].abs().max()) == 0


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


def _step(cfg, jgraph, graph, monkeypatch, seed=11):
    jm = JaxGCL(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(seed)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, state, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    model = build("gcl", default_config(**cfg))
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("gcl", jax.device_get(params), device="cpu").items()}
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, {}, PairwiseBatch(*map(torch.from_numpy, arrays)), graph,
                                     torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq) == 2 and new_state == {}
    return jm, params, flatten_tree(want_g), want, model, p, loss


@pytest.mark.parametrize("backend,extra", [
    ("dense", {}), ("bucketed", {}), ("dense", {"GCL.encoder": "linear"}),
    ("bucketed", {"GCL.num_layers": 3, "GCL.drop_edge": 0.4}),
])
def test_step_matches_jax(graphs, monkeypatch, backend, extra):
    jgraph, graph = graphs[backend]
    cfg = {**SMALL, **extra}
    jm, params, want_g, want, model, p, loss = _step(cfg, jgraph, graph, monkeypatch)
    ours, _ = model.init(torch.Generator().manual_seed(0), graph)
    ref_names = flatten_tree(jax.device_get(params))
    assert set(ours) == set(p) == set(ref_names)
    assert all(tuple(ours[k].shape) == ref_names[k].shape for k in ours)
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    linear = extra.get("GCL.encoder") == "linear"
    for g, k in zip(torch.autograd.grad(loss, list(p.values())), p):
        w = _np(want_g[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_grad_atol(w),
                                   err_msg=k)
    for a, b in zip(model.eval_embeddings(p, {}, graph), jm.eval_embeddings(params, {}, jgraph)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)
    assert any(k.startswith("convs.") for k in p) == linear


def test_bucketed_equals_dense(graphs, monkeypatch):
    *_, dense = _step(SMALL, *graphs["dense"], monkeypatch)
    *_, bucketed = _step(SMALL, *graphs["bucketed"], monkeypatch)
    np.testing.assert_allclose(bucketed.item(), dense.item(), **TIGHT)


def test_config_matches_jax():
    for cfg in ({}, {"GCL.num_layers": 3, "GCL.proj_dim": 32, "GCL.ssl_temp": 0.5,
                     "GCL.drop_edge": 0.1, "GCL.reg_weight": 0.01, "GCL.encoder": "linear"}):
        a, b = GCL(default_config(**cfg)), JaxGCL(jax_default_config(**cfg))
        for attr in ("n_layers", "proj_dim", "ssl_temp", "drop_edge", "reg_weight",
                     "encoder_kind", "emb_size"):
            assert getattr(a, attr) == getattr(b, attr), attr
    assert type(build("grace_rec", default_config())) is GCL


@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_trains_two_epochs(sets, backend):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "graph.backend": backend,
                            "item.ranking.topN": [20]})
    rec = GraphRecommender(build("gcl", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert len(losses_) == 2 and losses_[1] < losses_[0] and all(np.isfinite(losses_))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


@pytest.mark.parametrize("name", ["gcl", "grace_rec"])
def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys, name):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", name, "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--set", "graph.backend=bucketed", "--device", "cpu"]
    assert cli.main(["train", *args]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args]) == 0
    (service,) = served
    assert np.isfinite(service.recommend_ids([0, 1], 5)[0]).all()
