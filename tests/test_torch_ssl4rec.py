"""SSL4Rec (``models/ssl4rec.py``) and ``batch_softmax_loss`` on the CPU against
the JAX package's.

The loss, values and gradients with zero rows; the model with the JAX
parameters carried over (``weights.params_from_jax``, the towers' layers as
dotted names) and the same dropout draws on both sides (the JAX package's
``jax.random.bernoulli`` and the port's ``augment.uniform`` replaced by one
numpy stream): the init names and shapes, one loss and its gradients, the
eval tables; with one tower layer (the default) and with two; on the dense
and the bucketed backend (no graph in the loss). Then two epochs through
``GraphRecommender`` and the CLI. f32 rtol 1e-5 / atol 1e-6 (on gradients the
atol is relative to the JAX gradient's largest entry m where m > 1, and cut
to m/1000 where m < 1e-3, so that the bound rejects a zero gradient).
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
from recommendation_tpu.models.ssl4rec import SSL4Rec as JaxSSL4Rec
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.ssl4rec import SSL4Rec
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256, "SSL4Rec.out_dim": 32}


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


@pytest.mark.parametrize("n,d,tau", [(37, 8, 0.1), (64, 16, 0.5)])
def test_batch_softmax_loss_matches_jax(n, d, tau):
    rng = np.random.default_rng(n)
    u, i = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    u[2] = 0.0
    a, b = torch.from_numpy(u).requires_grad_(), torch.from_numpy(i).requires_grad_()
    got = losses.batch_softmax_loss(a, b, tau)
    want, want_g = jax.value_and_grad(lambda x, y: jl.batch_softmax_loss(x, y, tau),
                                      argnums=(0, 1))(jnp.asarray(u), jnp.asarray(i))
    np.testing.assert_allclose(got.item(), float(want), **TIGHT)
    for g, w in zip(torch.autograd.grad(got, (a, b)), want_g):
        assert torch.isfinite(g).all() and np.abs(_np(w)).max() > 1e-4
        np.testing.assert_allclose(g.numpy(), _np(w), **TIGHT)
    (g_zero,) = torch.autograd.grad(losses.batch_softmax_loss(a, b, tau), a)
    assert float(g_zero[2].abs().max()) == 0


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


@pytest.mark.parametrize("backend,extra", [
    ("dense", {}), ("bucketed", {}),
    ("dense", {"n.layers": 2, "SSL4Rec.hidden": 24, "SSL4Rec.alpha": 0.3, "SSL4Rec.drop": 0.3}),
])
def test_step_matches_jax(graphs, monkeypatch, backend, extra):
    jgraph, graph = graphs[backend]
    cfg = {**SMALL, **extra}
    jm = JaxSSL4Rec(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(7)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, state, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    want_g = flatten_tree(want_g)
    model = build("ssl4rec", default_config(**cfg))
    ours, _ = model.init(torch.Generator().manual_seed(0), graph)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("ssl4rec", jax.device_get(params), device="cpu").items()}
    ref_names = flatten_tree(jax.device_get(params))
    assert set(ours) == set(p) == set(ref_names)
    assert all(tuple(ours[k].shape) == ref_names[k].shape for k in ours)
    assert any(k.startswith("user_net.1.") for k in p) == ("n.layers" in extra)
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, {}, PairwiseBatch(*map(torch.from_numpy, arrays)), graph,
                                     torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq) == 2 and new_state == {}
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    for g, k in zip(torch.autograd.grad(loss, list(p.values())), p):
        w = _np(want_g[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_grad_atol(w),
                                   err_msg=k)
    for a, b in zip(model.eval_embeddings(p, {}, graph), jm.eval_embeddings(params, {}, jgraph)):
        assert a.shape[1] == cfg["SSL4Rec.out_dim"] and not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)


def test_config_matches_jax():
    for cfg in ({}, {"SSL4Rec.alpha": 0.2, "SSL4Rec.tau": 0.3, "SSL4Rec.drop": 0.5,
                     "n.layers": 3, "SSL4Rec.hidden": 64, "SSL4Rec.out_dim": 32}):
        a, b = SSL4Rec(default_config(**cfg)), JaxSSL4Rec(jax_default_config(**cfg))
        for attr in ("cl_rate", "tau", "drop", "n_layers", "hidden", "out_dim", "emb_size", "reg"):
            assert getattr(a, attr) == getattr(b, attr), attr
    assert SSL4Rec(default_config()).out_dim == 128


@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_trains_two_epochs(sets, backend):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "graph.backend": backend,
                            "item.ranking.topN": [20]})
    rec = GraphRecommender(build("ssl4rec", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert len(losses_) == 2 and losses_[1] < losses_[0] and all(np.isfinite(losses_))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", "ssl4rec", "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--device", "cpu"]
    assert cli.main(["train", *args]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args]) == 0
    (service,) = served
    assert service.user_emb.shape == (data.user_num, 128)
    scores, _ = service.recommend_ids([0, 1], 5)
    assert np.isfinite(scores).all()
