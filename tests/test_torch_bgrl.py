"""BGRL (``models/bgrl.py``, alias ``bgrl_g2l``), ``bootstrap_g2l_loss`` and
the nested parameter trees of ``weights.py`` on the CPU against the JAX
package's.

The loss, values and gradients, with zero rows. BGRL with the JAX
parameters and target tree carried over (``online.convs.0.mlp1.w``,
``target.prelu``, ..) and the same draws on both sides (the JAX package's
``jax.random.bernoulli`` and the port's ``augment.uniform`` replaced by one
numpy stream): the init names and shapes, one loss and its gradients, the
whole-tree EMA of ``post_step``, the eval tables; on the dense backend and
the bucketed one (P1's value path over the binarized adjacency), which must
also agree with the port's dense backend. The nested tree through
``save_params``/``load_params`` and optax's nested Adam moments through
``opt_state_from_jax``. Then two epochs through ``GraphRecommender`` and the
CLI. f32 rtol 1e-5 / atol 1e-6 (on gradients the atol is relative to the
JAX gradient's largest entry m where m > 1, and cut to m/1000 where m < 1e-3,
so that the bound rejects a zero gradient). The GIN sums over the raw
adjacency and the batch norms make the model's f32 results noisy: the same
step runs in float64 in the JAX package (``jax.enable_x64``), and a
gradient or eval table whose JAX f32 result lies further than the atol from
that is held at ``NOISE_FACTOR`` times that distance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import recommendation_tpu.losses as jl
import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.bgrl import BGRL as JaxBGRL
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.bgrl import BGRL
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.loop import make_optimizer
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import (
    PARAM_NAMES,
    flatten_tree,
    load_params,
    opt_state_from_jax,
    params_from_jax,
    save_params,
    state_from_jax,
    subtree,
)

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256}
# the JAX package's own f32 error (against its float64 evaluation) times this
# bounds the port's distance from it, where that error passes the f32 atol
NOISE_FACTOR = 4.0


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

    def replay_jax(self, mp):
        it = iter(self.seq)
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.asarray(next(it)) < p)

    def patch_port(self, mp):
        def replay(generator, shape, device):
            self.pos += 1
            assert self.seq[self.pos - 1].shape == tuple(shape)
            return torch.from_numpy(self.seq[self.pos - 1]).to(device)

        mp.setattr(augment, "uniform", replay)


@pytest.mark.parametrize("n,d", [(37, 8), (64, 16)])
def test_bootstrap_g2l_loss_matches_jax(n, d):
    rng = np.random.default_rng(n + d)
    h1, h2 = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    g1, g2 = (rng.normal(size=(d,)).astype(np.float32) for _ in range(2))
    h1[3] = 0.0
    args = [torch.from_numpy(x).requires_grad_() for x in (h1, h2, g1, g2)]
    got = losses.bootstrap_g2l_loss(*args)
    want, want_g = jax.value_and_grad(jl.bootstrap_g2l_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (h1, h2, g1, g2)))
    np.testing.assert_allclose(got.item(), float(want), **TIGHT)
    grads = torch.autograd.grad(got, args, allow_unused=True)
    for g, w in zip(grads[:2], want_g[:2]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), _np(w), **TIGHT)
    assert grads[2] is None and grads[3] is None  # the targets are detached
    assert not np.abs(_np(want_g[2])).any() and float(grads[0][3].abs().max()) == 0
    zero = losses.bootstrap_g2l_loss(args[0], args[1], torch.zeros(d), torch.zeros(d))
    assert torch.isfinite(torch.autograd.grad(zero, args[0])[0]).all()


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


def _step(cfg, jgraph, graph, monkeypatch, seed=17, ref_graph=None):
    """One loss on both sides from the JAX init, the same draws and batch,
    and the JAX package's float64 gradients and eval tables on
    ``ref_graph`` (a dense JAX graph of the same data: the bucketed custom
    VJP is f32 only)."""
    jm = JaxBGRL(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(seed)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, state, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    with monkeypatch.context() as mp, jax.enable_x64(True):
        # the same step in float64: how far the JAX package's f32 result is
        # from the exact one (the f32 inputs widened)
        draws.replay_jax(mp)
        p64, s64 = (jax.tree_util.tree_map(lambda x: jnp.asarray(_np(x), jnp.float64), t)
                    for t in (params, state))
        ref_graph = jgraph if ref_graph is None else ref_graph
        g64 = jax.jit(jax.grad(lambda p: jm.loss(
            p, s64, js.PairwiseBatch(*map(jnp.asarray, arrays)), ref_graph,
            jax.random.PRNGKey(2))[0]))(p64)
        eval64 = [_np(t) for t in
                  jax.jit(lambda p: jm.eval_embeddings(p, s64, ref_graph))(p64)]
    model = build("bgrl", default_config(**cfg))
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("bgrl", jax.device_get(params), device="cpu").items()}
    st = state_from_jax("bgrl", jax.device_get(state), device="cpu")
    batch = PairwiseBatch(*map(torch.from_numpy, arrays))
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, st, batch, graph, torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq) == 4 and new_state is st
    return dict(jm=jm, params=params, state=state, want=want, want_g=flatten_tree(want_g),
                g64=flatten_tree(jax.device_get(g64)), eval64=eval64, model=model, p=p, st=st,
                loss=loss, batch=batch)


def _atol(want, want64):
    """The f32 bound on one tensor: ``_grad_atol``, or NOISE_FACTOR times the
    JAX package's own f32 error where that is larger."""
    w = _np(want)
    return max(_grad_atol(w), NOISE_FACTOR * float(np.abs(w - want64).max()))


@pytest.mark.parametrize("backend,extra", [
    ("dense", {}), ("bucketed", {}),
    ("dense", {"BGRL.num_layers": 3, "BGRL.hidden": 24, "BGRL.momentum": 0.9}),
])
def test_step_matches_jax(graphs, monkeypatch, backend, extra):
    jgraph, graph = graphs[backend]
    cfg = {**SMALL, **extra}
    r = _step(cfg, jgraph, graph, monkeypatch, ref_graph=graphs["dense"][0])
    p, model = r["p"], r["model"]
    ours, our_state = model.init(torch.Generator().manual_seed(0), graph)
    ref_names = flatten_tree(jax.device_get(r["params"]))
    assert set(ours) == set(p) == set(ref_names)
    assert all(tuple(ours[k].shape) == ref_names[k].shape for k in ours)
    assert ours["online.prelu"].shape == () and float(ours["online.prelu"]) == 0.25
    assert set(our_state) == {"target." + k for k in subtree(ours, "online")}
    np.testing.assert_allclose(r["loss"].item(), float(r["want"]), **TIGHT)
    largest = max(float(np.abs(_np(w)).max()) for w in r["want_g"].values())
    for g, k in zip(torch.autograd.grad(r["loss"], list(p.values())), p):
        w = _np(r["want_g"][k])
        if k == "online.proj.b":
            # the batch norm after the projection takes its bias out: the
            # exact gradient is 0, and both sides hold f32 noise
            assert np.abs(r["g64"][k]).max() < 1e-12 * largest
            assert max(float(g.abs().max()), float(np.abs(w).max())) < 1e-4 * largest, k
            continue
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_atol(w, r["g64"][k]),
                                   err_msg=k)
    # post_step on moved parameters: the whole-tree EMA, t·m + o·(1 - m)
    moved = {k: v.detach() + 0.01 for k, v in p.items()}
    jmoved = jax.tree_util.tree_map(lambda x: x + 0.01, r["params"])
    post = model.post_step(moved, r["st"], r["batch"])
    want_post = flatten_tree(jax.device_get(r["jm"].post_step(jmoved, r["state"], None)))
    assert set(post) == set(want_post)
    for k, v in post.items():  # the same inputs on both sides: the same bits
        np.testing.assert_array_equal(v.numpy(), want_post[k], err_msg=k)
    jeval = jax.jit(lambda q: r["jm"].eval_embeddings(q, r["state"], jgraph))(r["params"])
    for a, b, b64 in zip(model.eval_embeddings(p, r["st"], graph), jeval, r["eval64"]):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=_atol(b, b64))


def test_bucketed_equals_dense(graphs, monkeypatch):
    dense = _step(SMALL, *graphs["dense"], monkeypatch)
    bucketed = _step(SMALL, *graphs["bucketed"], monkeypatch, ref_graph=graphs["dense"][0])
    np.testing.assert_allclose(bucketed["loss"].item(), dense["loss"].item(), **TIGHT)
    adj = bucketed["model"]._adj(graphs["bucketed"][1])
    assert adj is bucketed["model"]._adj(graphs["bucketed"][1])  # built once per graph
    assert adj.sym_rowspace and adj.pull.sep_dst is None
    assert set(adj.vals.unique().tolist()) <= {0, 1}


def test_nested_tree_round_trip(graphs, tmp_path):
    _, graph = graphs["dense"]
    cfg = default_config(**{**SMALL, "BGRL.num_layers": 3})
    params, state = build("bgrl", cfg).init(torch.Generator().manual_seed(0), graph)
    path = str(tmp_path / "bgrl.npz")
    save_params(path, params)
    for name in ("bgrl", "bgrl_g2l"):
        loaded = load_params(path, name, device="cpu")
        assert set(loaded) == set(params)
        assert all(torch.equal(loaded[k], params[k]) for k in params)
    assert "online.convs.2.mlp2.b" in params and "target.convs.2.mlp2.b" in state
    with pytest.raises(ValueError, match="missing"):
        params_from_jax("bgrl", {"features": np.zeros((2, 2))}, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax("bgrl", {**{k: v.numpy() for k, v in params.items()}, "x": 1.0},
                        device="cpu")
    assert PARAM_NAMES["bgrl"][0] == "features"


def test_opt_state_from_jax_takes_nested_moments(graphs, monkeypatch):
    """optax's Adam over the nested JAX tree carried into torch's Adam over
    the flat names: one more step on each side lands on the same values."""
    jgraph, graph = graphs["dense"]
    r = _step(SMALL, jgraph, graph, monkeypatch)
    opt = optax.adam(1e-2)
    jstate = opt.init(r["params"])
    updates, jstate = opt.update(jax.tree_util.tree_map(jnp.ones_like, r["params"]), jstate)
    jparams = optax.apply_updates(r["params"], updates)
    p = {k: v.detach().clone().requires_grad_() for k, v in
         params_from_jax("bgrl", jax.device_get(jparams), device="cpu").items()}
    topt = make_optimizer(default_config(**{"learning.rate": 1e-2}), p)
    topt.load_state_dict(opt_state_from_jax(jax.device_get(jstate), p, lr=1e-2))
    grads = jax.tree_util.tree_map(lambda x: 0.5 * x, r["params"])
    updates, _ = opt.update(grads, jstate)
    want = flatten_tree(jax.device_get(optax.apply_updates(jparams, updates)))
    flat_grads = flatten_tree(jax.device_get(grads))
    for k, v in p.items():
        v.grad = torch.tensor(np.asarray(flat_grads[k]))
    topt.step()
    for k, v in p.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], **TIGHT, err_msg=k)


def test_config_matches_jax():
    for cfg in ({}, {"BGRL.num_layers": 3, "BGRL.hidden": 32, "BGRL.momentum": 0.5,
                     "BGRL.drop_edge": 0.1, "BGRL.drop_feat": 0.2}):
        a, b = BGRL(default_config(**cfg)), JaxBGRL(jax_default_config(**cfg))
        for attr in ("n_layers", "hidden", "momentum", "drop_edge", "drop_feat"):
            assert getattr(a, attr) == getattr(b, attr), attr
    assert type(build("bgrl_g2l", default_config())) is BGRL


@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_trains_two_epochs(sets, backend):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "graph.backend": backend,
                            "item.ranking.topN": [20]})
    rec = GraphRecommender(build("bgrl", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert len(losses_) == 2 and losses_[1] < losses_[0] and all(np.isfinite(losses_))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    assert all(torch.isfinite(v).all() for v in rec.state.values())


@pytest.mark.parametrize("name,backend", [("bgrl", "dense"), ("bgrl_g2l", "bucketed")])
def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys, name, backend):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", name, "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--set", f"graph.backend={backend}", "--device", "cpu"]
    assert cli.main(["train", *args, "--set", f"checkpoint.dir={tmp_path / 'ckpt'}"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args, "--checkpoint", str(tmp_path / "ckpt")]) == 0
    (service,) = served
    assert np.isfinite(service.recommend_ids([0, 1], 5)[0]).all()
