"""GRACE and G-BT (``models/grace.py``, ``models/gbt.py``), their losses and
G-BT's optimizer on the CPU against the JAX package's.

``grace_dual_branch_loss`` and ``barlow_twins_loss`` (the unbiased std, eps
outside it), values and gradients, with zero rows. Each model with the JAX
parameters carried over and the same draws on both sides (the JAX package's
``jax.random.bernoulli`` and the port's ``augment.uniform`` replaced by one
numpy stream: two edge dropouts over ``norm_adj_selfloops``, two feature
masks): the init names and shapes, one loss and its gradients, the eval
tables, on the dense backend, and on the bucketed backend against the JAX
package's bucketed graph (both put ``norm_adj_selfloops`` on the segment
backend there: P1 over its row-sorted views in the port). G-BT's learning rate over the first updates against
``optax.cosine_decay_schedule``, its parameters against ``optax.adam`` under
that schedule, and a run resumed from a checkpoint against a straight one.
Then two epochs through ``GraphRecommender`` and the CLI. f32 rtol 1e-5 /
atol 1e-6 (on gradients the atol is relative to the JAX gradient's largest
entry m where m > 1, and cut to m/1000 where m < 1e-3, so that the bound
rejects a zero gradient). G-BT's batch norm and standardization make its
f32 results noisy: each step also runs in float64 in the JAX package
(``jax.enable_x64``), and a gradient or eval table whose JAX f32 result lies
further than the atol from that is held at ``NOISE_FACTOR`` times that
distance.
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
from recommendation_tpu.models.gbt import GBT as JaxGBT
from recommendation_tpu.models.gbt import _batch_norm as jax_batch_norm
from recommendation_tpu.models.grace import GRACE as JaxGRACE
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.gbt import GBT, batch_norm
from recommendation_tpu_torch.models.grace import GRACE
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.loop import CosineDecayAdam
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256, "GRACE.proj_dim": 16}


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
def test_grace_and_barlow_losses_match_jax(n, d):
    rng = np.random.default_rng(n + d)
    z1, z2 = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    z1[0] = 0.0  # a zero row: the zero-safe normalization
    z2[5] = 0.0
    for name, ours, ref in (
        ("grace", lambda a, b: losses.grace_dual_branch_loss(a, b, 0.5),
         lambda a, b: jl.grace_dual_branch_loss(a, b, 0.5)),
        ("barlow", losses.barlow_twins_loss, jl.barlow_twins_loss),
        ("barlow_raw", lambda a, b: losses.barlow_twins_loss(a, b, 0.1, batch_norm=False),
         lambda a, b: jl.barlow_twins_loss(a, b, 0.1, batch_norm=False)),
    ):
        a, b = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
        got = ours(a, b)
        want, want_g = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
        np.testing.assert_allclose(got.item(), float(want), **TIGHT, err_msg=name)
        grads = torch.autograd.grad(got, (a, b))
        for g, w in zip(grads, want_g):
            w = _np(w)
            assert torch.isfinite(g).all() and np.abs(w).max() > 1e-3, name
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_grad_atol(w), err_msg=name)
        if name == "grace":
            assert float(grads[0][0].abs().max()) == 0.0


def test_batch_norm_is_biased_and_barlow_unbiased():
    """G-BT's batch norm divides by the biased variance; Barlow Twins
    standardizes by the unbiased std: swapping them changes both."""
    x = np.random.default_rng(0).normal(size=(9, 4)).astype(np.float32)
    np.testing.assert_allclose(batch_norm(torch.from_numpy(x)).numpy(),
                               _np(jax_batch_norm(jnp.asarray(x))), **TIGHT)
    biased = (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-5)
    np.testing.assert_allclose(batch_norm(torch.from_numpy(x)).numpy(), biased, **TIGHT)
    z = (x - x.mean(0)) / (x.std(0, ddof=1) + 1e-15)
    c = z.T @ z / 9
    want = np.sum((1 - np.diag(c)) ** 2) + np.sum((c - np.diag(np.diag(c))) ** 2) / 4
    t = torch.from_numpy(x)
    np.testing.assert_allclose(losses.barlow_twins_loss(t, t).item(), want, **TIGHT)


@pytest.fixture(scope="module")
def sets():
    from recommendation_tpu.data.interaction import Interaction as JaxInteraction

    train, test = make_hard_dataset(n_users=120, n_items=200, n_interactions=4000, seed=3)
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.fixture(scope="module")
def graphs(sets):
    jdata, data = sets
    return (JaxDeviceGraph(jdata, backend="dense"),
            DeviceGraph(data, backend="dense", device="cpu"))


@pytest.fixture(scope="module")
def bucketed_graphs(sets):
    jdata, data = sets
    return (JaxDeviceGraph(jdata, backend="bucketed"),
            DeviceGraph(data, backend="bucketed", device="cpu"))


JAX_MODELS = {"grace": JaxGRACE, "gbt": JaxGBT}
# G-BT's biases move every row by one constant, which the batch norm after
# conv1 and Barlow Twins' standardization after conv2 take out again: their
# exact gradient is 0
ZERO_GRADS = {"gbt": ("conv1.b", "conv2.b")}
# the JAX package's own f32 error (against its float64 evaluation) times this
# bounds the port's distance from it, where that error passes the f32 atol
NOISE_FACTOR = 4.0


def _atol(want, want64):
    """The f32 bound on one tensor: ``_grad_atol``, or NOISE_FACTOR times the
    JAX package's own f32 error where that is larger."""
    w = _np(want)
    return max(_grad_atol(w), NOISE_FACTOR * float(np.abs(w - want64).max()))


@pytest.mark.parametrize("name,extra", [
    ("grace", {}), ("grace", {"GRACE.num_layers": 3, "GRACE.hidden": 24, "GRACE.tau": 0.3}),
    ("gbt", {}), ("gbt", {"GBT.hidden": 24, "GBT.drop_edge": 0.5}),
])
def test_step_matches_jax(graphs, monkeypatch, name, extra):
    _step_against_jax(graphs, monkeypatch, name, extra)


@pytest.mark.parametrize("name", ["grace", "gbt"])
def test_step_matches_jax_on_bucketed(bucketed_graphs, monkeypatch, name):
    """The same step where the graph is bucketed: ``norm_adj_selfloops`` on
    the segment backend in both packages (the float64 reference runs the
    JAX package's segment sums in float64)."""
    jgraph, graph = bucketed_graphs
    assert graph.norm_adj_selfloops.backend == jgraph.norm_adj_selfloops.backend == "segment"
    _step_against_jax(bucketed_graphs, monkeypatch, name, {})


def _step_against_jax(graphs, monkeypatch, name, extra):
    jgraph, graph = graphs
    cfg = {**SMALL, **extra}
    jm = JAX_MODELS[name](jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(13)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, state, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    want_g = flatten_tree(want_g)
    with monkeypatch.context() as mp, jax.enable_x64(True):
        # the same step in float64: how far the JAX package's f32 result is
        # from the exact one (the f32 inputs widened)
        draws.replay_jax(mp)
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(_np(x), jnp.float64), params)
        g64 = flatten_tree(jax.device_get(jax.jit(jax.grad(lambda p: jm.loss(
            p, state, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(p64)))
        eval64 = [_np(t) for t in jax.jit(lambda p: jm.eval_embeddings(p, state, jgraph))(p64)]
    model = build(name, default_config(**cfg))
    ours, _ = model.init(torch.Generator().manual_seed(0), graph)
    ref_names = flatten_tree(jax.device_get(params))
    assert set(ours) == set(ref_names)
    assert all(tuple(ours[k].shape) == ref_names[k].shape for k in ours)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax(name, jax.device_get(params), device="cpu").items()}
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, {}, PairwiseBatch(*map(torch.from_numpy, arrays)), graph,
                                     torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq) == 4 and new_state == {}
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    largest = max(float(np.abs(_np(w)).max()) for w in want_g.values())
    for k, g in grads.items():
        w = _np(want_g[k])
        if k in ZERO_GRADS.get(name, ()):
            # f32 noise on both sides: the exact gradient is 0
            assert np.abs(g64[k]).max() < 1e-12 * largest
            assert max(float(g.abs().max()), float(np.abs(w).max())) < 1e-4 * largest, k
            continue
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_atol(w, g64[k]), err_msg=k)
    for a, b, b64 in zip(model.eval_embeddings(p, {}, graph),
                         jax.jit(lambda q: jm.eval_embeddings(q, {}, jgraph))(params), eval64):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=_atol(b, b64))


@pytest.mark.parametrize("name", ["grace", "gbt"])
def test_bucketed_backend_raises_with_the_item(sets, name):
    """Once these raised on the bucketed backend, citing the segment
    backend's item; they run there now, with ``norm_adj_selfloops`` built
    at init on the segment backend. int8 propagation, which once raised
    there citing item 15, builds now (tests/test_torch_int8.py)."""
    _, data = sets
    graph = DeviceGraph(data, backend="bucketed", device="cpu")
    params, _ = build(name, default_config(**SMALL)).init(torch.Generator().manual_seed(0), graph)
    assert graph._norm_adj_selfloops is not None and graph.norm_adj_selfloops.backend == "segment"
    assert graph.norm_adj_selfloops.seg is not None and params
    assert DeviceGraph(data, backend="bucketed", compute_dtype="int8",
                       device="cpu").norm_adj.compute_dtype == "int8"


def test_config_matches_jax():
    cfg = {"GRACE.num_layers": 3, "GRACE.hidden": 32, "GRACE.proj_dim": 8, "GRACE.tau": 0.2,
           "GRACE.drop_edge1": 0.1, "GRACE.drop_edge2": 0.2, "GRACE.drop_feat1": 0.3,
           "GRACE.drop_feat2": 0.4, "GBT.hidden": 48, "GBT.out_dim": 24, "GBT.drop_edge": 0.1,
           "GBT.drop_feat": 0.2, "GBT.total_steps": 77}
    for c in ({}, cfg):
        for ours, ref, attrs in (
            (GRACE, JaxGRACE, ("n_layers", "hidden", "proj_dim", "tau", "drop_edge1",
                               "drop_edge2", "drop_feat1", "drop_feat2")),
            (GBT, JaxGBT, ("hidden", "out_dim", "drop_edge", "drop_feat", "total_steps")),
        ):
            a, b = ours(default_config(**c)), ref(jax_default_config(**c))
            for attr in attrs:
                assert getattr(a, attr) == getattr(b, attr), attr
    assert GBT(default_config(**{"embedding.size": 64})).hidden == 128


# -- G-BT's cosine-decayed Adam -------------------------------------------------


def test_gbt_learning_rate_and_updates_match_optax():
    """The rate of update t is optax's schedule at t (the updates before
    it), past the decay too; the parameters follow optax.adam under it."""
    lr, steps = 3e-3, 5
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(6, 3)).astype(np.float32)
    grads = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(8)]
    grads[2] = np.zeros_like(w0)  # a step the NaN guard zeroed still counts
    schedule = optax.cosine_decay_schedule(lr, decay_steps=steps)
    opt = optax.adam(schedule)
    jw, jstate = jnp.asarray(w0), None
    jstate = opt.init(jw)
    w = torch.from_numpy(w0.copy()).requires_grad_()
    topt = build("gbt", default_config(**{"learning.rate": lr, "GBT.total_steps": steps})
                 ).make_optimizer(default_config(**{"learning.rate": lr}), {"w": w})
    assert isinstance(topt, CosineDecayAdam)
    for t, g in enumerate(grads):
        updates, jstate = opt.update(jnp.asarray(g), jstate, jw)
        jw = optax.apply_updates(jw, updates)
        w.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(topt.param_groups[0]["lr"], float(schedule(t)), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(w.detach().numpy(), _np(jw), **TIGHT)
    assert topt.param_groups[0]["schedule_count"] == len(grads)
    assert topt.param_groups[0]["lr"] == 0.0  # past the decay


def test_gbt_resumed_run_continues_the_decay(sets, tmp_path):
    """Two epochs straight, and one epoch then a resume from its
    checkpoint: the last checkpoints hold the same schedule position, rate
    and parameters, bit for bit."""
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    _, data = sets
    base = {**SMALL, "eval.interval": 1, "item.ranking.topN": [20], "GBT.total_steps": 100}
    runs = (("straight", 2), ("resumed", 1), ("resumed", 2))
    for where, epochs in runs:
        cfg = default_config(**{**base, "max.epoch": epochs,
                                "checkpoint.dir": str(tmp_path / where)})
        rec = GraphRecommender(build("gbt", cfg), data, cfg, log=Log(echo=False), device="cpu")
        rec.build()
        assert rec.start_epoch == (epochs - 1 if where == "resumed" else 0)
        rec.train()
    straight, resumed = (CheckpointManager(str(tmp_path / w)).restore_latest()
                         for w in ("straight", "resumed"))
    n_batches = -(-rec.graph.n_edges // SMALL["batch.size"])
    got, want = (p["optimizer"]["param_groups"][0] for p in (resumed, straight))
    assert got["schedule_count"] == want["schedule_count"] == 2 * n_batches
    assert got["lr"] == want["lr"] > 0
    for k, v in resumed["params"].items():
        assert torch.equal(v, straight["params"][k]), k


@pytest.mark.parametrize("name", ["grace", "gbt"])
def test_trains_two_epochs(sets, name):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "item.ranking.topN": [20]})
    rec = GraphRecommender(build(name, cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert len(losses_) == 2 and losses_[1] < losses_[0] and all(np.isfinite(losses_))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


@pytest.mark.parametrize("name", ["grace", "gbt"])
def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys, name):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", name, "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--device", "cpu"]
    assert cli.main(["train", *args]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args]) == 0
    (service,) = served
    assert np.isfinite(service.recommend_ids([0, 1], 5)[0]).all()


@pytest.mark.parametrize("name", ["grace", "gbt"])
def test_cli_trains_on_the_bucketed_backend(sets, tmp_path, capsys, name):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["train", "--model", name, "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=1", "--set", "graph.backend=bucketed", "--device", "cpu"]
    assert cli.main(args) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
