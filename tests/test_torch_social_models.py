"""The social models (``models/diffnet.py``, ``sept.py``, ``mhcn.py``,
``esrf.py``) and ``losses.hierarchical_mim_loss`` on the CPU against the
JAX package's, on the dense, bucketed and segment backends.

Each model on the tiny set (60 users, 100 items, its synthesized trust
triples) at d = 8, L = 2, with the JAX parameters carried over by
``params_from_jax`` and one batch of 128 rows: the loss, every gradient and
the eval tables against the JAX model's (f32 rtol 1e-5; atol 1e-6, on
gradients relative to the JAX gradient's largest entry), on the dense and
segment backends the JAX model on the same backend. The port's bucketed
steps are held to the JAX model on the dense backend: the JAX package's
bucketed custom VJPs take 3-9 s a model to compile, and its bucketed
products are its dense ones up to the order of f32 sums. The
draws are the same on both sides: ``jax.random.uniform``, ``randint`` and
``permutation`` are replaced by numpy values (a uniform array per shape,
one segment start, permutations in call order) that the port's
``augment.uniform``, ``randint`` and ``permutation`` replay; SEPT's edge
mask is given to both as state. ESRF runs in each phase and, in phase 2,
in both ``alternating_updates`` modes. Each JAX step is jitted once per
model and backend, the state an argument (ESRF's three phases are one
``lax.switch``; ``sept_social`` is ``sept``'s step). ESRF's second mode
moves only where its gradients stop, through no product of the backend, so
its JAX reference runs on the dense backend for every backend of the port. Then ESRF's phase walk, its optimizer's two rates and its
zero generator gradients before phase 2, SEPT's warm-up gate and masks,
three epochs through ``GraphRecommender``, and the CLI: a social model
with no social file synthesizes one, ``synthesize-social`` writes the JAX
command's file byte for byte, and a social model serves from an ``.npz``
and from a checkpoint directory.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.losses as jl
import recommendation_tpu.sampling as js
from recommendation_tpu import cli as jax_cli
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.social_device import SocialDeviceGraph as JaxSocialDeviceGraph
from recommendation_tpu.models import get_model as jax_get_model
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import (
    flatten_tree,
    params_from_jax,
    save_params,
    state_from_jax,
)

TIGHT = dict(rtol=1e-5, atol=1e-6)
BACKENDS = ("dense", "bucketed", "segment")
SMALL = {"embedding.size": 8, "max.epoch": 6, "ESRF.segment": 20, "batch.size": 128}
BATCH = 128
START = 13  # ESRF's segment start on both sides (users 13..32 of 60)


def _np(x):
    return np.asarray(jax.device_get(x))


def _grad_atol(w):
    """The f32 atol 1e-6 on a gradient, relative to the JAX gradient's
    largest entry m where m > 1, cut to m/1000 where m < 1e-3 (so that the
    bound rejects a zero gradient)."""
    m = float(np.abs(w).max())
    return 1e-6 * (m if m > 1.0 else min(1.0, m / 1e-3))


class Draws:
    """Numpy draws for both sides: one uniform array per shape, START for
    every segment start, permutations in call order."""

    def __init__(self, seed):
        self.rng, self.uniforms, self.perms, self.pos = np.random.default_rng(seed), {}, [], 0

    def uniform(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self.uniforms:
            self.uniforms[shape] = self.rng.random(shape).astype(np.float32)
        return self.uniforms[shape]

    def patch_jax(self, mp):
        def permutation(key, n, *args, **kw):
            self.perms.append(self.rng.permutation(int(n)).astype(np.int32))
            return jnp.asarray(self.perms[-1])

        def randint(key, shape, minval, maxval, *args, **kw):
            assert int(minval) == 0 and int(maxval) > START
            return jnp.asarray(START, jnp.int32)

        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), *a, **kw: jnp.asarray(self.uniform(shape)))
        mp.setattr(jax.random, "randint", randint)
        mp.setattr(jax.random, "permutation", permutation)

    def patch_port(self, mp):
        def permutation(generator, n, device):
            self.pos += 1
            assert len(self.perms[self.pos - 1]) == n
            return torch.from_numpy(self.perms[self.pos - 1]).long().to(device)

        def randint(generator, high, device):
            assert high > START
            return torch.tensor(START, device=device)

        mp.setattr(augment, "uniform",
                   lambda generator, shape, device: torch.from_numpy(self.uniform(shape)))
        mp.setattr(augment, "randint", randint)
        mp.setattr(augment, "permutation", permutation)


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(tiny_data, tiny_social, data):
    """(port graph, JAX graph) per backend, built at first use."""
    cache = {}

    def get(backend):
        if backend not in cache:
            cache[backend] = (SocialDeviceGraph(data, tiny_social, backend=backend, device="cpu"),
                              JaxSocialDeviceGraph(tiny_data, tiny_social, backend=backend))
        return cache[backend]

    return get


@pytest.fixture(scope="module")
def batch(data):
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, n, BATCH).astype(np.int32)
              for n in (data.user_num, data.item_num, data.item_num)]
    return arrays + [np.ones(BATCH, np.float32)]


# case -> (model name, config overrides, state maker)
def _sept_state(jgraph, ssl_on):
    keep = (np.random.default_rng(8).random(jgraph.edge_valid.shape[0]) >= 0.3)
    return {"aug_keep": keep.astype(np.float32), "ssl_on": np.float32(ssl_on)}


CASES = {
    "diffnet": ("diffnet", {}, lambda g: {}),
    "sept": ("sept", {}, lambda g: _sept_state(g, 1.0)),
    "sept_warmup": ("sept_social", {}, lambda g: _sept_state(g, 0.0)),
    "sept_basic": ("sept_basic", {}, lambda g: {"aug_keep": _sept_state(g, 0)["aug_keep"]}),
    "mhcn": ("mhcn", {}, lambda g: {}),
    "esrf_phase0": ("esrf", {}, lambda g: {"phase": np.int32(0)}),
    "esrf_phase1": ("esrf", {}, lambda g: {"phase": np.int32(1)}),
    "esrf_phase2": ("esrf", {}, lambda g: {"phase": np.int32(2)}),
    "esrf_phase2_simple": ("esrf", {"ESRF.alternating_updates": False},
                           lambda g: {"phase": np.int32(2)}),
}


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted JAX value-and-grad per (model, overrides, backend), the
    state an argument; the draws it traced are kept beside it."""
    return {}


def _jax_step(jax_steps, graphs, batch, name, extra, backend, state):
    """(params, step, draws, eval tables) of the JAX model; the step's first
    call, on ``state``, traces it under the numpy draws."""
    key = ("sept" if name == "sept_social" else name, tuple(sorted(extra.items())), backend)
    if key not in jax_steps:
        _, jgraph = graphs(backend)
        jm = jax_get_model(name, jax_default_config(**{**SMALL, **extra}))
        params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
        draws = Draws(11)
        jbatch = js.PairwiseBatch(*map(jnp.asarray, batch))
        step = jax.jit(jax.value_and_grad(
            lambda p, s: jm.loss(p, s, jbatch, jgraph, jax.random.PRNGKey(2))[0]))
        with pytest.MonkeyPatch.context() as mp:
            draws.patch_jax(mp)
            step(params, state)
        evals = jax.jit(lambda p: jm.eval_embeddings(p, {}, jgraph))(params)
        jax_steps[key] = (params, step, draws, [_np(t) for t in evals])
    return jax_steps[key]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(jax_steps, graphs, batch, monkeypatch, case, backend):
    name, extra, make_state = CASES[case]
    graph, jgraph = graphs(backend)
    state_np = make_state(jgraph)
    jstate = jax.tree_util.tree_map(jnp.asarray, state_np)
    ref_backend = "dense" if extra or backend == "bucketed" else backend
    params, step, draws, want_eval = _jax_step(jax_steps, graphs, batch, name, extra,
                                               ref_backend, jstate)
    want, want_g = step(params, jstate)
    want_g = flatten_tree(jax.device_get(want_g))

    model = build(name, default_config(**{**SMALL, **extra}))
    ours, our_state = model.init(torch.Generator().manual_seed(0), graph)
    ref_names = flatten_tree(jax.device_get(params))
    assert set(ours) == set(ref_names)
    assert all(tuple(ours[k].shape) == ref_names[k].shape for k in ours)
    assert set(our_state) == set(state_np)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax(name, jax.device_get(params), device="cpu").items()}
    state = state_from_jax(name, state_np, device="cpu")
    draws.pos = 0
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, state, PairwiseBatch(*map(torch.from_numpy, batch)),
                                     graph, torch.Generator().manual_seed(0))
    assert new_state is state and draws.pos == len(draws.perms)
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for k, g in grads.items():
        w = _np(want_g[k])
        if name == "esrf" and k.startswith("g.") and int(state_np["phase"]) < 2:
            # the generator takes no gradient before the adversarial phase
            assert not g.abs().max() and not np.abs(w).max(), k
            continue
        if not np.abs(w).max():
            # a parameter the loss reaches only through its norm at 0 (MHCN's
            # fourth supervised gate's bias, which no channel uses)
            assert not g.abs().max(), k
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=_grad_atol(w), err_msg=k)
    for got, w in zip(model.eval_embeddings(p, state, graph), want_eval):
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), w, **TIGHT)


@pytest.mark.parametrize("n", [1, 37])
def test_hierarchical_mim_loss_matches_jax(monkeypatch, n):
    rng = np.random.default_rng(n)
    a, b = (rng.normal(size=(n, 6)).astype(np.float32) for _ in range(2))
    draws = Draws(3)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.value_and_grad(jl.hierarchical_mim_loss, argnums=(1, 2))(
            jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    assert len(draws.perms) == 3
    x, y = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        got = losses.hierarchical_mim_loss(torch.Generator(), x, y)
    np.testing.assert_allclose(got.item(), float(want), **TIGHT)
    for g, w in zip(torch.autograd.grad(got, (x, y)), want_g):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=_grad_atol(_np(w)))


def test_hierarchical_mim_loss_draws_on_the_device_generator(graphs, data):
    """Without patched draws the permutations come from the trainer's
    generator on the graph's device: two trainers of one seed give the
    same loss, and the generator moves on, so its next loss differs."""
    graph, _ = graphs("dense")
    x, y = torch.randn(20, 4), torch.randn(20, 4)
    got = []
    for _ in range(2):
        cfg = default_config(**{**SMALL, "seed": 4})
        rec = GraphRecommender(build("mhcn", cfg), data, cfg, graph=graph, log=Log(echo=False),
                               device="cpu")
        rec.build()
        assert rec._draws.device.type == graph.device.type
        got.append([losses.hierarchical_mim_loss(rec._draws, x, y) for _ in range(2)])
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    assert not torch.equal(got[0][0], got[0][1]) and torch.isfinite(got[0][0])


def test_esrf_phase_walk_matches_jax():
    for max_epoch in (3, 6, 9, 2):
        cfg = {**SMALL, "max.epoch": max_epoch}
        ours, ref = build("esrf", default_config(**cfg)), jax_get_model(
            "esrf", jax_default_config(**cfg))
        for epoch in range(max_epoch + 2):
            want = int(ref.epoch_begin(None, None, None, None, epoch)["phase"])
            assert ours.epoch_begin(None, None, None, None, epoch) == {"phase": want}
    assert [build("esrf", default_config(**{"max.epoch": 3})).phase_of(e)
            for e in range(3)] == [0, 1, 2]


def test_esrf_optimizer_groups(graphs):
    graph, _ = graphs("dense")
    model = build("esrf", default_config(**{**SMALL, "learning.rate": 2e-3}))
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    opt = model.make_optimizer(model.config, params)
    (d, g) = opt.param_groups
    assert d["lr"] == pytest.approx(2e-3) and g["lr"] == pytest.approx(1e-2)
    assert [id(t) for t in d["params"]] == [id(params["d.user_emb"]), id(params["d.item_emb"])]
    assert [id(t) for t in g["params"]] == [id(params["g.relation_emb"]),
                                            id(params["g.c_selector"])]


@pytest.mark.parametrize("name,warm", [("sept", True), ("sept_basic", False)])
def test_sept_epoch_masks_and_warmup_match_jax(graphs, monkeypatch, name, warm):
    """``epoch_begin`` on the same draws: the edge mask, and for SEPT the
    warm-up gate (SSL on once epoch > max.epoch · warmup_fraction)."""
    graph, jgraph = graphs("dense")
    ours, ref = (build(name, default_config(**SMALL)),
                 jax_get_model(name, jax_default_config(**SMALL)))
    seq = []

    def bernoulli(key, p=0.5, shape=None):
        seq.append(np.random.default_rng(len(seq)).random(tuple(shape)).astype(np.float32))
        return jnp.asarray(seq[-1]) < p

    on = []
    for epoch in range(SMALL["max.epoch"]):
        with monkeypatch.context() as mp:
            mp.setattr(jax.random, "bernoulli", bernoulli)
            want = ref.epoch_begin(None, None, jgraph, jax.random.PRNGKey(epoch), epoch)
        drawn = len(seq)
        with monkeypatch.context() as mp:
            mp.setattr(augment, "uniform",
                       lambda generator, shape, device: torch.from_numpy(seq[-1]))
            got = ours.epoch_begin(None, None, graph, torch.Generator().manual_seed(epoch), epoch)
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(got[k].numpy(), _np(want[k])), (epoch, k)
        if warm:
            on.append(float(got["ssl_on"]))
            assert drawn == sum(on)  # a mask is drawn only once SSL is on
    if warm:
        assert on == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]  # 6 · 1/3 = 2 warm-up epochs, then on


@pytest.mark.parametrize("name", ["diffnet", "sept", "mhcn", "esrf"])
def test_social_models_need_a_social_graph(data, name):
    from recommendation_tpu_torch.graph.device import DeviceGraph

    with pytest.raises(ValueError, match="SocialDeviceGraph"):
        build(name, default_config(**SMALL)).init(torch.Generator(),
                                                  DeviceGraph(data, backend="dense", device="cpu"))


def test_esrf_trains_through_its_phases(graphs, data):
    """Three epochs of ESRF through ``GraphRecommender``: phases 0, 1, 2 in
    turn, the generator moving only in phase 2, every loss finite."""
    graph, _ = graphs("dense")
    config = default_config(**{**SMALL, "max.epoch": 3, "eval.interval": 3})
    model = build("esrf", config)
    rec = GraphRecommender(model, data, config, graph=graph, log=Log(echo=False), device="cpu")
    rec.build()
    seen, g0 = [], rec.params["g.c_selector"].detach().clone()
    begin = model.epoch_begin

    def record(*args):
        state = begin(*args)
        seen.append((state["phase"], bool(torch.equal(rec.params["g.c_selector"], g0))))
        return state

    model.epoch_begin = record
    rec.train()
    assert seen == [(0, True), (1, True), (2, True)]
    assert not torch.equal(rec.params["g.c_selector"], g0)
    assert all(np.isfinite(e["loss"]) for e in rec.epoch_stats)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    path = tmp_path_factory.mktemp("social_set")
    train, test = make_synthetic_dataset(n_users=40, n_items=60, n_interactions=1200, seed=4)
    write_dataset(str(path), train, test)
    return path


def test_synthesize_social_cli_writes_the_jax_file(files, tmp_path):
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    args = ["synthesize-social", "--train", str(files / "train.txt"), "--top-k", "4"]
    assert cli.main(args + ["--out", str(ours)]) == 0
    assert jax_cli.main(args + ["--out", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes() and ours.stat().st_size > 0
    assert cli.main(["synthesize-social", "--train", str(tmp_path / "none.txt")]) == 2


def test_train_cli_synthesizes_missing_social(files, capsys):
    assert not os.path.exists(files / "social.txt")
    cli.main(["train", "--model", "diffnet", "--device", "cpu", "--train",
              str(files / "train.txt"), "--test", str(files / "test.txt"),
              "--set", "max.epoch=1", "--set", "embedding.size=8"])
    out, err = capsys.readouterr()
    assert "synthesizing" in err
    assert "Recall@20" in json.loads(out.strip().splitlines()[-1])


def test_social_model_serves_from_npz_and_checkpoint_dir(files, tmp_path):
    """``build_service`` with trust triples: from an ``.npz`` of the trained
    parameters and from the trainer's checkpoint directory, the served
    tables equal the trained model's eval tables."""
    from recommendation_tpu_torch.data.io import load_data
    from recommendation_tpu_torch.data.social import synthesize_social

    train, test = load_data(str(files / "train.txt")), load_data(str(files / "test.txt"))
    triples = synthesize_social(Interaction(train, test))
    config = default_config(**{**SMALL, "max.epoch": 1, "checkpoint.dir": str(tmp_path / "ck")})
    rec = cli.train_recommender("mhcn", config, train, test, device="cpu", social=triples)
    assert isinstance(rec.graph, SocialDeviceGraph)
    want = rec.model.eval_embeddings(rec.params, rec.state, rec.graph)
    save_params(str(tmp_path / "p.npz"), rec.params)
    for ckpt in (str(tmp_path / "p.npz"), str(tmp_path / "ck")):
        service = cli.build_service("mhcn", ckpt, default_config(**SMALL), train, test,
                                    device="cpu", social=triples)
        assert isinstance(service.graph, SocialDeviceGraph)
        for got, w in zip((service.user_emb, service.item_emb), want):
            np.testing.assert_allclose(got.numpy(), w.numpy(), **TIGHT)
