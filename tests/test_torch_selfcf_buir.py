"""SelfCF and BUIR (``models/selfcf.py``, ``models/buir.py``) and their losses
on the CPU against the JAX package's.

The losses ``cosine_bootstrap_loss``, ``selfcf_loss`` and ``buir_loss``,
values and gradients, with zero rows. Each model with the JAX parameters and
state carried over (``weights.params_from_jax``/``state_from_jax``) and the
same random draws on both sides (the JAX package's
``jax.random.uniform``/``bernoulli`` and the port's ``augment.uniform``
replaced by one numpy stream, in call order): the init names and shapes, one
loss and its gradients, the new state (SelfCF's histories) and the
``post_step`` state (BUIR's targets), the width-2d eval tables; on the dense
backend in f32 and bf16 and on the bucketed one, which must also agree with
the port's dense backend. Then two epochs through ``GraphRecommender`` and
the CLI's train and serve.

Tolerances: f32 rtol 1e-5 / atol 1e-6 (on gradients the atol is relative to
the JAX gradient's largest entry m where m > 1, and cut to m/1000 where m <
1e-3, so that the bound rejects a zero gradient); bf16 the bound of
tests/test_pallas_prop.py (rtol 2e-2 / atol 2e-3 on values, 3e-2 / 3e-3 on
gradients).
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
from recommendation_tpu.models.buir import BUIR as JaxBUIR
from recommendation_tpu.models.selfcf import SelfCF as JaxSelfCF
from recommendation_tpu_torch import cli, losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.buir import BUIR
from recommendation_tpu_torch.models.selfcf import SelfCF
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax, state_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256}


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(got, want, bf16=False, grad=False, what=""):
    w = _np(want)
    rtol, atol = ((3e-2, 3e-3) if grad else (2e-2, 2e-3)) if bf16 else (1e-5, 1e-6)
    if grad:  # relative to the largest entry m where m > 1, cut to m/1000 below 1e-3
        m = float(np.abs(w).max())
        atol *= m if m > 1.0 else min(1.0, m / 1e-3)
    np.testing.assert_allclose(got.detach().cpu().numpy(), w, rtol=rtol, atol=atol,
                               err_msg=what)


class Draws:
    """One stream of numpy uniforms for both frameworks: the JAX side's
    ``jax.random.uniform``/``bernoulli`` calls record it, the port's
    ``augment.uniform`` calls replay it in the same order and shapes."""

    def __init__(self, seed):
        self.rng, self.seq, self.pos = np.random.default_rng(seed), [], 0

    def _next(self, shape):
        u = self.rng.random(tuple(shape)).astype(np.float32)
        self.seq.append(u)
        return u

    def patch_jax(self, mp):
        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), *a, **k: jnp.asarray(self._next(shape)))
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.asarray(self._next(shape)) < p)

    def patch_port(self, mp):
        def replay(generator, shape, device):
            u = self.seq[self.pos]
            assert u.shape == tuple(shape), (u.shape, shape)
            self.pos += 1
            return torch.from_numpy(u).to(device)

        mp.setattr(augment, "uniform", replay)


# -- losses ---------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(37, 8), (64, 16)])
def test_bootstrap_losses_and_grads_match_jax(n, d):
    rng = np.random.default_rng(n + d)
    xs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(4)]
    xs[0][0] = 0.0  # zero rows: the zero-safe normalization, gradient 0
    xs[1][3] = 0.0
    for name, ours, ref in (
        ("cosine", lambda a, b, c, e: losses.cosine_bootstrap_loss(a, b),
         lambda a, b, c, e: jl.cosine_bootstrap_loss(a, b)),
        ("selfcf", losses.selfcf_loss, jl.selfcf_loss),
        ("buir", losses.buir_loss, jl.buir_loss),
    ):
        ts = [torch.from_numpy(x).requires_grad_() for x in xs]
        got = ours(*ts)
        want, want_g = jax.value_and_grad(ref, argnums=(0, 1, 2, 3))(*map(jnp.asarray, xs))
        np.testing.assert_allclose(got.item(), float(want), **TIGHT, err_msg=name)
        grads = torch.autograd.grad(got, ts, allow_unused=True)
        for i, (g, w) in enumerate(zip(grads, want_g)):
            g = torch.zeros(n, d) if g is None else g
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), _np(w), **TIGHT, err_msg=f"{name} {i}")
        g0 = grads[0]
        assert float(g0[0].abs().max()) == 0.0 and float(g0.abs().max()) > 1e-4, name


# -- the models against the JAX package ---------------------------------------------


@pytest.fixture(scope="module")
def sets():
    from recommendation_tpu.data.interaction import Interaction as JaxInteraction

    train, test = make_hard_dataset(n_users=120, n_items=200, n_interactions=4000, seed=3)
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.fixture(scope="module")
def graphs(sets):
    jdata, data = sets
    return {(b, t): (JaxDeviceGraph(jdata, backend=b, compute_dtype=t),
                     DeviceGraph(data, backend=b, compute_dtype=t, device="cpu"))
            for b, t in (("dense", "float32"), ("dense", "bfloat16"), ("bucketed", "float32"))}


def _batch(jgraph, dup=False):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    if dup:  # every id twice: the history and target writes see duplicates
        arrays = [np.concatenate([a[:128], a[:128]]) for a in arrays]
    return (js.PairwiseBatch(*map(jnp.asarray, arrays)),
            PairwiseBatch(*(torch.from_numpy(a) for a in arrays)))


JAX_MODELS = {"selfcf": JaxSelfCF, "buir": JaxBUIR}


def _step(name, cfg, jgraph, graph, monkeypatch, seed=5, dup=False):
    """One loss on both sides from the JAX init, the same draws and batch."""
    jm = JAX_MODELS[name](jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    jbatch, batch = _batch(jgraph, dup)
    draws = Draws(seed)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        (want, want_state), want_g = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, state, jbatch, jgraph, jax.random.PRNGKey(2)),
            has_aux=True))(params)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax(name, jax.device_get(params), device="cpu").items()}
    st = state_from_jax(name, jax.device_get(state), device="cpu")
    before = {k: v.clone() for k, v in st.items()}
    model = build(name, default_config(**cfg))
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, new_state = model.loss(p, st, batch, graph, torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq)
    for k in st:  # the old state is not written in place
        assert torch.equal(st[k], before[k]), k
    return dict(jm=jm, params=params, state=state, jbatch=jbatch, batch=batch, want=want,
                want_state=want_state, want_g=flatten_tree(want_g), model=model, p=p, st=st,
                loss=loss, new_state=new_state)


CASES = [("selfcf", "dense", "float32"), ("selfcf", "dense", "bfloat16"),
         ("selfcf", "bucketed", "float32"), ("buir", "dense", "float32"),
         ("buir", "dense", "bfloat16"), ("buir", "bucketed", "float32")]


@pytest.mark.parametrize("name,backend,dtype", CASES)
def test_step_matches_jax(graphs, monkeypatch, name, backend, dtype):
    jgraph, graph = graphs[backend, dtype]
    bf16 = dtype == "bfloat16"
    r = _step(name, SMALL, jgraph, graph, monkeypatch)
    p, model = r["p"], r["model"]
    # init: the same names and shapes as the JAX init
    ours, _ = model.init(torch.Generator().manual_seed(0), graph)
    want_names = flatten_tree(jax.device_get(r["params"]))
    assert set(ours) == set(want_names) == set(p)
    assert all(tuple(ours[k].shape) == want_names[k].shape for k in ours)
    _close(r["loss"], r["want"], bf16, what="loss")
    for g, k in zip(torch.autograd.grad(r["loss"], list(p.values())), p):
        assert float(np.abs(_np(r["want_g"][k])).max()) > 0, k
        _close(g, r["want_g"][k], bf16, grad=True, what=k)
    want_state = flatten_tree(jax.device_get(r["want_state"]))
    assert set(r["new_state"]) == set(want_state)
    for k, v in r["new_state"].items():
        _close(v, want_state[k], bf16, what=k)
    if name == "selfcf":
        # rows outside the batch keep their bits; the batch's rows are the online rows
        u_on, _ = model.propagate(p, graph)
        users = r["batch"].users.long()
        touched = torch.zeros(graph.n_users, dtype=torch.bool)
        touched[users] = True
        assert torch.equal(r["new_state"]["u_his"][~touched], r["st"]["u_his"][~touched])
        assert torch.equal(r["new_state"]["u_his"][users], u_on[users].detach())
    else:
        post = model.post_step(p, r["st"], r["batch"])
        want_post = flatten_tree(jax.device_get(r["jm"].post_step(r["params"], r["state"],
                                                                  r["jbatch"])))
        for k, v in post.items():
            np.testing.assert_allclose(v.numpy(), want_post[k], **TIGHT, err_msg=k)
    for a, b in zip(model.eval_embeddings(p, r["st"], graph),
                    r["jm"].eval_embeddings(r["params"], r["state"], jgraph)):
        assert a.shape[1] == 2 * SMALL["embedding.size"] and not a.requires_grad
        _close(a, b, bf16, what="eval")


@pytest.mark.parametrize("name", ["selfcf", "buir"])
def test_bucketed_equals_dense(graphs, monkeypatch, name):
    """The same step on the port's two backends: the chain over R̂ (or the
    (U+I)² matrix) and the bucketed row-space chain agree."""
    dense = _step(name, SMALL, *graphs["dense", "float32"], monkeypatch)
    bucketed = _step(name, SMALL, *graphs["bucketed", "float32"], monkeypatch)
    np.testing.assert_allclose(bucketed["loss"].item(), dense["loss"].item(), **TIGHT)
    for k in dense["new_state"]:
        np.testing.assert_allclose(bucketed["new_state"][k].numpy(),
                                   dense["new_state"][k].numpy(), **TIGHT)


@pytest.mark.parametrize("name", ["selfcf", "buir"])
def test_duplicate_ids_write_the_same_state(graphs, monkeypatch, name):
    """A batch with every id twice: the history (SelfCF) and target (BUIR)
    writes carry identical rows for a duplicate, so the state repeats bit
    for bit and equals the JAX package's: bit for bit where both sides
    write from the same inputs (BUIR's EMA of the JAX parameters and
    targets), at the f32 bound where the rows come from each side's own
    chain (SelfCF's histories)."""
    jgraph, graph = graphs["dense", "float32"]
    runs = [_step(name, SMALL, jgraph, graph, monkeypatch, dup=True) for _ in range(2)]
    for r in runs:
        r["post"] = r["model"].post_step(r["p"], r["new_state"], r["batch"])
    for k in runs[0]["post"]:
        assert torch.equal(runs[0]["post"][k], runs[1]["post"][k]), k
    want = flatten_tree(jax.device_get(runs[0]["jm"].post_step(
        runs[0]["params"], runs[0]["want_state"], runs[0]["jbatch"])))
    for k, v in runs[0]["post"].items():
        if name == "buir":
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k], **TIGHT, err_msg=k)


def test_buir_draws_its_rate_per_encoder(sets, graphs):
    """BUIR's two encoders each draw a rate in [0, drop_rate) and a keep
    mask, from the trainer's generator on the graph's device."""
    _, graph = graphs["dense", "float32"]
    cfg = default_config(**SMALL)
    rec = GraphRecommender(build("buir", cfg), sets[1], cfg, graph=graph, log=Log(echo=False),
                           device="cpu")
    rec.build()
    g = rec._draws
    assert g.device.type == graph.device.type
    from recommendation_tpu_torch.models.buir import edge_dropout_draw

    n = graph.norm_adj.vals.shape[0]
    rates, kept = zip(*[(r.item(), k.float().mean().item())
                        for r, k in (edge_dropout_draw(g, n, 0.2, graph.device)
                                     for _ in range(20))])
    assert all(0.0 <= r < 0.2 for r in rates) and len(set(rates)) == 20
    assert all(abs(k - (1 - r)) < 0.05 for k, r in zip(kept, rates))


def test_config_matches_jax():
    for ours, ref, attrs in ((SelfCF, JaxSelfCF, ("momentum", "n_layers", "reg_weight")),
                             (BUIR, JaxBUIR, ("momentum", "n_layers", "drop_rate"))):
        for cfg in ({}, {"SelfCF.tau": 0.1, "SelfCF.n_layer": 3, "reg.weight": 0.5,
                         "BUIR.tau": 0.9, "BUIR.n_layer": 1, "BUIR.drop_rate": 0.5}):
            a, b = ours(default_config(**cfg)), ref(jax_default_config(**cfg))
            for attr in attrs + ("emb_size",):
                assert getattr(a, attr) == getattr(b, attr), attr
    assert (SelfCF(default_config()).momentum, BUIR(default_config()).momentum) == (0.05, 0.995)


# -- training and the CLI -------------------------------------------------------


@pytest.mark.parametrize("name", ["selfcf", "buir"])
@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_trains_two_epochs(sets, name, backend):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "eval.interval": 1,
                            "graph.backend": backend, "item.ranking.topN": [20]})
    rec = GraphRecommender(build(name, cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert len(losses_) == 2 and losses_[1] < losses_[0] and all(np.isfinite(losses_))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    assert all(torch.isfinite(v).all() for v in list(rec.params.values())
               + list(rec.state.values()))


@pytest.mark.parametrize("name", ["selfcf", "buir"])
def test_cli_trains_and_serves(sets, tmp_path, monkeypatch, capsys, name):
    _, data = sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    args = ["--model", name, "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "max.epoch=2", "--device", "cpu"]
    assert cli.main(["train", *args, "--set", f"checkpoint.dir={tmp_path / 'ckpt'}"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args, "--checkpoint", str(tmp_path / "ckpt")]) == 0
    (service,) = served
    assert service.user_emb.shape == (data.user_num, 32)  # the width-2d dual-score tables
    scores, ids = service.recommend_ids([0, 1, 2], 5)
    assert scores.shape == ids.shape == (3, 5) and np.isfinite(scores).all()
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card: the CPU only on request
        cli.main(["train", *args[:-2]])
