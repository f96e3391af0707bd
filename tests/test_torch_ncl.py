"""NCL (``models/ncl.py``) on the CPU against the JAX package's ``NCL``:
the loss and its gradients with the same parameters, cluster state and
batch (both contrastive terms also at unit weight, where the 1e-8 / 1e-7
defaults would bury them), the E-step given the JAX package's initial rows,
one epoch of Adam steps fed the JAX package's epoch arrays, and the
trainer's lifecycle with NCL (popularity gate, checkpoint resume with the
cluster state, per-batch E-step, the NaN guard on an int32 state, the CLI).

On the CPU the JAX ``NCL.loss`` takes its XLA path: ``_use_prop_kernel`` is
False there and ``catalog_lse`` takes the reference logsumexp.

Tolerances: the loss at rtol 1e-5 / atol 1e-6 (f32; the frameworks sum in
another order). Gradients at rtol 1e-5 with atol 1e-6 taken relative to
the largest entry of the JAX gradient: at unit weight the batch-summed
contrast at τ = 0.1 gives gradients of order 400, whose f32 spacing (3e-5)
is above any absolute 1e-6, and at the default weights they are of order
1e-4. In bf16 the gradients use the JAX kernel's bf16 bound, rtol 3e-2 /
atol 3e-3 relative to the largest entry: the XLA chain's autodiff rounds
the backward products' outputs where the port (as the Pallas kernel)
rounds their operands. After a whole epoch of Adam steps: atol 1e-5 on
parameters. Centroids within atol 1e-5 and assignments equal except where
the two nearest centroids tie within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.ncl import NCL as JaxNCL
from recommendation_tpu.train.loop import make_epoch_fn as jax_make_epoch_fn
from recommendation_tpu.train.loop import make_optimizer as jax_make_optimizer
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import available, build
from recommendation_tpu_torch.models.ncl import NCL
from recommendation_tpu_torch.ops.prop import chain_mean
from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
from recommendation_tpu_torch.train.checkpoint import CheckpointManager
from recommendation_tpu_torch.train.loop import make_optimizer, run_steps
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import params_from_jax, state_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
EPOCH = dict(rtol=0, atol=1e-5)
SMALL = {"embedding.size": 16, "batch.size": 256}
UNIT = {"NCL.ssl_reg": 1.0, "NCL.proto_reg": 1.0}
STATE_KEYS = ("user_centroids", "user_2cluster", "item_centroids", "item_2cluster")


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(tiny_data, tiny_graph, data):
    """(JAX graph, port graph) on the CPU in each compute dtype."""
    return {
        "float32": (tiny_graph, DeviceGraph(data, device="cpu")),
        "bfloat16": (JaxDeviceGraph(tiny_data, backend="dense", compute_dtype="bfloat16"),
                     DeviceGraph(data, compute_dtype="bfloat16", device="cpu")),
    }


def _leaves(params_np):
    return {k: v.requires_grad_() for k, v in params_from_jax("ncl", params_np,
                                                              device="cpu").items()}


def _jax_start(jm, jgraph):
    """JAX params and the cluster state of one E-step on them."""
    params, state = jm.init(jax.random.PRNGKey(0), jgraph)
    return params, jm.epoch_begin(params, state, jgraph, jax.random.PRNGKey(5), 0)


def _first_batch(jgraph, seed=1, batch_size=256):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    arrays = js.epoch_batches(k1, k2, jgraph, batch_size)
    jbatch = js.PairwiseBatch(*(a[0] for a in arrays[:4]))
    return jbatch, PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in arrays[:4]))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("hyper_layers,weights", [(1, "unit"), (1, "default"), (2, "unit"),
                                                  (2, "default"), (0, "default")])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(graphs, compute_dtype, hyper_layers, weights):
    """hyper_layers 1 and 2 take ChainMeanLayer with k = 2 and k = L = 3;
    0 takes ChainMean with layer 0 as the context. There the layer contrast
    holds each row against itself and its gradient at unit weight cancels
    down to f32 noise, so that case runs at the default weights only."""
    cfg = {**SMALL, "NCL.hyper_layers": hyper_layers, **(UNIT if weights == "unit" else {})}
    jgraph, graph = graphs[compute_dtype]
    jm = JaxNCL(jax_default_config(**cfg))
    params, state = _jax_start(jm, jgraph)
    jbatch, batch = _first_batch(jgraph)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jm.loss(p, state, jbatch, jgraph, jax.random.PRNGKey(2)), has_aux=True)(params)

    p = _leaves(jax.device_get(params))
    st = state_from_jax("ncl", jax.device_get(state), device="cpu")
    loss, new_state = build("ncl", default_config(**cfg)).loss(p, st, batch, graph)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert new_state is st
    _close(loss, want, TIGHT)
    for g, name in zip(grads, p):
        w = np.asarray(want_g[name])
        rtol, atol = (1e-5, 1e-6) if compute_dtype == "float32" else (3e-2, 3e-3)
        tol = dict(rtol=rtol, atol=atol * np.abs(w).max())
        assert np.abs(w).max() > 0
        _close(g, w, tol)


def test_contrastive_terms_are_not_buried(graphs):
    """At unit weight the SSL and proto terms move the gradient far more
    than rounding, so the parity test above sees them."""
    jgraph, graph = graphs["float32"]
    jm = JaxNCL(jax_default_config(**SMALL))
    params, state = _jax_start(jm, jgraph)
    _, batch = _first_batch(jgraph)
    st = state_from_jax("ncl", jax.device_get(state), device="cpu")
    grads = {}
    for name, cfg in (("default", SMALL), ("unit", {**SMALL, **UNIT})):
        p = _leaves(jax.device_get(params))
        loss, _ = build("ncl", default_config(**cfg)).loss(p, st, batch, graph)
        grads[name] = torch.autograd.grad(loss, list(p.values()))
    for d, u in zip(grads["default"], grads["unit"]):
        assert (u - d).abs().max() > 100 * d.abs().max()


def _jax_e_step_draws(jm, jgraph, rng):
    """The rows JAX's epoch_begin draws inside ``kmeans``."""
    k1, k2 = jax.random.split(rng)
    return {side: (torch.from_numpy(np.array(jax.random.choice(
        key, n, shape=(jm._k_for(n),), replace=False))), None)
        for side, key, n in (("user", k1, jgraph.n_users), ("item", k2, jgraph.n_items))}


def _assert_state_matches(state, want, x_user, x_item):
    assert set(state) == set(STATE_KEYS)
    for side, x in (("user", x_user), ("item", x_item)):
        assign, cent = state[f"{side}_2cluster"], state[f"{side}_centroids"]
        w_assign = np.asarray(want[f"{side}_2cluster"])
        w_cent = np.asarray(want[f"{side}_centroids"])
        assert assign.dtype == torch.int32 and cent.dtype == torch.float32
        assert cent.shape == w_cent.shape
        differ = assign.numpy() != w_assign
        d2 = ((x[:, None, :] - w_cent[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, :2]
        assert not differ[two[:, 1] - two[:, 0] > 1e-5 * np.maximum(1.0, two[:, 0])].any()
        if not differ.any():
            _close(cent, w_cent, EPOCH)


@pytest.mark.parametrize("num_clusters", [100, 2])
def test_e_step_matches_jax(graphs, num_clusters):
    cfg = {**SMALL, "NCL.num_clusters": num_clusters}
    jgraph, graph = graphs["float32"]
    jm = JaxNCL(jax_default_config(**cfg))
    params, state = jm.init(jax.random.PRNGKey(3), jgraph)
    rng = jax.random.PRNGKey(4)
    want = jm.epoch_begin(params, state, jgraph, rng, 0)
    p = params_from_jax("ncl", jax.device_get(params), device="cpu")
    model = build("ncl", default_config(**cfg))
    u, i = chain_mean(graph.propagation_matrix, p["user_emb"], p["item_emb"], 3)
    got = model.e_step(u, i, _jax_e_step_draws(jm, jgraph, rng))
    _assert_state_matches(got, want, u.numpy(), i.numpy())
    # epoch_begin is e_step on the chain's mean with the generator's draws
    began = model.epoch_begin(p, {}, graph, torch.Generator().manual_seed(8), 0)
    again = model.e_step(u, i, model.cluster_draws(torch.Generator().manual_seed(8), graph))
    assert all(torch.equal(began[k], again[k]) for k in STATE_KEYS)


def test_e_step_at_the_bench_shape_matches_jax():
    """Synthetic ML-100K, d = 64: k = 24 user and 42 item clusters."""
    train, test = make_synthetic_dataset(n_users=943, n_items=1682, n_interactions=100_000,
                                         seed=7)
    jgraph = JaxDeviceGraph(JaxInteraction(train, test), backend="dense")
    graph = DeviceGraph(Interaction(train, test), device="cpu")
    jm = JaxNCL(jax_default_config())
    params, state = jm.init(jax.random.PRNGKey(6), jgraph)
    rng = jax.random.PRNGKey(7)
    want = jm.epoch_begin(params, state, jgraph, rng, 0)
    assert want["user_centroids"].shape == (24, 64) and want["item_centroids"].shape == (42, 64)
    p = params_from_jax("ncl", jax.device_get(params), device="cpu")
    u, i = chain_mean(graph.propagation_matrix, p["user_emb"], p["item_emb"], 3)
    got = build("ncl", default_config()).e_step(u, i, _jax_e_step_draws(jm, jgraph, rng))
    _assert_state_matches(got, want, u.numpy(), i.numpy())


def test_one_epoch_matches_make_epoch_fn(graphs):
    """An epoch of Adam steps with the cluster state of one E-step carried
    through, both contrastive terms at unit weight."""
    cfg = {**SMALL, **UNIT}
    jgraph, graph = graphs["float32"]
    jcfg = jax_default_config(**cfg)
    jm = JaxNCL(jcfg)
    params, state = _jax_start(jm, jgraph)
    opt = jax_make_optimizer(jcfg)
    rng = jax.random.PRNGKey(9)
    want_p, _, want_state, want_loss = jax_make_epoch_fn(jm, opt, 256)(
        jgraph, params, opt.init(params), state, rng)
    shuffle_key, neg_key, _ = jax.random.split(rng, 3)
    arrays = js.epoch_batches(shuffle_key, neg_key, jgraph, 256)
    batches = tuple(torch.from_numpy(np.array(a)) for a in arrays[:4]) + (arrays[4],)

    p = _leaves(jax.device_get(params))
    st = state_from_jax("ncl", jax.device_get(state), device="cpu")
    model = build("ncl", default_config(**cfg))
    new_state, loss = run_steps(model, make_optimizer(default_config(**cfg), p), graph, p, st,
                                batches)
    assert arrays[4] == 8
    for k, t in p.items():
        _close(t, want_p[k], EPOCH)
    _close(loss, want_loss, TIGHT)  # a loss of order 5e3 at unit weights
    for k in STATE_KEYS:
        assert new_state[k].dtype == st[k].dtype
        np.testing.assert_array_equal(new_state[k].numpy(), np.asarray(want_state[k]))


def test_config_matches_jax():
    for cfg in ({}, {"NCL.n_layers": 2, "NCL.tau": 0.2, "NCL.ssl_reg": 1e-3,
                     "NCL.proto_reg": 1e-4, "NCL.hyper_layers": 2, "NCL.alpha": 0.5,
                     "NCL.num_clusters": 7, "NCL.kmeans_iters": 3, "NCL.e_step_cadence": "batch",
                     "NCL.kmeans_minibatch_above": 0, "NCL.kmeans_batch": 17}):
        ours, ref = NCL(default_config(**cfg)), JaxNCL(jax_default_config(**cfg))
        for attr in ("n_layers", "ssl_temp", "ssl_reg", "proto_reg", "hyper_layers", "alpha",
                     "num_clusters", "kmeans_iters", "e_step_per_batch", "e_step_cadence",
                     "kmeans_minibatch_above", "kmeans_batch", "emb_size", "reg"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        for n in (1, 60, 100, 943, 1675, 10**6):
            assert ours._k_for(n) == ref._k_for(n)
    assert "ncl" in available()


def test_init_state_layout(graphs):
    jgraph, graph = graphs["float32"]
    params, state = build("ncl", default_config(**SMALL)).init(torch.Generator().manual_seed(0),
                                                              graph)
    _, want = JaxNCL(jax_default_config(**SMALL)).init(jax.random.PRNGKey(0), jgraph)
    assert set(params) == {"user_emb", "item_emb"} and set(state) == set(STATE_KEYS)
    for k in STATE_KEYS:
        assert tuple(state[k].shape) == want[k].shape
        assert str(state[k].dtype).replace("torch.", "") == str(want[k].dtype)


def test_minibatch_routing(graphs):
    """Tables past ``NCL.kmeans_minibatch_above`` draw per-iteration rows and
    take mini-batch k-means; -1 forces full Lloyd everywhere."""
    _, graph = graphs["float32"]
    gen = torch.Generator().manual_seed(0)
    draws = NCL(default_config(**{"NCL.kmeans_minibatch_above": 80,
                                  "NCL.kmeans_batch": 16})).cluster_draws(gen, graph)
    assert draws["user"][1] is None  # 60 users: full Lloyd
    assert tuple(draws["item"][1].shape) == (10, 16)  # 100 items: mini-batch
    draws = NCL(default_config(**{"NCL.kmeans_minibatch_above": -1})).cluster_draws(gen, graph)
    assert draws["user"][1] is None and draws["item"][1] is None
    model = NCL(default_config(**{"NCL.kmeans_minibatch_above": 0, "NCL.kmeans_batch": 16}))
    x = torch.randn(100, 16, generator=gen)
    state = model.e_step(x[:60], x, model.cluster_draws(gen, graph))
    assert all(state[k].dtype == torch.int32 for k in ("user_2cluster", "item_2cluster"))


def test_e_step_cadence(graphs):
    _, graph = graphs["float32"]
    model = build("ncl", default_config(**{**SMALL, "NCL.e_step_cadence": 3}))
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    s0 = model.epoch_begin(params, state, graph, torch.Generator().manual_seed(1), 0)
    assert s0 is not state
    assert model.epoch_begin(params, s0, graph, torch.Generator().manual_seed(2), 1) is s0
    assert model.epoch_begin(params, s0, graph, torch.Generator().manual_seed(3), 3) is not s0


def _words_batch(graph, seed=1):
    users, items, negs, weights, n = epoch_batches(
        epoch_words(torch.Generator().manual_seed(seed), graph, 256), graph, 256)
    return (users, items, negs, weights, n), PairwiseBatch(users[0], items[0], negs[0], weights[0])


def test_per_batch_e_step_reclusters_inside_the_loss(graphs):
    _, graph = graphs["float32"]
    model = build("ncl", default_config(**{**SMALL, "NCL.e_step_cadence": "batch"}))
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    assert model.epoch_begin(params, state, graph, torch.Generator(), 0) is state
    _, batch = _words_batch(graph)
    p = {k: v.requires_grad_() for k, v in params.items()}
    loss, new = model.loss(p, state, batch, graph, torch.Generator().manual_seed(4))
    _, again = model.loss(p, state, batch, graph, torch.Generator().manual_seed(4))
    assert new is not state and torch.isfinite(loss)
    assert new["user_centroids"].abs().max() > 0 and not new["user_centroids"].requires_grad
    for side, n, k in (("user", graph.n_users, 2), ("item", graph.n_items, 2)):
        a = new[f"{side}_2cluster"]
        assert a.dtype == torch.int32 and a.shape == (n,) and ((a >= 0) & (a < k)).all()
    assert all(torch.equal(new[k], again[k]) for k in STATE_KEYS)
    with pytest.raises(ValueError, match="generator"):
        model.loss(p, state, batch, graph)
    # it is the E-step of the step's own mean embeddings, detached
    with torch.no_grad():
        u, i = chain_mean(graph.propagation_matrix, params["user_emb"], params["item_emb"], 3)
    want = model.e_step(u, i, model.cluster_draws(torch.Generator().manual_seed(4), graph))
    assert all(torch.allclose(new[k].float(), want[k].float(), rtol=0, atol=1e-6)
               for k in STATE_KEYS)


class _NaNAtSecond(NCL):
    calls = 0

    def loss(self, params, state, batch, graph, generator=None):
        loss, state = super().loss(params, state, batch, graph, generator)
        self.calls += 1
        return (loss * float("nan") if self.calls == 2 else loss), state


def test_nan_guard_keeps_the_int32_state(graphs):
    """A non-finite step keeps the cluster state of the step before it,
    through ``torch.where`` on the int32 tables too."""
    _, graph = graphs["float32"]
    cfg = default_config(**{**SMALL, "NCL.e_step_cadence": "batch"})
    (users, items, negs, weights, _), _ = _words_batch(graph, seed=2)
    window = (users[:2], items[:2], negs[:2], weights[:2], 2)
    model = _NaNAtSecond(cfg)
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    runs = []
    for n in (1, 2):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        model.calls = 0
        w = tuple(t[:n] for t in window[:4]) + (n,)
        runs.append(run_steps(model, make_optimizer(cfg, p), graph, p, state, w,
                              torch.Generator().manual_seed(6))[0])
    one, two = runs
    for k in STATE_KEYS:
        assert two[k].dtype == state[k].dtype and torch.equal(two[k], one[k])
    assert not torch.equal(one["user_centroids"], state["user_centroids"])


def _recommender(data, graph, **cfg):
    config = default_config(**{**SMALL, "item.ranking.topN": [10, 20], **cfg})
    return GraphRecommender(build("ncl", config), data, config, graph=graph, log=Log(echo=False))


def test_recommender_beats_popularity(data, graphs):
    """The LightGCN trainer's gate (tests/test_torch_train.py): on this dense
    fixture popularity is near-optimal, so NCL must come within 0.005 of the
    masked most-popular list."""
    from tests.test_torch_train import _popularity_recall

    _, graph = graphs["float32"]
    rec = _recommender(data, graph, **{"max.epoch": 25, "batch.size": 512,
                                       "learning.rate": 5e-3, "embedding.size": 32,
                                       "eval.interval": 5, "seed": 2})
    metrics = rec.execute()
    losses = [e["loss"] for e in rec.epoch_stats]
    assert len(losses) == 25 and losses[-1] < losses[0]
    assert metrics["Recall@20"] >= _popularity_recall(data, graph) - 0.005
    assert rec.state["item_centroids"].abs().max() > 0


def test_checkpoint_resume_equals_straight_run(data, graphs, tmp_path):
    _, graph = graphs["float32"]
    cfg = {"max.epoch": 4, "eval.interval": 1, "checkpoint.keep": 2}
    straight = _recommender(data, graph, **cfg, **{"checkpoint.dir": str(tmp_path / "a")})
    straight.build()
    straight.train()
    first = _recommender(data, graph, **{**cfg, "max.epoch": 2,
                                         "checkpoint.dir": str(tmp_path / "b")})
    first.build()
    first.train()
    resumed = _recommender(data, graph, **cfg, **{"checkpoint.dir": str(tmp_path / "b")})
    resumed.build()
    assert resumed.start_epoch == 2
    assert resumed.state["user_2cluster"].dtype == torch.int32
    resumed.train()
    pa, pb = (CheckpointManager(tmp_path / d).restore_latest() for d in ("a", "b"))
    assert pa["epoch"] == pb["epoch"] == 3
    for k in pa["params"]:
        assert torch.equal(pa["params"][k], pb["params"][k])
    for k in STATE_KEYS:
        assert pa["state"][k].dtype == pb["state"][k].dtype
        assert torch.equal(pa["state"][k], pb["state"][k])
    assert pb["state"]["item_2cluster"].dtype == torch.int32
    assert ([e["loss"] for e in straight.epoch_stats[2:]]
            == [e["loss"] for e in resumed.epoch_stats])


def test_state_from_jax_keeps_the_types():
    state = {"user_centroids": np.ones((2, 3)), "user_2cluster": np.arange(4, dtype=np.int32),
             "item_centroids": np.zeros((2, 3), np.float32),
             "item_2cluster": np.zeros(5, np.int32)}
    got = state_from_jax("ncl", state, device="cpu")
    assert got["user_2cluster"].dtype == torch.int32
    assert got["user_centroids"].dtype == torch.float32
    assert got["user_2cluster"].tolist() == [0, 1, 2, 3]
    assert state_from_jax("lightgcn", {}, device="cpu") == {}
    with pytest.raises(ValueError):
        state_from_jax("ncl", {"user_centroids": np.ones(2)}, device="cpu")
    with pytest.raises(KeyError):  # a model the port does not have yet
        state_from_jax("diffnet", {}, device="cpu")
    assert state_from_jax("graphsage", {}, device="cpu") == {}  # ported: no state


def test_serve_from_params_reads_no_state(data, tmp_path):
    """``serve --model ncl --checkpoint PARAMS.npz``: params only."""
    from recommendation_tpu_torch.cli import build_service
    from recommendation_tpu_torch.weights import save_params

    graph = DeviceGraph(data, device="cpu")
    model = build("ncl", default_config(**SMALL))
    params, _ = model.init(torch.Generator().manual_seed(1), graph)
    path = str(tmp_path / "ncl.npz")
    save_params(path, params)
    service = build_service("ncl", path, default_config(**SMALL), data.training_data,
                            data.test_data, device="cpu")
    want = model.eval_embeddings(params, None, graph)
    assert torch.equal(service.user_emb, want[0]) and torch.equal(service.item_emb, want[1])
    s, i = service.recommend_ids([0, 1], 5)
    assert np.isfinite(s).all() and i.shape == (2, 5)


def test_cli_train_ncl_prints_finite_metrics(data, tmp_path):
    import json
    import subprocess
    import sys

    from recommendation_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path), data.training_data, data.test_data)
    out = subprocess.run(
        [sys.executable, "-m", "recommendation_tpu_torch", "train", "--model", "ncl", "--device",
         "cpu", "--train", str(tmp_path / "train.txt"), "--test", str(tmp_path / "test.txt"),
         "--set", "max.epoch=2", "--set", "batch.size=512", "--set", "embedding.size=16"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"Recall@20", "NDCG@20"} <= set(metrics)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_ncl_on_cuda_without_a_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = default_config(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphRecommender(build("ncl", config), data, config)
