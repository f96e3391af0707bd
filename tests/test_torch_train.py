"""The training slice on the CPU against the JAX package: LightGCN's loss
and gradients, one optimizer step against optax (Adam also from a
carried-over mid-trajectory state), one whole epoch against the JAX
package's ``make_epoch_fn`` fed the same epoch arrays, the NaN guard
against optax's behaviour under zeroed gradients, and the trainer's
lifecycle (``GraphRecommender``: popularity baseline, checkpoint resume,
bold driver, early stopping, convergence stop, NaN abort).

Tolerances are f32: rtol 1e-5 / atol 1e-6 on a loss and its gradients
(the frameworks reduce in another order); atol 1e-5 on parameters and
1e-5 on the mean loss after a whole epoch of Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu.train.loop import BoldDriver as JaxBoldDriver
from recommendation_tpu.train.loop import make_epoch_fn as jax_make_epoch_fn
from recommendation_tpu.train.loop import make_optimizer as jax_make_optimizer
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.metrics import ranking_metrics
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.losses import bpr_loss, l2_reg_loss, pointwise_bce_loss
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models.lightgcn import LightGCN
from recommendation_tpu_torch.ops.rows import take_rows
from recommendation_tpu_torch.sampling import (
    PairwiseBatch,
    epoch_batches,
    epoch_words,
    negative_words,
    popularity_baseline_topk,
    sample_negatives,
    sample_pointwise,
)
from recommendation_tpu_torch.train.checkpoint import CheckpointManager
from recommendation_tpu_torch.train.loop import BoldDriver, make_optimizer, run_steps, train_epoch
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import opt_state_from_jax, params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
EPOCH = dict(rtol=0, atol=1e-5)
SMALL = {"embedding.size": 16, "batch.size": 256}


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graph(data):
    return DeviceGraph(data, device="cpu")


def _leaves(params_np):
    return {k: v.requires_grad_() for k, v in params_from_jax("lightgcn", params_np,
                                                              device="cpu").items()}


def _torch_batches(arrays):
    users, items, negs, weights, nb = arrays
    return tuple(torch.from_numpy(np.array(a)) for a in (users, items, negs, weights)) + (nb,)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("loss_type", ["bpr", "bce"])
def test_lightgcn_loss_and_grads_match_jax(tiny_graph, graph, loss_type):
    cfg = {**SMALL, "loss": loss_type}
    jm = JaxLightGCN(jax_default_config(**cfg))
    params, _ = jm.init(jax.random.PRNGKey(0), tiny_graph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    users, items, negs, weights, _ = js.epoch_batches(k1, k2, tiny_graph, 256)
    jbatch = js.PairwiseBatch(users[0], items[0], negs[0], weights[0])
    want, want_g = jax.value_and_grad(
        lambda p: jm.loss(p, {}, jbatch, tiny_graph, jax.random.PRNGKey(2))[0])(params)

    p = _leaves(jax.device_get(params))
    batch = PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in (users, items, negs, weights)))
    loss, state = build("lightgcn", default_config(**cfg)).loss(p, {}, batch, graph)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert state == {}
    _close(loss, want, TIGHT)
    for g, name in zip(grads, p):
        _close(g, want_g[name], TIGHT)


def _optax_steps(opt, params, grads_seq, state=None):
    state = opt.init(params) if state is None else state
    for g in grads_seq:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _torch_steps(opt, p, grads_seq):
    for g in grads_seq:
        for name, t in p.items():
            t.grad = torch.tensor(np.asarray(g[name]))
        opt.step()


def _rand_tree(rng, scale=1.0):
    return {"user_emb": (rng.normal(size=(20, 8)) * scale).astype(np.float32),
            "item_emb": (rng.normal(size=(30, 8)) * scale).astype(np.float32)}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(0)
    cfg = {"optimizer": name, "learning.rate": 1e-2, "weight.decay": 0.05, "momentum": 0.9}
    params = _rand_tree(rng)
    grads_seq = [_rand_tree(rng, 0.1) for _ in range(3)]
    want, _ = _optax_steps(jax_make_optimizer(jax_default_config(**cfg)),
                           {k: jnp.asarray(v) for k, v in params.items()},
                           [{k: jnp.asarray(v) for k, v in g.items()} for g in grads_seq])
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    _torch_steps(make_optimizer(default_config(**cfg), p), p, grads_seq)
    for k in p:
        _close(p[k], want[k], TIGHT)


def test_adam_from_carried_over_state_matches_optax():
    """Adam mid-trajectory (count 5: bias correction far from 1), carried
    over with ``opt_state_from_jax``, then one more step on each side."""
    rng = np.random.default_rng(1)
    opt = optax.adam(3e-3)
    params = {k: jnp.asarray(v) for k, v in _rand_tree(rng).items()}
    grads_seq = [{k: jnp.asarray(v) for k, v in _rand_tree(rng, 0.1).items()} for _ in range(6)]
    mid, state = _optax_steps(opt, params, grads_seq[:5])
    want, want_state = _optax_steps(opt, mid, grads_seq[5:], state)

    p = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in mid.items()}
    topt = make_optimizer(default_config(**{"learning.rate": 3e-3}), p)
    topt.load_state_dict(opt_state_from_jax(jax.device_get(state), p, lr=3e-3))
    assert topt.param_groups[0]["lr"] == 3e-3
    _torch_steps(topt, p, [jax.device_get(grads_seq[5])])
    for k, t in p.items():
        _close(t, want[k], TIGHT)
        assert float(topt.state[t]["step"]) == 6.0
        _close(topt.state[t]["exp_avg"], want_state[0].mu[k], TIGHT)
        _close(topt.state[t]["exp_avg_sq"], want_state[0].nu[k], TIGHT)


def _jax_epoch(jm, tiny_graph, jcfg, rng_key, batch_size=256):
    params, state = jm.init(jax.random.PRNGKey(0), tiny_graph)
    opt = jax_make_optimizer(jcfg)
    opt_state = opt.init(params)
    out = jax_make_epoch_fn(jm, opt, batch_size)(tiny_graph, params, opt_state, state, rng_key)
    shuffle_key, neg_key, _ = jax.random.split(rng_key, 3)
    arrays = js.epoch_batches(shuffle_key, neg_key, tiny_graph, batch_size)
    return params, out, arrays


def test_one_epoch_matches_make_epoch_fn(tiny_graph, graph):
    jcfg = jax_default_config(**SMALL)
    params, (want_p, want_opt, _, want_loss), arrays = _jax_epoch(
        JaxLightGCN(jcfg), tiny_graph, jcfg, jax.random.PRNGKey(3))
    p = _leaves(jax.device_get(params))
    cfg = default_config(**SMALL)
    opt = make_optimizer(cfg, p)
    state, loss = run_steps(build("lightgcn", cfg), opt, graph, p, {}, _torch_batches(arrays))
    assert arrays[4] == 8 and state == {}
    for k, t in p.items():
        _close(t, want_p[k], EPOCH)
        assert float(opt.state[t]["step"]) == float(want_opt[0].count) == 8.0
    _close(loss, want_loss, EPOCH)


class _JaxNaNAt(JaxLightGCN):
    bad_user = -1

    def loss(self, params, state, batch, graph, rng):
        loss, state = super().loss(params, state, batch, graph, rng)
        # NaN loss and NaN gradients on the bad steps only
        return loss * jnp.where(batch.users[0] == self.bad_user, jnp.nan, 1.0), state


class _NaNAt(LightGCN):
    bad_user = -1

    def loss(self, params, state, batch, graph, generator=None):
        loss, state = super().loss(params, state, batch, graph, generator)
        return loss * torch.where(batch.users[0] == self.bad_user, float("nan"), 1.0), state


def test_nan_guard_matches_optax(tiny_graph, graph):
    """Steps whose loss is NaN (and so are their gradients) update with
    zeroed gradients on both sides: Adam's moments decay and its count
    advances, as optax does; the epoch's mean loss skips them."""
    jcfg = jax_default_config(**SMALL)
    shuffle_key, neg_key, _ = jax.random.split(jax.random.PRNGKey(4), 3)
    users = np.asarray(js.epoch_batches(shuffle_key, neg_key, tiny_graph, 256)[0])
    bad = int(users[2, 0])
    n_bad = int((users[:, 0] == bad).sum())
    assert 1 <= n_bad < users.shape[0]
    jm = _JaxNaNAt(jcfg)
    jm.bad_user = bad
    params, (want_p, want_opt, _, want_loss), arrays = _jax_epoch(
        jm, tiny_graph, jcfg, jax.random.PRNGKey(4))
    model = _NaNAt(default_config(**SMALL))
    model.bad_user = bad
    p = _leaves(jax.device_get(params))
    opt = make_optimizer(default_config(**SMALL), p)
    _, loss = run_steps(model, opt, graph, p, {}, _torch_batches(arrays))
    assert np.isfinite(float(want_loss))
    _close(loss, want_loss, EPOCH)
    for k, t in p.items():
        assert torch.isfinite(t).all()
        _close(t, want_p[k], EPOCH)
        assert float(opt.state[t]["step"]) == float(want_opt[0].count) == users.shape[0]
        _close(opt.state[t]["exp_avg"], want_opt[0].mu[k], EPOCH)


@pytest.mark.parametrize("loss_type,extra", [
    ("bpr", {"n_negs": 3}), ("bce", {"n_negs": 2}), ("pointwise", {"Pointwise.n_negs": 3}),
])
def test_sampled_loss_invariants(graph, loss_type, extra):
    """Losses that draw their own negatives: deterministic in the
    generator, the formula over the drawn negatives, finite gradients, and
    training lowers them."""
    cfg = default_config(**{**SMALL, "loss": loss_type, **extra})
    model = build("lightgcn", cfg)
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    p = {k: v.requires_grad_() for k, v in params.items()}
    users, items, negs, weights, _ = epoch_batches(
        epoch_words(torch.Generator().manual_seed(1), graph, 256), graph, 256)
    batch = PairwiseBatch(users[0], items[0], negs[0], weights[0])

    def loss_with(seed):
        return model.loss(p, {}, batch, graph, torch.Generator().manual_seed(seed))[0]

    loss = loss_with(5)
    assert torch.equal(loss, loss_with(5)) and not torch.equal(loss, loss_with(6))
    grads = torch.autograd.grad(loss, list(p.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)

    with torch.no_grad():
        u_all, i_all = model.propagate(p, graph)
        k = extra.get("n_negs", extra.get("Pointwise.n_negs"))
        words = negative_words(torch.Generator().manual_seed(5), k, 256, "cpu")
        if loss_type == "pointwise":
            pw = sample_pointwise(words, graph, batch.users, batch.pos_items, n_negs=k,
                                  weight=batch.weight)
            u, it = take_rows(u_all, pw.users), take_rows(i_all, pw.items)
            want = (pointwise_bce_loss(torch.sum(u * it, 1), pw.labels, pw.weight)
                    + l2_reg_loss(model.reg, u, it) / 256)
            torch.testing.assert_close(loss.detach(), want, rtol=0, atol=0)
        elif loss_type == "bpr":
            u, pos = take_rows(u_all, batch.users), take_rows(i_all, batch.pos_items)
            rank = torch.stack([bpr_loss(u, pos, take_rows(i_all, sample_negatives(
                words[j], graph, batch.users))) for j in range(k)]).mean()
            want = rank + l2_reg_loss(model.reg, u, pos, take_rows(i_all, batch.neg_items)) / 256
            torch.testing.assert_close(loss.detach(), want, rtol=0, atol=0)

    opt = make_optimizer(default_config(**{**SMALL, "learning.rate": 1e-2}), p)
    gen = torch.Generator().manual_seed(7)
    first = float(train_epoch(model, opt, graph, p, {}, gen, 256)[1])
    for _ in range(3):
        last = float(train_epoch(model, opt, graph, p, {}, gen, 256)[1])
    assert np.isfinite(first) and last < first


def _recommender(data, graph, **cfg):
    config = default_config(**{**SMALL, "item.ranking.topN": [10, 20], **cfg})
    return GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                            log=Log(echo=False))


def _popularity_recall(data, graph, k=20):
    """Most-popular ranking with each user's train positives masked out,
    scored as tests/test_lightgcn.py scores the JAX package's baseline."""
    top = popularity_baseline_topk(graph, graph.n_items)
    pos = graph.user_positives.numpy()
    rows = []
    for u in data.test_user_ids():
        seen = set(pos[u][pos[u] >= 0].tolist())
        rows.append(np.array([i for i in top if i not in seen][:k]))
    return ranking_metrics(np.stack(rows), data.test_items_by_user(), [k])[f"Recall@{k}"]


def test_recommender_beats_popularity(data, graph):
    """The JAX package's own check (tests/test_lightgcn.py): on this dense
    fixture popularity is near-optimal, so learned ranking must come within
    0.005 of it; a broken trainer misses by far more."""
    rec = _recommender(data, graph, **{"max.epoch": 25, "batch.size": 512,
                                       "learning.rate": 5e-3, "embedding.size": 32,
                                       "eval.interval": 5, "seed": 2})
    metrics = rec.execute()
    losses = [e["loss"] for e in rec.epoch_stats]
    assert len(losses) == 25 and losses[-1] < losses[0]
    assert metrics["Recall@20"] >= _popularity_recall(data, graph) - 0.005
    assert 0 < metrics["NDCG@20"] <= 1
    assert rec.best_epoch >= 0 and len(rec.history) == 5
    scores = rec.predict(data.id2user[0])
    assert scores.shape == (graph.n_items,) and np.isfinite(scores).all()


def test_checkpoint_resume_equals_straight_run(data, graph, tmp_path):
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
    resumed.train()
    a, b = CheckpointManager(tmp_path / "a"), CheckpointManager(tmp_path / "b")
    assert a.all_steps() == b.all_steps() == [2, 3]  # keep=2 collected the rest
    pa, pb = a.restore_latest(), b.restore_latest()
    assert pa["epoch"] == pb["epoch"] == 3
    for k in pa["params"]:
        assert torch.equal(pa["params"][k], pb["params"][k])
    for sa, sb in zip(pa["optimizer"]["state"].values(), pb["optimizer"]["state"].values()):
        assert all(torch.equal(sa[n], sb[n]) for n in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(pa["generator"], pb["generator"])
    assert ([e["loss"] for e in straight.epoch_stats[2:]]
            == [e["loss"] for e in resumed.epoch_stats])


def test_eval_interval_does_not_change_the_batches(data, graph):
    """Each epoch draws from the generator in the same order whatever
    eval.interval is, so the training trajectories are the same."""
    runs = []
    for interval in (1, 3):
        rec = _recommender(data, graph, **{"max.epoch": 3, "eval.interval": interval,
                                           "model.selection": "majority"})
        rec.build()
        rec.train()
        runs.append([e["loss"] for e in rec.epoch_stats])
    assert runs[0] == runs[1]


def test_bold_driver_rule():
    for cls in (BoldDriver, JaxBoldDriver):
        bd = cls(0.1, max_lrate=0.2)
        assert bd.update(1, 1.0) == 0.1  # epoch <= 1: unchanged
        assert abs(bd.update(2, 0.5) - 0.105) < 1e-9  # improved -> x1.05
        assert abs(bd.update(3, 0.7) - 0.0525) < 1e-9  # worse -> x0.5
    ours, ref = BoldDriver(0.19, max_lrate=0.2), JaxBoldDriver(0.19, max_lrate=0.2)
    for epoch, loss in enumerate([1.0, 0.5, 0.4, 0.45, 0.3, -0.2]):
        assert ours.update(epoch, loss) == ref.update(epoch, loss) <= 0.2


def test_adaptive_lr_sets_the_rate(data, graph):
    rec = _recommender(data, graph, **{"max.epoch": 3, "eval.interval": 3, "adaptive.lr": True})
    rec.build()
    rec.train()
    assert any("bold-driver lr ->" in line for line in rec.log.contents())
    assert rec.optimizer.param_groups[0]["lr"] == rec._bold.lrate


def test_early_stopping(data, graph):
    """With a zero learning rate nothing improves after the first
    evaluation, so patience 0 stops after the second."""
    rec = _recommender(data, graph, **{"max.epoch": 10, "learning.rate": 0.0,
                                       "early.stopping.patience": 0})
    rec.build()
    rec.train()
    assert any("early stop at epoch 1" in line for line in rec.log.contents())
    assert len(rec.epoch_stats) == 2 and rec.best_epoch == 0


def test_convergence_stop(data, graph):
    rec = _recommender(data, graph, **{"max.epoch": 30, "eval.interval": 30,
                                       "convergence.eps": 10.0})
    rec.build()
    rec.train()
    assert any("converged at epoch 1" in line for line in rec.log.contents())


class _AlwaysNaN(LightGCN):
    def loss(self, params, state, batch, graph, generator=None):
        loss, state = super().loss(params, state, batch, graph, generator)
        return loss * float("nan"), state


def test_nan_epoch_aborts_and_keeps_the_tables(data, graph):
    config = default_config(**SMALL, **{"max.epoch": 5})
    rec = GraphRecommender(_AlwaysNaN(config), data, config, graph=graph, log=Log(echo=False))
    rec.build()
    before = {k: v.detach().clone() for k, v in rec.params.items()}
    rec.train()
    assert any("loss is NaN" in line for line in rec.log.contents())
    assert rec.epoch_stats == []
    for k, v in rec.params.items():
        assert torch.equal(v.detach(), before[k])


def test_trainer_on_cuda_without_a_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = default_config(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphRecommender(build("lightgcn", config), data, config)
