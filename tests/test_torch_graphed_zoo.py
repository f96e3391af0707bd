"""The epoch as CUDA graphs for the fifteen models beside LightGCN and NCL
(``train/graphed.py``) on the CPU, where ``GraphedEpoch`` runs its bodies
eagerly (capture off): for each model at its defaults (at d = 8 on the
tiny set, the social models on its synthesized trust graph) two epochs
through the runner, with ``epoch_begin`` between them, equal two epochs
of ``train.loop.train_epoch`` bit for bit, the epoch's generator (its
words, then the losses' masks) included; a run resumed from its checkpoint equals the straight run
(GRACE, ESRF: the device generator's state rides the checkpoint); G-BT's
schedule is optax's ``cosine_decay_schedule`` at every step; ESRF's
segment, read at a device offset, is the JAX function's
``dynamic_slice_in_dim`` at the bounds of its start. The fuse gate over
the fifteen is in ``tests/test_torch_graphed.py``.

One CPU thread, as there: torch's CPU sums split over threads change the
low bits from run to run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.models import get_model as jax_get_model
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.train.checkpoint import CheckpointManager
from recommendation_tpu_torch.train.graphed import GraphedEpoch
from recommendation_tpu_torch.train.loop import (
    CosineDecayAdam,
    cosine_decay,
    make_optimizer,
    tensor_rates,
    train_epoch,
)
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import params_from_jax, subtree

B = 256
# the fifteen models (SEPT under both of its names)
ZOO = ("selfcf", "buir", "ssl4rec", "gcl", "grace", "gbt", "bgrl", "directau", "graphsage",
       "gat", "diffnet", "sept", "sept_social", "sept_basic", "mhcn", "esrf")
SOCIAL = ("diffnet", "sept", "sept_social", "sept_basic", "mhcn", "esrf")
CONFIG = {"embedding.size": 8, "batch.size": B, "max.epoch": 6, "ESRF.segment": 20,
          "item.ranking.topN": [10]}
# epoch 1 then 4 of 6: SEPT's warm-up then its SSL on a fresh mask; ESRF's
# phase 0 then its phase 2 (thirds of 2 epochs)
EPOCHS = (1, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(data, tiny_social):
    return {"plain": DeviceGraph(data, backend="dense", device="cpu"),
            "social": SocialDeviceGraph(data, tiny_social, backend="dense", device="cpu")}


def _graph(graphs, name):
    return graphs["social" if name in SOCIAL else "plain"]


def _snapshot(params, optimizer, state, loss, draws):
    """Copies of the parameters, Adam's state, the param groups' tensors,
    the model state, the loss and the generator's state."""
    moments = [{k: v.clone() for k, v in optimizer.state[p].items()}
               for p in params.values() if p.requires_grad]
    groups = [{k: v.clone() for k, v in g.items() if k != "params"
               and isinstance(v, torch.Tensor)} for g in optimizer.param_groups]
    return ({k: v.detach().clone() for k, v in params.items()}, moments, groups,
            {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()},
            loss.clone(), draws.get_state())


def _assert_same(got, want):
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for part in (1, 2):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert g.keys() == w.keys()
            for k in w:
                assert torch.equal(g[k], w[k]), k
    assert got[3].keys() == want[3].keys()
    for k, w in want[3].items():
        assert torch.equal(got[3][k], w) if isinstance(w, torch.Tensor) else got[3][k] == w, k
    assert torch.equal(got[4], want[4]) and torch.isfinite(got[4])
    assert torch.equal(got[5], want[5])


def _two_epochs(name, graph, graphed):
    """Two epochs of ``name`` from its init, ``epoch_begin`` before each
    (EPOCHS), through ``GraphedEpoch`` (capture off) or ``train_epoch``;
    the words and then the masks from one generator, as the trainer
    draws them."""
    config = default_config(**CONFIG)
    model = build(name, config)
    params, state = model.init(torch.Generator().manual_seed(0), graph)
    params = {k: v.requires_grad_(k not in model.frozen) for k, v in params.items()}
    trained = {k: v for k, v in params.items() if v.requires_grad}
    optimizer = model.make_optimizer(config, trained) or make_optimizer(config, trained)
    draws = torch.Generator().manual_seed(10)
    runner = GraphedEpoch(model, optimizer, graph, params, B) if graphed else None
    out = []
    for k, epoch in enumerate(EPOCHS):
        state = model.epoch_begin(params, state, graph, torch.Generator().manual_seed(100 + k),
                                  epoch)
        if runner is not None:
            state, loss = runner.run(state, draws)
        else:
            state, loss = train_epoch(model, optimizer, graph, params, state, draws, B)
        out.append(_snapshot(params, optimizer, state, loss, draws))
    return out, runner


@pytest.mark.parametrize("name", ZOO)
def test_graphed_epoch_is_train_epoch(graphs, name):
    """With capture off the runner's epochs are ``train_epoch``'s bit for
    bit over two epochs with ``epoch_begin`` between them: parameters,
    Adam's moments and step, the param groups' tensors, the model state,
    the loss and the generator's state; the model captures."""
    graph = _graph(graphs, name)
    got, runner = _two_epochs(name, graph, graphed=True)
    want, _ = _two_epochs(name, graph, graphed=False)
    assert not runner.capture and runner.captures == []
    for g, w in zip(got, want):
        _assert_same(g, w)
    if name == "esrf":
        assert [s[3]["phase"] for s in got] == [0, 2]


@pytest.mark.parametrize("name", ["grace", "esrf"])
def test_resumed_run_is_the_straight_run(data, graphs, tmp_path, name):
    """Three epochs straight, and two then a resume from the checkpoint at
    epoch 1: the checkpoints at epoch 2 hold the same parameters, Adam
    state and generators' states, and the last epoch the same loss. GRACE
    draws its masks in every step, ESRF in phases 1 and 2 (thirds of 3
    epochs); the resumed epoch draws from the restored generator."""
    graph = _graph(graphs, name)
    recs = {}
    for where, epochs in (("straight", 3), ("resumed", 2), ("resumed", 3)):
        cfg = default_config(**{**CONFIG, "max.epoch": epochs, "eval.interval": 1,
                                "checkpoint.dir": str(tmp_path / where)})
        rec = GraphRecommender(build(name, cfg), data, cfg, graph=graph, log=Log(echo=False),
                               device="cpu")
        rec.build()
        assert rec._graphed is not None
        assert rec.start_epoch == (2 if (where, epochs) == ("resumed", 3) else 0)
        rec.train()
        recs[where] = rec
    straight, resumed = (CheckpointManager(str(tmp_path / w)).restore(2)
                         for w in ("straight", "resumed"))
    for k, v in straight["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    for i, st in straight["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(resumed["optimizer"]["state"][i][k], v), k
    for key in ("generator", "draws"):
        assert torch.equal(resumed[key], straight[key]), key
    assert resumed["state"] == straight["state"]
    assert (recs["resumed"].epoch_stats[-1]["loss"]
            == recs["straight"].epoch_stats[-1]["loss"])


def test_gbt_rate_is_optax_schedule():
    """G-BT's rate at every update 0..T+3 (T = ``GBT.total_steps``, its
    default 1000): the schedule as the card computes it (f32 tensors,
    ``cosine_decay``), and the rate of ``CosineDecayAdam`` after each step
    in both its forms (a float on the CPU; a tensor in place, the card's),
    against optax's ``cosine_decay_schedule`` within 1e-7 relative."""
    model = build("gbt", default_config(**{"learning.rate": 3e-3}))
    lr, T = 3e-3, model.total_steps
    assert T == 1000
    count = np.arange(T + 4, dtype=np.int32)
    want = np.asarray(optax.cosine_decay_schedule(lr, T)(jnp.asarray(count)))
    np.testing.assert_allclose(cosine_decay(lr, torch.from_numpy(count), T).numpy(), want,
                               rtol=1e-7, atol=0)
    for form in ("float", "tensor"):
        w = torch.zeros(3, requires_grad=True)
        opt = model.make_optimizer(default_config(**{"learning.rate": lr}), {"w": w})
        assert isinstance(opt, CosineDecayAdam)
        if form == "tensor":
            rate = tensor_rates(opt).param_groups[0]["lr"]
        got = []
        for _ in count:
            w.grad = torch.zeros(3)
            opt.step()
            got.append(float(opt.param_groups[0]["lr"]))
        if form == "tensor":
            assert opt.param_groups[0]["lr"] is rate
        np.testing.assert_allclose(np.float32(got), want, rtol=1e-7, atol=0, err_msg=form)
        assert int(opt.param_groups[0]["schedule_count"]) == len(count)


@pytest.mark.parametrize("at", ["first", "middle", "last"])
def test_esrf_segment_is_the_jax_slice(data, graphs, tiny_social_graph, monkeypatch, at):
    """ESRF's generator with its segment start drawn on the device (a 0-d
    tensor: the rows read and written through their indices) against the
    JAX function's ``randint`` and ``dynamic_slice_in_dim`` /
    ``dynamic_update_slice_in_dim`` at the same start and gumbel draws, at
    the first and the last start the draw can give and one between, within
    f32 rounding; the rows outside the segment exactly 0."""
    graph = graphs["social"]
    cfg = {**CONFIG}
    jm = jax_get_model("esrf", jax_default_config(**cfg))
    jparams, _ = jm.init(jax.random.PRNGKey(0), tiny_social_graph)
    n, seg = graph.n_users, jm.segment
    start = {"first": 0, "middle": (n - seg) // 2, "last": n - seg}[at]
    gumbel = np.random.default_rng(3).random((seg, jm.K, n)).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k: (
            jnp.asarray(start, jnp.int32)))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(gumbel))
        want = np.asarray(jm._generator(jparams["g"], tiny_social_graph, jax.random.PRNGKey(1)))
    model = build("esrf", default_config(**cfg))
    params = params_from_jax("esrf", jax.device_get(jparams), device="cpu")
    drawn = []

    def randint(generator, high, device):
        assert high == n - seg + 1
        drawn.append(torch.tensor(start, device=device))
        return drawn[-1]

    with monkeypatch.context() as mp:
        mp.setattr(augment, "randint", randint)
        mp.setattr(augment, "uniform", lambda generator, shape, device: torch.from_numpy(gumbel))
        got = model._generator(subtree(params, "g"), graph, torch.Generator())
    assert len(drawn) == 1 and drawn[0].dim() == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    outside = np.ones(n, bool)
    outside[start:start + seg] = False
    assert not got.numpy()[outside].any() and got.numpy()[~outside].any()
    # the device draw itself lies in [0, n - seg]
    starts = [int(augment.randint(torch.Generator().manual_seed(s), n - seg + 1, "cpu"))
              for s in range(200)]
    assert min(starts) == 0 and max(starts) == n - seg
