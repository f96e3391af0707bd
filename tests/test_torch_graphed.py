"""The epoch as one device execution (``train/graphed.py``) on the CPU,
where ``GraphedEpoch`` runs its bodies eagerly (capture off): its
bookkeeping (the words and masks drawn inside its bodies from one
generator, the static state, chunks, the carry, the losses) gives the
eager loop's bits, and the trainer's chunked and fused paths give the
unchunked and unfused ones, and ``train_epoch``'s from the trainer's
generator. The gates against the JAX package's: the
fuse gate (``GraphRecommender._can_fuse_epochs``) on the JAX tests'
configurations and on every other model at its defaults, and the chunk
rule on a grid. The fifteen other models' epochs are in
``tests/test_torch_graphed_zoo.py``. Mirrors
``tests/test_train_extras.py``'s chunked and fused tests, which hold the
JAX package to the same bits.

Every comparison here is bit for bit (``torch.equal``): the paths run the
same operations in the same order on the same draws. Adam's arithmetic
(``train.loop.adam_plain``, what the card's capturable Adam is held to in
``tests/test_torch_card.py``) is held to optax's within the f32 bound.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import recommendation_tpu.train.recommender as jax_recommender
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.models.base import Model as JaxModel
from recommendation_tpu.models import get_model as jax_get_model
from recommendation_tpu.utils.logging import Log as JaxLog
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops import counts
from recommendation_tpu_torch.ops.gather import gather_rows
from recommendation_tpu_torch.sampling import epoch_batches, epoch_words
from recommendation_tpu_torch.train.graphed import GraphedEpoch, steps_per_call
from recommendation_tpu_torch.train.loop import (
    adam_plain,
    load_optimizer_state,
    make_bold_driver_optimizer,
    make_optimizer,
    set_learning_rate,
    train_epoch,
)
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log

D, B = 8, 256
TRAINER = {"batch.size": 512, "embedding.size": D, "item.ranking.topN": [10]}
# the JAX tests' fuse-gate configurations (tests/test_train_extras.py)
GATES = {"defaults": ("lightgcn", {}), "adaptive_lr": ("lightgcn", {"adaptive.lr": True}),
         "convergence_eps": ("lightgcn", {"convergence.eps": 1e-9}),
         "fuse_off": ("lightgcn", {"train.fuse_epochs": False}),
         "max_fused_steps_1": ("lightgcn", {"train.max_fused_steps": 1}),
         "ncl": ("ncl", {})}
# the fifteen other models at their defaults (SEPT under both of its names)
SOCIAL = ("diffnet", "sept", "sept_social", "sept_basic", "mhcn", "esrf")
ZOO = ("selfcf", "buir", "ssl4rec", "gcl", "grace", "gbt", "bgrl", "directau", "graphsage",
       "gat") + SOCIAL
GATES.update({name: (name, {}) for name in ZOO})
CHUNK_EDGES = (1_000, 999_999, 1_000_001, 2_500_000, 4_000_000)
CHUNK_BATCHES = (512, 2048, 8192)
CHUNK_MAX_STEPS = (2, 64, 512)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: torch's CPU kernels split some sums over threads by
    size and thread count, so only one thread repeats them bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(data):
    return {backend: DeviceGraph(data, backend=backend, device="cpu")
            for backend in ("dense", "bucketed", "segment")}


class _StubGraph:
    def __init__(self, n_edges):
        self.n_edges = n_edges


class _StubModel(JaxModel):
    """Enough of a JAX model for ``GraphRecommender.build`` to reach its
    chunk rule: one parameter, no state."""

    def init(self, rng, graph):
        return {"w": jnp.zeros(1)}, {}


@pytest.fixture(scope="module")
def social_graph(data, tiny_social):
    return SocialDeviceGraph(data, tiny_social, backend="dense", device="cpu")


@pytest.fixture(scope="module")
def jax_reference(tiny_data, tiny_graph, tiny_social_graph):
    """The JAX trainer's fuse gate on ``GATES`` (on the tiny set, the social
    models on its trust graph, eval every 2 epochs, as the JAX test builds
    them) and its chunk length on the grid (read off ``make_epoch_fn``'s
    argument in ``build``)."""
    gates = {}
    for case, (name, extra) in GATES.items():
        config = jax_default_config(**{**TRAINER, "max.epoch": 4, "eval.interval": 2, **extra})
        graph = tiny_social_graph if name in SOCIAL else tiny_graph
        rec = jax_recommender.GraphRecommender(jax_get_model(name, config), tiny_data, config,
                                               graph=graph, log=JaxLog(echo=False))
        rec.build()
        gates[case] = rec._can_fuse_epochs()
    chunks, seen = {}, []
    made = jax_recommender.make_epoch_fn
    jax_recommender.make_epoch_fn = lambda *a, steps_per_call=None, **k: seen.append(
        steps_per_call)
    try:
        for n_edges in CHUNK_EDGES:
            for batch in CHUNK_BATCHES:
                for max_steps in CHUNK_MAX_STEPS:
                    config = jax_default_config(**{"batch.size": batch,
                                                   "train.max_steps_per_call": max_steps})
                    jax_recommender.GraphRecommender(
                        _StubModel(config), tiny_data, config, graph=_StubGraph(n_edges),
                        log=JaxLog(echo=False)).build()
                    chunks[(n_edges, batch, max_steps)] = seen[-1]
    finally:
        jax_recommender.make_epoch_fn = made
    return {"gates": gates, "chunks": chunks}


def _model_and_params(name, graph, seed=0):
    model = build(name, default_config(**{"embedding.size": D, "NCL.num_clusters": 4}))
    params, state = model.init(torch.Generator().manual_seed(seed), graph)
    params = {k: v.requires_grad_() for k, v in params.items()}
    return model, params, state


def _begin(model, params, state, graph, seed, epoch):
    return model.epoch_begin(params, state, graph, torch.Generator().manual_seed(seed), epoch)


def _snapshot(params, optimizer, state, loss):
    moments = [{k: v.clone() for k, v in optimizer.state[p].items()} for p in params.values()]
    return ({k: v.detach().clone() for k, v in params.items()}, moments,
            {k: v.clone() for k, v in state.items()}, loss.clone())


def _assert_same(got, want):
    (gp, gm, gs, gl), (wp, wm, ws, wl) = got, want
    for k in wp:
        assert torch.equal(gp[k], wp[k]), k
    for g, w in zip(gm, wm):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert gs.keys() == ws.keys()
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k
    assert torch.equal(gl, wl) or (gl.isnan() and wl.isnan())


def _two_epochs(name, graph, runner_steps=None, graphed=True):
    """Two epochs from the same start (NCL's E-step before each): through
    ``GraphedEpoch`` (capture off) or ``train_epoch``, from one generator.
    Returns each epoch's snapshot with the generator's state after it, and
    the runner."""
    model, params, state = _model_and_params(name, graph)
    optimizer = make_optimizer(default_config(), params)
    gen = torch.Generator().manual_seed(9)
    runner = (GraphedEpoch(model, optimizer, graph, params, B, steps_per_call=runner_steps)
              if graphed else None)
    out = []
    for epoch in range(2):
        state = _begin(model, params, state, graph, 100 + epoch, epoch)
        if runner is not None:
            state, loss = runner.run(state, gen)
        else:
            state, loss = train_epoch(model, optimizer, graph, params, state, gen, B)
        out.append((_snapshot(params, optimizer, state, loss), gen.get_state()))
    return out, runner


@pytest.mark.parametrize("name,backend", [("lightgcn", "dense"), ("lightgcn", "bucketed"),
                                          ("lightgcn", "segment"), ("ncl", "dense"),
                                          ("ncl", "bucketed")])
def test_graphed_epoch_is_train_epoch(graphs, name, backend):
    """With capture off the graphed epoch is ``train_epoch`` bit for bit:
    parameters, Adam's moments and step, the model's state and the loss,
    over two epochs (the second from the carried state, NCL's E-step
    between them)."""
    graph = graphs[backend]
    got, runner = _two_epochs(name, graph)
    want, _ = _two_epochs(name, graph, graphed=False)
    assert not runner.capture and runner.chunks is None and runner.captures == []
    for (g, g_gen), (w, w_gen) in zip(got, want):
        _assert_same(g, w)
        assert torch.equal(g_gen, w_gen)


def test_chunked_epoch_is_the_single_epoch(graphs):
    """``steps_per_call`` 3 cuts the tiny set's epoch into 3 + 3 + 2 steps:
    the same bits as the single epoch (the JAX package's
    ``test_chunked_epoch_matches_single_scan``, here bit for bit)."""
    graph = graphs["dense"]
    got, runner = _two_epochs("lightgcn", graph, runner_steps=3)
    want, single = _two_epochs("lightgcn", graph)
    assert single.chunks is None and runner.n_batches == 8
    assert runner.chunks == [(0, 3), (3, 3), (6, 2)]
    for (g, g_gen), (w, w_gen) in zip(got, want):
        _assert_same(g, w)
        assert torch.equal(g_gen, w_gen)


def test_the_carry_keeps_the_static_state(graphs):
    """A state handed in from outside (NCL's E-step) is copied into the
    static state: the run returns the same tensors every epoch, holding
    the new values."""
    graph = graphs["dense"]
    model, params, state = _model_and_params("ncl", graph)
    runner = GraphedEpoch(model, make_optimizer(default_config(), params), graph, params, B)
    gen = torch.Generator().manual_seed(3)
    first, _ = runner.run(_begin(model, params, state, graph, 1, 0), gen)
    fresh = _begin(model, params, first, graph, 2, 0)
    assert all(fresh[k] is not first[k] for k in fresh)
    second, _ = runner.run(fresh, gen)
    assert all(second[k] is first[k] for k in first)
    for k in fresh:
        assert torch.equal(second[k], fresh[k]), k
    with pytest.raises(ValueError, match="structure"):
        runner.run({k: v[:1] for k, v in fresh.items()}, gen)


def test_each_epoch_draws_its_words_inside_the_runner(graphs):
    """A chunked runner's sample body draws the epoch's words from the
    generator ``run`` is handed: its batches are ``epoch_batches`` of the
    words a replica of that generator gives (LightGCN's BPR step draws
    nothing after them), new words each epoch. The runner holds no word
    buffer, and refuses a generator on another device than its graph's."""
    graph = graphs["dense"]
    model, params, state = _model_and_params("lightgcn", graph)
    runner = GraphedEpoch(model, make_optimizer(default_config(), params), graph, params, B,
                          steps_per_call=3)
    draws, replica = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    seen = []
    for _ in range(2):
        runner.run(state, draws)
        want = epoch_batches(epoch_words(replica, graph, B), graph, B)[:4]
        assert all(torch.equal(got, w) for got, w in zip(runner.batches, want))
        seen.append([t.clone() for t in runner.batches])
    assert torch.equal(draws.get_state(), replica.get_state())
    assert not torch.equal(seen[0][0], seen[1][0]) and not torch.equal(seen[0][2], seen[1][2])
    assert not hasattr(runner, "words")
    with pytest.raises(ValueError, match="cannot feed"):
        runner.run(state, types.SimpleNamespace(device=torch.device("cuda")))


@pytest.mark.parametrize("mode", ["unchunked", "chunked", "fused"])
def test_trainer_epochs_are_train_epoch_from_its_generator(data, graphs, mode):
    """The trainer's epochs (its ``GraphedEpoch``, capture off: one piece,
    chunks of 3 steps, or fused blocks of 2 epochs) are ``train_epoch``'s
    from the trainer's device generator (``_draws``) bit for bit: the
    epoch losses and the generator's state after them. The host generator
    (``_gen``) gives each epoch its ``epoch_begin`` seed and no word."""
    extra = {"unchunked": {"train.fuse_epochs": False},
             "chunked": {"train.fuse_epochs": False, "train.max_steps_per_call": 2,
                         "train.steps_per_call": 3},
             "fused": {}}[mode]
    graph = graphs["dense"]
    rec = _trainer(data, graph, **{"max.epoch": 4, "eval.interval": 2, **extra})
    assert rec._can_fuse_epochs() == (mode == "fused")
    assert (rec._graphed.chunks is not None) == (mode == "chunked")
    params = {k: v.detach().clone().requires_grad_() for k, v in rec.params.items()}
    optimizer = make_optimizer(rec.config, params)
    draws, host = torch.Generator(), torch.Generator()
    draws.set_state(rec._draws.get_state())
    host.set_state(rec._gen.get_state())
    rec.train()
    want = [float(train_epoch(rec.model, optimizer, graph, params, {}, draws, rec.batch_size)[1])
            for _ in range(4)]
    assert [e["loss"] for e in rec.epoch_stats] == want
    assert torch.equal(rec._draws.get_state(), draws.get_state())
    for _ in range(4):
        torch.randint(0, 2**62, (1,), generator=host)
    assert torch.equal(rec._gen.get_state(), host.get_state())


def _trainer(data, graph, name="lightgcn", **extra):
    config = default_config(**{**TRAINER, **extra})
    rec = GraphRecommender(build(name, config), data, config, graph=graph, log=Log(echo=False),
                           device="cpu")
    rec.build()
    return rec


def _assert_same_runs(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert [e["loss"] for e in a.epoch_stats] == [e["loss"] for e in b.epoch_stats]
    assert a.history == b.history


def test_fused_trainer_is_the_unfused_one(data, graphs):
    """``eval.interval`` 3 over 5 epochs: blocks of 3 and 2 epochs, each
    read once, give the unfused trainer's bits, losses and evaluations
    (``test_fused_trainer_matches_unfused``)."""
    runs = {}
    for fuse in (False, "auto"):
        rec = _trainer(data, graphs["dense"], **{"max.epoch": 5, "eval.interval": 3,
                                                 "train.fuse_epochs": fuse})
        assert rec._can_fuse_epochs() == (fuse == "auto")
        rec.train()
        runs[fuse] = rec
    fused, unfused = runs["auto"], runs[False]
    assert sum("fused x3" in line for line in fused.log.contents()) == 3
    assert sum("fused x2" in line for line in fused.log.contents()) == 2
    assert [h["epoch"] for h in fused.history] == [2, 4]
    _assert_same_runs(fused, unfused)


def test_auto_chunking_is_unchunked(data, graphs):
    """Forcing the chunk rule low (``train.max_steps_per_call`` 2,
    ``train.steps_per_call`` 3) chunks every epoch and changes no bit
    (``test_trainer_auto_chunking_matches_unchunked``)."""
    runs = {}
    for extra in ({}, {"train.max_steps_per_call": 2, "train.steps_per_call": 3}):
        rec = _trainer(data, graphs["dense"], **{"max.epoch": 3, "eval.interval": 3, **extra})
        rec.train()
        runs[bool(extra)] = rec
    assert runs[False].steps_per_call is None and runs[False]._graphed.chunks is None
    assert runs[True].steps_per_call == 3 and runs[True]._graphed.chunks is not None
    _assert_same_runs(runs[True], runs[False])


@pytest.mark.parametrize("case", list(GATES))
def test_fuse_gate_is_the_jax_trainers(data, graphs, social_graph, jax_reference, case):
    """The fuse gate on the JAX tests' configurations and on every other
    model at its defaults: SEPT, SEPT-basic and ESRF keep ``epoch_begin``
    and run unfused, the rest fuse; every one runs its epochs as graphs."""
    name, extra = GATES[case]
    graph = social_graph if name in SOCIAL else graphs["dense"]
    rec = _trainer(data, graph, name, **{"max.epoch": 4, "eval.interval": 2, **extra})
    assert rec._graphed is not None
    assert rec._can_fuse_epochs() == jax_reference["gates"][case]
    if case in ZOO:
        assert rec._can_fuse_epochs() == (name not in ("sept", "sept_social", "sept_basic",
                                                       "esrf"))


def test_chunk_rule_is_the_jax_trainers(jax_reference):
    """The chunk length (None: one piece) on a grid of edge counts, batch
    sizes and ``train.max_steps_per_call``, both sides of each cut."""
    got = {}
    for n_edges, batch, max_steps in jax_reference["chunks"]:
        config = default_config(**{"batch.size": batch, "train.max_steps_per_call": max_steps})
        got[(n_edges, batch, max_steps)] = steps_per_call(n_edges, batch, config)
    assert got == jax_reference["chunks"]
    assert None in got.values() and 32 in got.values()


# the configurations that drew in the step and ran eagerly before they were
# captured: their fused trainers (the converted refusal cases below) and
# their epochs (``test_graphed_epoch_is_train_epoch_for_the_drawing_steps``)
ONCE_EAGER = [("lightgcn", {"loss": "bce", "n_negs": 3}), ("lightgcn", {"loss": "pointwise"}),
              ("lightgcn", {"n_negs": 2}), ("ncl", {"NCL.e_step_cadence": "batch"})]


@pytest.mark.parametrize("name,extra", ONCE_EAGER)
def test_fuse_epochs_true_refuses_an_eager_model(data, graphs, name, extra):
    """The configurations whose step draws in the step used to train
    eagerly and refuse ``train.fuse_epochs: true``. Now every one captures
    its epochs, so no single-device trainer is eager: with the flag on, the
    trainer gives the unfused trainer's bits, fused where the gate lets it
    (LightGCN's; NCL keeps ``epoch_begin``). The one eager trainer, the
    sharded one, still refuses the flag
    (``tests/test_torch_parallel_trainer.py``)."""
    runs = {}
    for fuse in (False, True):
        rec = _trainer(data, graphs["dense"], name, **{"max.epoch": 4, "eval.interval": 2,
                                                       "train.fuse_epochs": fuse, **extra})
        assert rec._graphed is not None
        rec.train()
        runs[fuse] = rec
    fused = runs[True]
    assert fused._can_fuse_epochs() == (name == "lightgcn")
    assert sum("fused x2" in line for line in fused.log.contents()) == (
        4 if name == "lightgcn" else 0)
    _assert_same_runs(fused, runs[False])


def _bold_sgd(params):
    """The bold driver's SGD: torch's fused SGD, its rate a tensor."""
    return make_bold_driver_optimizer(
        default_config(**{"optimizer": "sgd", "learning.rate": 0.05}), params)[0]


@pytest.mark.parametrize("case", ["pointwise", "bce_n_negs_3", "ncl_batch_e_step", "bold_sgd"])
def test_graphed_epoch_is_train_epoch_for_the_drawing_steps(graphs, case):
    """The configurations that were eager: LightGCN's pointwise loss and
    ``n_negs`` 3 (the negatives drawn in the step), NCL's per-batch E-step
    (the state produced in every step) and the bold driver's SGD (its
    tensor rate moved between the epochs). With capture off, two
    consecutive ``GraphedEpoch`` epochs equal two ``train_epoch`` epochs bit
    for bit: parameters, the optimizer's state, the model's state, the
    losses and the generator's state (the words', then the losses' draws,
    one generator as in the trainer). The steps that draw move it past
    where the words alone leave it; the bold driver's BPR step does not."""
    name, extra = {"pointwise": ("lightgcn", {"loss": "pointwise"}),
                   "bce_n_negs_3": ("lightgcn", {"loss": "bce", "n_negs": 3}),
                   "ncl_batch_e_step": ("ncl", {"NCL.e_step_cadence": "batch"}),
                   "bold_sgd": ("lightgcn", {})}[case]
    graph = graphs["dense"]
    runs = []
    for graphed in (True, False):
        model = build(name, default_config(**{"embedding.size": D, "NCL.num_clusters": 4,
                                              **extra}))
        params, state = model.init(torch.Generator().manual_seed(0), graph)
        params = {k: v.requires_grad_() for k, v in params.items()}
        optimizer = (_bold_sgd(params) if case == "bold_sgd"
                     else make_optimizer(default_config(), params))
        draws = torch.Generator().manual_seed(10)
        runner = GraphedEpoch(model, optimizer, graph, params, B) if graphed else None
        out = []
        for epoch in range(2):
            set_learning_rate(optimizer, [0.05, 0.0525][epoch])
            if runner is not None:
                state, loss = runner.run(state, draws)
            else:
                state, loss = train_epoch(model, optimizer, graph, params, state, draws, B)
            out.append((_snapshot(params, optimizer, state, loss), draws.get_state()))
        runs.append(out)
    for (got, got_draws), (want, want_draws) in zip(*runs):
        _assert_same(got, want)
        assert torch.equal(got_draws, want_draws)
    words_only = torch.Generator().manual_seed(10)
    epoch_words(words_only, graph, B)
    past_words = not torch.equal(runs[0][0][1], words_only.get_state())
    assert past_words == (case != "bold_sgd")


def test_tensor_rate_sgd_is_torch_sgd_and_optax_sgd():
    """The bold driver's SGD (``make_bold_driver_optimizer``: torch's fused
    SGD with a tensor rate, what a captured step reads) against
    ``torch.optim.SGD`` with the float rate, bit for bit over five steps
    with the rate moved after two, and against
    ``optax.inject_hyperparams(optax.sgd)`` (the JAX package's bold-driver
    SGD, jitted) within the f32 bound: XLA computes optax's trace in one
    fused multiply-add and its update in two roundings, torch's SGD the
    reverse, so the two differ in the last place (the f32 bound, rtol 1e-5 /
    atol 1e-6)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(37, 64)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    rates = [0.0137, 0.0137, 0.0137 * 1.05, 0.0137 * 1.05, 0.0137 * 0.525]
    leaves = [torch.from_numpy(p0.copy()).requires_grad_() for _ in range(2)]
    ours, _ = make_bold_driver_optimizer(
        default_config(**{"optimizer": "sgd", "learning.rate": rates[0], "momentum": 0.9}),
        {"w": leaves[0]})
    torch_sgd = torch.optim.SGD([leaves[1]], lr=rates[0], momentum=0.9)
    rate = ours.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.dtype == torch.float32
    assert ours.param_groups[0]["fused"] and type(ours) is torch.optim.SGD
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=rates[0], momentum=0.9)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    update = jax.jit(lambda g, st, p: opt.update(g, st, p))
    for g, lr in zip(grads, rates):
        set_learning_rate(ours, lr)
        set_learning_rate(torch_sgd, lr)
        st.hyperparams["learning_rate"] = jnp.asarray(lr)
        for leaf in leaves:
            leaf.grad = torch.from_numpy(g)
        ours.step()
        torch_sgd.step()
        upd, st = update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        assert ours.param_groups[0]["lr"] is rate
        assert torch.equal(leaves[0], leaves[1])
        assert torch.equal(ours.state[leaves[0]]["momentum_buffer"],
                           torch_sgd.state[leaves[1]]["momentum_buffer"])
    np.testing.assert_allclose(leaves[0].detach().numpy(), np.asarray(jax.block_until_ready(p)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.state[leaves[0]]["momentum_buffer"].numpy(),
                               np.asarray(st.inner_state[0].trace), rtol=1e-5, atol=1e-6)


def test_a_chunk_takes_a_step_and_the_cpu_adam_is_eager(graphs):
    graph = graphs["dense"]
    model, params, _ = _model_and_params("lightgcn", graph)
    with pytest.raises(ValueError, match="steps_per_call"):
        GraphedEpoch(model, make_optimizer(default_config(), params), graph, params, B,
                     steps_per_call=0)
    assert not make_optimizer(default_config(), params).defaults["capturable"]


def test_a_tensor_rate_is_filled_in_place(graphs):
    """The bold driver's rate as a device tensor (the card's form): a new
    rate and a restored state dict fill it at its address."""
    graph = graphs["dense"]
    _, params, _ = _model_and_params("lightgcn", graph)
    opt, bold = make_bold_driver_optimizer(default_config(**{"adaptive.lr": True}), params)
    assert opt.param_groups[0]["lr"] == bold.lrate  # a float on the CPU
    rate = torch.tensor(1e-3)
    for group in opt.param_groups:
        group["lr"] = rate
    set_learning_rate(opt, 0.25)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == 0.25
    saved = copy.deepcopy(opt.state_dict())  # as a checkpoint holds it
    set_learning_rate(opt, 0.5)
    load_optimizer_state(opt, saved)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == 0.25


def test_counts_snapshot_restore_and_add():
    """The counters a capture records and a replay adds."""
    before = counts.launch_counts()
    assert (gather_rows, "launches") in before
    assert not any(name == "launches_per_call" for _, name in before)
    try:
        gather_rows.launches += 3
        delta = counts.count_delta(counts.launch_counts(), before)
        assert delta == {(gather_rows, "launches"): 3}
        counts.set_counts(before)
        assert counts.launch_counts() == before
        counts.add_launches(delta)
        counts.add_launches(delta)
        assert gather_rows.launches == before[(gather_rows, "launches")] + 6
    finally:
        counts.set_counts(before)


def test_adam_plain_is_optax():
    """``adam_plain``, optax.adam's arithmetic in f32 (what the card's
    capturable Adam is held to), against optax over five steps, and
    torch's CPU Adam within the f32 bound."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(37, 8)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    opt = optax.adam(1e-2)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
    got, mu, nu = adam_plain(torch.from_numpy(p0), [torch.from_numpy(g) for g in grads], 1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.block_until_ready(p)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mu.numpy(), np.asarray(st[0].mu), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(nu.numpy(), np.asarray(st[0].nu), rtol=1e-6, atol=1e-7)
    leaf = torch.from_numpy(p0.copy()).requires_grad_()
    adam = torch.optim.Adam([leaf], lr=1e-2, eps=1e-8)
    for g in grads:
        leaf.grad = torch.from_numpy(g)
        adam.step()
    torch.testing.assert_close(leaf.detach(), got, rtol=1e-5, atol=1e-6)
