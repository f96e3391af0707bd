"""GAT (``models/gat.py``) on the CPU against the JAX package's: the bucketed
GAT's slot maps and ``tpos`` bit for bit; ``gat_layer`` (the segment path)
and (tests/test_torch_gat_bucketed.py) ``gat_layer_bucketed_sf`` (the
bucketed path through ``AttentionPull``), values and gradients to x, w, a_src and a_dst, with the attention dropout
fed from one numpy stream on both sides (``jax.random.bernoulli`` and the
port's ``augment.uniform``); the per-bucket oracle ``gat_layer_bucketed``;
``attention_plain`` (autograd through the plain S1 and S2) against
``AttentionPull``; the bucketed GAT against the segment GAT (JAX
tests/test_bucketed.py:164-196) and its COO-padding case; one loss and its
gradients on the dense, segment and bucketed backends; two epochs through
``GraphRecommender``; the CLI's train and serve. The bucketed path's
layers are in tests/test_torch_gat_bucketed.py.

f32 rtol 1e-5 / atol 1e-6, the atol relative to the reference's largest
entry on outputs and gradients (the frameworks sum in other orders);
tables bit for bit. A layer's gradients to a_src and a_dst sum the
softmax's backward over every edge, att · (g − Σ att · g), whose sum over
a destination's edges is exactly 0, so they are ill-conditioned: two
correct f32 evaluations differ there by up to ~5e-6 of the largest entry.
So each layer also runs in float64 in the JAX package (``jax.enable_x64``,
same draws), and the port's f32 result is held to that exact value at
``NOISE_FACTOR`` times the larger of the f32 atol and the JAX package's own
f32 error against it (tests/test_torch_grace_gbt.py bounds G-BT's
gradients by that error in the same way).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models import gat as jgat
from recommendation_tpu.models.graphsage import bidirectional_edges as jax_edges
from recommendation_tpu_torch import cli
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.models import gat
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.serve import http
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import flatten_tree, params_from_jax

SMALL = {"embedding.size": 8, "GAT.hidden": 8, "GAT.num_heads": 2, "batch.size": 256}
# the JAX package's own f32 error (against its float64 evaluation) times this
# bounds the port's distance from it, where that error passes the f32 atol
NOISE_FACTOR = 4.0


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(got, want, err_msg="", want64=None):
    """Against the JAX package's f32 ``want`` at rtol 1e-5 and atol 1e-6 of
    its largest entry; with its float64 result ``want64``, against that at
    NOISE_FACTOR times the larger of the atol and the JAX package's own f32
    error."""
    w = _np(want)
    assert np.abs(w).max() > 0, err_msg
    atol = 1e-6 * np.abs(w).max()
    if want64 is not None:
        w, atol = want64, NOISE_FACTOR * max(atol, float(np.abs(w - want64).max()))
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5, atol=atol, err_msg=err_msg)


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


@pytest.fixture(scope="module")
def sets(tiny_data):
    return tiny_data, Interaction(tiny_data.training_data, tiny_data.test_data)


@pytest.fixture(scope="module")
def graphs(sets):
    jdata, data = sets
    return ({"dense": JaxDeviceGraph(jdata, backend="dense"),
             "bucketed": JaxDeviceGraph(jdata, backend="bucketed")},
            {b: DeviceGraph(data, backend=b, device="cpu")
             for b in ("dense", "segment", "bucketed")})


def _padded_data():
    """5 interactions: the square nnz is 10, not a multiple of the pad, so
    ``from_scipy`` adds zero-valued COO entries with valid edge ids."""
    train = [[f"u{i}", f"i{i % 3}", 1.0] for i in range(5)]
    test = [["u0", "i1", 1.0]]
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.mark.parametrize("which", ["tiny", "padded"])
def test_gat_aux_matches_jax(graphs, which):
    if which == "tiny":
        jgraph, graph = graphs[0]["bucketed"], graphs[1]["bucketed"]
    else:
        jdata, data = _padded_data()
        jgraph = JaxDeviceGraph(jdata, backend="bucketed")
        graph = DeviceGraph(data, backend="bucketed", device="cpu")
    want, got = jgraph.ensure_gat_aux(), graph.ensure_gat_aux()
    for k in ("pos_map", "slot_node", "node_of_row"):
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), _np(want[k])), k
    tpos = np.concatenate([_np(t).reshape(-1) for t in want["tpos"]])
    assert np.array_equal(got["tpos"].numpy(), tpos)
    assert graph.ensure_gat_aux() is got  # built once, kept on the graph


@pytest.mark.parametrize("which", ["tiny", "padded"])
@pytest.mark.parametrize("path", ["segment", "bucketed"])
def test_live_transpose_slots_map_one_to_one(graphs, which, path):
    """The fused backward pull writes ``datt`` at each live transpose slot's
    forward slot: the live slots of the two views must map one to one
    through ``t2f``, onto the same edge (its destination is the slot's
    gathered node, its source the transpose row's node), and the dead ones
    are -1 in ``t_fpos``."""
    if which == "tiny":
        graph = graphs[1]["bucketed" if path == "bucketed" else "segment"]
    else:
        graph = DeviceGraph(_padded_data()[1], backend="bucketed" if path == "bucketed"
                            else "segment", device="cpu")
    st = gat.attention_structure(graph)
    live, t_live = st.live.numpy(), st.t_live.numpy()
    fpos, t2f = st.t_fpos.numpy(), st.t2f.numpy()
    assert live.sum() == t_live.sum() > 0
    assert np.array_equal(np.sort(fpos[t_live]), np.nonzero(live)[0])
    assert np.all(fpos[~t_live] == -1) and np.array_equal(fpos[t_live], t2f[t_live])
    rows = np.repeat(np.arange(len(st.t_row_ptr) - 1), np.diff(st.t_row_ptr.numpy()))
    nodes = rows if st.t_node is None else st.t_node.numpy()[rows]
    assert np.array_equal(st.dst.numpy()[fpos[t_live]], st.t_idx.numpy()[t_live])
    assert np.array_equal(st.idx.numpy()[fpos[t_live]], nodes[t_live])
    if path == "bucketed":  # tpos sends every padding slot (edge -1) to edge 0's slot
        pad = graph.norm_adj.pull_t.edge.numpy() < 0
        assert pad.sum() > 1 and np.all(t2f[pad] == graph.ensure_gat_aux()["pos_map"][0].item())


def _layer_inputs(n, heads, d_in=6, d=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d_in)).astype(np.float32),
            (rng.normal(size=(d_in, heads * d)) * 0.5).astype(np.float32),
            rng.normal(size=(heads, d)).astype(np.float32),
            rng.normal(size=(heads, d)).astype(np.float32),
            rng.normal(size=(n, heads * d)).astype(np.float32))


def _check_layer(monkeypatch, jax_fn, port_fn, n, heads, drop, plain=False):
    """``port_fn`` against ``jax_fn`` on the same inputs and draws: the
    output and the gradients of Σ out · c to x, w, a_src and a_dst."""
    inputs = _layer_inputs(n, heads)
    c = inputs[-1]
    draws = Draws(3)
    rng = jax.random.PRNGKey(1) if drop > 0 else None

    def run(dtype):
        def loss(*a):
            out = jax_fn(*a, rng, drop)
            return jnp.sum(out * c.astype(dtype)), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(a, dtype) for a in inputs[:4]))
        return out, grads

    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = run(jnp.float32)
    with monkeypatch.context() as mp, jax.enable_x64(True):
        draws.replay_jax(mp)  # the same draws, the inputs widened
        want64, want_g64 = (jax.device_get(t) for t in run(jnp.float64))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs[:4]]
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        got = port_fn(*ts, torch.Generator() if drop > 0 else None, drop, plain)
    assert draws.pos == len(draws.seq) > 0 or drop == 0
    _close(got, want, "out", want64)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(c)), ts)
    for g, wg, wg64, name in zip(grads, want_g, want_g64, ("x", "w", "a_src", "a_dst")):
        _close(g, wg, name, wg64)


@pytest.mark.parametrize("backend", ["dense", "segment"])
@pytest.mark.parametrize("heads,drop", [(1, 0.0), (4, 0.0), (4, 0.3), (1, 0.5), (3, 0.0),
                                        (3, 0.3)])
@pytest.mark.parametrize("plain", [False, True], ids=["function", "plain"])
def test_gat_layer_matches_jax(graphs, monkeypatch, backend, heads, drop, plain):
    jgraph, graph = graphs[0]["dense"], graphs[1][backend]
    src, dst, mask = jax_edges(jgraph)
    st = gat.segment_attention(graph)
    _check_layer(
        monkeypatch,
        lambda x, w, a, b, rng, p: jgat.gat_layer(x, src, dst, mask, jgraph.n_nodes, w, a, b,
                                                  heads, 0.2, rng, p),
        lambda x, w, a, b, g, p, pl: gat.gat_layer(x, st, graph.n_nodes, w, a, b, heads, 0.2,
                                                   g, p, plain=pl),
        graph.n_nodes, heads, drop, plain)


def _eval_tables(model_cls, params, graph):
    u, i = model_cls(default_config(**SMALL)).eval_embeddings(params, {}, graph)
    return np.concatenate([u.numpy(), i.numpy()])


@pytest.mark.parametrize("which", ["tiny", "padded"])
def test_bucketed_gat_matches_segment_gat(graphs, which):
    """No dropout: the bucketed path's tables equal the segment path's
    (dense and segment backends), and the JAX package's. The padded set's
    zero-valued COO entries are no neighbours on the bucketed path."""
    if which == "tiny":
        jdata = None
        jgraphs, ours = graphs
        jgraph = jgraphs["bucketed"]
    else:
        jdata, data = _padded_data()
        assert jdata.norm_adj.nnz % 8 != 0
        jgraph = JaxDeviceGraph(jdata, backend="bucketed")
        ours = {b: DeviceGraph(data, backend=b, device="cpu")
                for b in ("dense", "segment", "bucketed")}
    jm = jgat.GAT(jax_default_config(**SMALL))
    params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
    want = np.concatenate([_np(t) for t in jax.jit(
        lambda q: jm.eval_embeddings(q, {}, jgraph))(params)])
    p = params_from_jax("gat", jax.device_get(params), device="cpu")
    tables = {b: _eval_tables(gat.GAT, p, g) for b, g in ours.items()}
    for b, t in tables.items():
        np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=b)
    np.testing.assert_allclose(tables["bucketed"], tables["segment"], atol=1e-4)


@pytest.mark.parametrize("backend", ["dense", "segment", "bucketed"])
def test_step_matches_jax(graphs, monkeypatch, backend):
    """One loss and its gradients with the four dropout draws (features,
    layer 1's attention, hidden features, layer 2's attention) from one
    numpy stream; the eval tables."""
    jgraph = graphs[0]["bucketed" if backend == "bucketed" else "dense"]
    graph = graphs[1][backend]
    jm = jgat.GAT(jax_default_config(**SMALL))
    params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = [np.array(a[0]) for a in js.epoch_batches(k1, k2, jgraph, 256)[:4]]
    draws = Draws(7)
    with monkeypatch.context() as mp:
        draws.patch_jax(mp)
        want, want_g = jax.jit(jax.value_and_grad(lambda q: jm.loss(
            q, {}, js.PairwiseBatch(*map(jnp.asarray, arrays)), jgraph,
            jax.random.PRNGKey(2))[0]))(params)
    want_g = flatten_tree(want_g)
    model = build("gat", default_config(**SMALL))
    mine, _ = model.init(torch.Generator().manual_seed(0), graph)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in flatten_tree(jax.device_get(params)).items()}
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("gat", jax.device_get(params), device="cpu").items()}
    with monkeypatch.context() as mp:
        draws.patch_port(mp)
        loss, _ = model.loss(p, {}, PairwiseBatch(*map(torch.from_numpy, arrays)), graph,
                             torch.Generator().manual_seed(0))
    assert draws.pos == len(draws.seq) == 4
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=1e-6)
    for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
        _close(g, want_g[k], k)


def test_trains_two_epochs(sets):
    _, data = sets
    cfg = default_config(**{**SMALL, "max.epoch": 2, "item.ranking.topN": [20],
                            "graph.backend": "bucketed"})
    rec = GraphRecommender(build("gat", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses = [e["loss"] for e in rec.epoch_stats]
    assert len(losses) == 2 and losses[1] < losses[0] and all(np.isfinite(losses))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_cli_trains_and_serves(tmp_path, monkeypatch, capsys):
    train, test = make_hard_dataset(n_users=90, n_items=150, n_interactions=2500, seed=5)
    write_dataset(str(tmp_path), train, test)
    args = ["--model", "gat", "--train", str(tmp_path / "train.txt"), "--test",
            str(tmp_path / "test.txt"), "--set", "batch.size=512", "--set", "embedding.size=16",
            "--set", "GAT.hidden=8", "--set", "max.epoch=1", "--device", "cpu"]
    assert cli.main(["train", *args, "--set", "graph.backend=segment"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", *args]) == 0
    (service,) = served
    assert np.isfinite(service.recommend_ids([0, 1], 5)[0]).all()
