"""DirectAU (``models/directau.py``) and its losses (``losses.py``) on the CPU
against the JAX package's: ``alignment_loss``, ``uniformity_loss`` and
``direct_au_loss`` with their gradients; ``uniformity_streaming`` against
the materialized form from 4096 rows on; DirectAU's loss and gradients to
both tables on the dense backend (f32 and bf16) and on the bucketed one
(the row-space chain over the binarized adjacency, P1's value path), with
the reference script's composition and without, over the raw and the
normalized adjacency; the trainer and the CLI's train and serve.

Inputs are made with numpy from a seed. Tolerances: f32 rtol 1e-5 / atol
1e-6 on losses and on the losses' own gradients (whose entries come from
pair distances that cancel, so their f32 noise is set by the terms, not by
the sum; each such gradient is checked to reach 100 x the atol); a model's
gradients at rtol 1e-5 with atol 1e-6 relative to the JAX gradient's
largest entry; in bf16 the bound of tests/test_pallas_prop.py (rtol 3e-2 /
atol 3e-3 relative), since the frameworks round the cotangent at other
places.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.losses as jl
import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.directau import DirectAU as JaxDirectAU
from recommendation_tpu.ops.pallas_losses import uniformity_streaming as jax_streaming
from recommendation_tpu_torch import losses
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset, write_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import available, build
from recommendation_tpu_torch.models.directau import DirectAU
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log
from recommendation_tpu_torch.weights import params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
SMALL = {"embedding.size": 16, "batch.size": 256}


def _np(x):
    return np.asarray(jax.device_get(x))


def _grad_close(got, want, bf16=False):
    w = _np(want)
    rtol, atol = (3e-2, 3e-3) if bf16 else (1e-5, 1e-6)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=rtol, atol=atol * np.abs(w).max())


@pytest.mark.parametrize("n,d", [(37, 8), (256, 16), (3, 4)])
def test_losses_and_grads_match_jax(n, d):
    rng = np.random.default_rng(n + d)
    x, y = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    x[0] = 0.0  # a zero row: the zero-safe normalization
    for name, ours, ref in (
        ("align", lambda a, b: losses.alignment_loss(a, b), lambda a, b: jl.alignment_loss(a, b)),
        ("uniform", lambda a, b: losses.uniformity_loss(a) + losses.uniformity_loss(b, t=3.0),
         lambda a, b: jl.uniformity_loss(a) + jl.uniformity_loss(b, t=3.0)),
        ("direct_au", lambda a, b: losses.direct_au_loss(a, b, 0.7),
         lambda a, b: jl.direct_au_loss(a, b, 0.7)),
    ):
        a, b = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
        got = ours(a, b)
        want, want_g = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(got.item(), float(want), **TIGHT, err_msg=name)
        for g, w in zip(torch.autograd.grad(got, (a, b)), want_g):
            w = _np(w)
            assert np.abs(w).max() > 1e-4, name
            np.testing.assert_allclose(g.numpy(), w, **TIGHT, err_msg=name)


@pytest.mark.parametrize("n,block_n", [(4096, 1024), (5000, 1024), (4500, 700)])
def test_uniformity_streaming_matches_the_materialized_form(monkeypatch, n, block_n):
    """From 4096 rows ``uniformity_loss`` streams [N, 1024] blocks; the sum
    equals the [N, N] form's, and the JAX package's streaming one, value and
    gradient. A ragged last block (5000, 4500 rows) and another block size.
    The gradients (entries of order 1/N) are compared for 4096 x the loss,
    a power of two, so that the f32 atol 1e-6 sits well below them."""
    scale = 4096.0
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    xs = torch.from_numpy(x).requires_grad_()
    streamed = losses.uniformity_loss(xs) if block_n == 1024 else \
        losses.uniformity_streaming(xs, block_n=block_n)
    (g_s,) = torch.autograd.grad(streamed * scale, xs)
    monkeypatch.setattr(losses, "UNIFORMITY_STREAMING_ROWS", 10**9)
    xm = torch.from_numpy(x).requires_grad_()
    materialized = losses.uniformity_loss(xm)
    (g_m,) = torch.autograd.grad(materialized * scale, xm)
    np.testing.assert_allclose(streamed.item(), materialized.item(), **TIGHT)
    assert g_m.abs().max() > 1e-2
    np.testing.assert_allclose(g_s.numpy(), g_m.numpy(), **TIGHT)
    want, want_g = jax.value_and_grad(
        lambda v: jax_streaming(v, block_n=block_n) * scale)(jnp.asarray(x))
    np.testing.assert_allclose(streamed.item() * scale, float(want), **TIGHT)
    np.testing.assert_allclose(g_s.numpy(), _np(want_g), **TIGHT)
    if block_n == 1024:  # the JAX package's own dispatch streams here too
        np.testing.assert_allclose(float(jl.uniformity_loss(jnp.asarray(x))), streamed.item(),
                                   **TIGHT)


@pytest.fixture(scope="module")
def hard_sets():
    """A small hard set (the chip's DirectAU gate set, cut down) as the JAX
    and the port's interactions."""
    from recommendation_tpu.data.interaction import Interaction as JaxInteraction

    train, test = make_hard_dataset(n_users=120, n_items=200, n_interactions=4000, seed=3)
    return JaxInteraction(train, test), Interaction(train, test)


@pytest.fixture(scope="module")
def graphs(hard_sets):
    jdata, data = hard_sets
    out = {}
    for backend, dtype in (("dense", "float32"), ("dense", "bfloat16"), ("bucketed", "float32")):
        out[backend, dtype] = (JaxDeviceGraph(jdata, backend=backend, compute_dtype=dtype),
                               DeviceGraph(data, backend=backend, compute_dtype=dtype,
                                           device="cpu"))
    return out


CASES = [("dense", "float32", {}), ("dense", "bfloat16", {}), ("bucketed", "float32", {}),
         ("dense", "float32", {"DirectAU.neg_composition": False, "DirectAU.gamma": 0.5}),
         ("bucketed", "float32", {"DirectAU.normalize_adj": True, "DirectAU.n_layers": 3}),
         ("dense", "float32", {"DirectAU.normalize_adj": True})]


@pytest.mark.parametrize("backend,dtype,extra", CASES)
def test_loss_and_grads_match_jax(graphs, backend, dtype, extra):
    jgraph, graph = graphs[backend, dtype]
    cfg = {**SMALL, **extra}
    jm = JaxDirectAU(jax_default_config(**cfg))
    params, _ = jm.init(jax.random.PRNGKey(0), jgraph)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    arrays = js.epoch_batches(k1, k2, jgraph, 256)
    jbatch = js.PairwiseBatch(*(a[0] for a in arrays[:4]))
    batch = PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in arrays[:4]))
    want, want_g = jax.value_and_grad(
        lambda p: jm.loss(p, {}, jbatch, jgraph, jax.random.PRNGKey(2))[0])(params)
    p = {k: v.requires_grad_() for k, v in
         params_from_jax("directau", jax.device_get(params), device="cpu").items()}
    model = build("directau", default_config(**cfg))
    loss, state = model.loss(p, {}, batch, graph)
    assert state == {}
    np.testing.assert_allclose(loss.item(), float(want), **TIGHT)
    for g, name in zip(torch.autograd.grad(loss, list(p.values())), p):
        _grad_close(g, want_g[name], bf16=dtype == "bfloat16")
    for a, b in zip(model.eval_embeddings(p, {}, graph),
                    jm.eval_embeddings(params, {}, jgraph)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), _np(b), **TIGHT)


def test_bucketed_takes_the_value_path_chain(graphs):
    """On the bucketed backend the binarized adjacency keeps the row space
    and drops the separable scales, is built once per graph, and the
    encoder is the row-space chain (``BucketedChainMean``)."""
    _, graph = graphs["bucketed", "float32"]
    model = build("directau", default_config(**SMALL))
    adj = model._adj(graph)
    assert adj is model._adj(graph)
    assert adj.sym_rowspace and adj.pull.sep_dst is None and adj.pull_t.sep_dst is None
    assert graph.norm_adj.pull.sep_dst is not None
    params, _ = model.init(torch.Generator().manual_seed(0), graph)
    u, _ = model.propagate({k: v.requires_grad_() for k, v in params.items()}, graph)
    assert type(u.grad_fn).__name__.startswith("SliceBackward")
    assert "BucketedChainMean" in type(u.grad_fn.next_functions[0][0]).__name__


def test_config_matches_jax():
    for cfg in ({}, {"DirectAU.gamma": 2.5, "DirectAU.n_layers": 4,
                     "DirectAU.neg_composition": False, "DirectAU.normalize_adj": True}):
        ours, ref = DirectAU(default_config(**cfg)), JaxDirectAU(jax_default_config(**cfg))
        for attr in ("gamma", "n_layers", "neg_composition", "normalize_adj", "emb_size", "reg"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
    assert (ours.gamma, ours.n_layers) == (2.5, 4)
    defaults = DirectAU(default_config())
    assert (defaults.gamma, defaults.n_layers, defaults.neg_composition,
            defaults.normalize_adj) == (1.0, 2, True, False)
    assert "directau" in available()


@pytest.mark.parametrize("backend", ["dense", "bucketed"])
def test_trains_on_both_backends(hard_sets, backend):
    _, data = hard_sets
    cfg = default_config(**{**SMALL, "max.epoch": 3, "eval.interval": 1,
                            "graph.backend": backend, "item.ranking.topN": [20]})
    rec = GraphRecommender(build("directau", cfg), data, cfg, log=Log(echo=False), device="cpu")
    metrics = rec.execute()
    losses_ = [e["loss"] for e in rec.epoch_stats]
    assert rec.graph.backend == backend and len(losses_) == 3 and losses_[-1] < losses_[0]
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())


def test_cli_trains_and_serves_directau(hard_sets, tmp_path):
    _, data = hard_sets
    write_dataset(str(tmp_path), data.training_data, data.test_data)
    sets = ["--train", str(tmp_path / "train.txt"), "--test", str(tmp_path / "test.txt"),
            "--set", "batch.size=512", "--set", "embedding.size=16", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "recommendation_tpu_torch", "train", "--model",
                          "directau", "--set", "max.epoch=2", "--set",
                          f"checkpoint.dir={tmp_path / 'ckpt'}", *sets],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    listed = subprocess.run([sys.executable, "-m", "recommendation_tpu_torch", "models"],
                            capture_output=True, text=True, timeout=120)
    assert "directau" in listed.stdout.split()
    from recommendation_tpu_torch.cli import build_service

    service = build_service("directau", str(tmp_path / "ckpt"),
                            default_config(**{"embedding.size": 16}), data.training_data,
                            data.test_data, device="cpu")
    scores, ids = service.recommend_ids([0, 1, 2], 5)
    assert scores.shape == ids.shape == (3, 5) and np.isfinite(scores).all()
