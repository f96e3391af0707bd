"""The port's rating evaluation, linear probes and profiling utilities
against the JAX package's (``recommendation_tpu/evalx/{rating,probe}.py``,
``utils/profiling.py``).

``evaluate_rating`` on the same tables within the f32 bound (its dot
products sum in another order); ``get_split`` and ``f1_scores`` bit for
bit; the LR and SVM probes from the same initial weights (JAX's
``jax.random.normal`` draw replaced by a numpy draw that the port's draw
``probe._normal`` replays), trained 100 epochs: ``w`` and ``b`` within rtol
1e-4 (AdamW's decoupled decay rounds in another order), the same predicted
classes, micro-F1 above 0.9 on well-separated clusters; ``profile_trace``
writes a trace file on the CPU; ``Throughput`` counts examples/s."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.evalx.probe as jax_probe
from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.evalx.rating import evaluate_rating as jax_evaluate_rating
from recommendation_tpu.evalx.rating import global_mean as jax_global_mean
from recommendation_tpu.utils.profiling import Throughput as JaxThroughput
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx import probe
from recommendation_tpu_torch.evalx.rating import evaluate_rating, global_mean
from recommendation_tpu_torch.utils.profiling import Throughput, profile_trace


@pytest.fixture(scope="module")
def rated():
    """Triples with ratings 1..5 (some test pairs unseen in training) and
    embedding tables of the training ids."""
    rng = np.random.default_rng(4)
    users, items = rng.integers(0, 40, 900), rng.integers(0, 70, 900)
    ratings = rng.integers(1, 6, 900).astype(float)
    triples = [[f"u{u}", f"i{i}", r] for u, i, r in zip(users, items, ratings)]
    train, test = triples[:700], triples[700:] + [["u999", "i1", 3.0], ["u1", "i999", 4.0]]
    data, ref = Interaction(train, test), JaxInteraction(train, test)
    ue = rng.normal(size=(data.user_num, 16)).astype(np.float32) * 0.6
    ie = rng.normal(size=(data.item_num, 16)).astype(np.float32) * 0.6
    return data, ref, ue, ie


@pytest.mark.parametrize("clip", [None, (1.0, 5.0)])
def test_evaluate_rating_matches_jax(rated, clip):
    data, ref, ue, ie = rated
    assert global_mean(data) == jax_global_mean(ref)
    got = evaluate_rating(torch.from_numpy(ue), torch.from_numpy(ie), data, clip=clip)
    want = jax_evaluate_rating(ue, ie, ref, clip=clip)
    assert got.keys() == want.keys() == {"MAE", "RMSE"}
    for k in want:  # both reports are rounded to 5 decimals
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1.01e-5)
    assert evaluate_rating(ue, ie, data, clip=clip) == got  # numpy tables too


def test_split_and_f1_equal_jax():
    for n, seed in ((100, 0), (37, 5)):
        got, want = probe.get_split(n, seed=seed), jax_probe.get_split(n, seed=seed)
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(1)
    y, p = rng.integers(0, 4, 200), rng.integers(0, 4, 200)
    p[:3] = 5  # a class the truth never has
    for n_classes in (4, 6):
        assert probe.f1_scores(y, p, n_classes) == jax_probe.f1_scores(y, p, n_classes)
    assert probe.f1_scores([], [], 3) == jax_probe.f1_scores([], [], 3)


@pytest.fixture(scope="module")
def clusters():
    """Four well-separated Gaussian clusters in 12 dimensions."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 12)) * 4.0
    y = rng.integers(0, 4, 600)
    z = (centers[y] + rng.normal(size=(600, 12))).astype(np.float32)
    return z, y, probe.get_split(600, train_ratio=0.3, test_ratio=0.6, seed=2)


def _same_draw(monkeypatch, d, n_classes):
    """The JAX and the port draws replaced by one numpy N(0, 1) draw."""
    draw = np.random.default_rng(9).normal(size=(d, n_classes)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(draw))
    monkeypatch.setattr(probe, "_normal", lambda shape, seed: torch.from_numpy(draw.copy()))


@pytest.mark.parametrize("kind,wd", [("logreg", 0.0), ("hinge", 1e-4), ("logreg", 1e-2)])
def test_probe_training_matches_jax(monkeypatch, clusters, kind, wd):
    z, y, split = clusters
    _same_draw(monkeypatch, z.shape[1], 4)
    tr = split["train"]
    w_j, b_j = jax_probe._train_linear(jnp.asarray(z[tr]), jnp.asarray(y[tr]), 4, kind, 100,
                                      0.01, wd, 0)
    w, b = probe._train_linear(torch.from_numpy(z[tr]), torch.from_numpy(y[tr]).long(), 4, kind,
                               100, 0.01, wd, 0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-6)
    pred = torch.argmax(torch.from_numpy(z) @ w + b, dim=1).numpy()
    assert np.array_equal(pred, np.asarray(jnp.argmax(jnp.asarray(z) @ w_j + b_j, axis=1)))


@pytest.mark.parametrize("evaluator", ["LREvaluator", "SVMEvaluator"])
def test_probes_separate_the_clusters(monkeypatch, clusters, evaluator):
    z, y, split = clusters
    _same_draw(monkeypatch, z.shape[1], 4)
    got = getattr(probe, evaluator)(num_epochs=100, device="cpu")(z, y, split)
    want = getattr(jax_probe, evaluator)(num_epochs=100)(z, y, split)
    assert got == want and got["micro_f1"] > 0.9
    # tensors in, and the generator's own draw: the same quality
    monkeypatch.undo()
    again = getattr(probe, evaluator)(num_epochs=100, device="cpu")(
        torch.from_numpy(z), y, split, seed=3)
    assert again["micro_f1"] > 0.9


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")) as prof:
        for _ in range(3):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert sum(e.key == "aten::mm" for e in prof.key_averages()) == 1


def test_throughput_counts_like_jax():
    for cls in (Throughput, JaxThroughput):
        t = cls(n_devices=2)
        t.add(1000)
        time.sleep(0.01)
        rate = t.examples_per_s
        assert 0 < rate < 1000 / 0.01 and t.examples_per_s_per_chip <= rate / 2 * 1.01
        t.reset()
        assert t._examples == 0
