"""The serving slice as a whole, on the CPU: JAX LightGCN parameters carried
into the port with ``params_from_jax``; the port's service (direct, through
the MicroBatcher, over HTTP) must recommend what the JAX service built from
``LightGCN.eval_embeddings`` recommends, with the same metrics.

Scores agree within 1e-6 (embeddings at rtol 1e-5 / atol 1e-6, then an f32
dot product over d=64); ids are compared wherever scores are separated."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.evalx.ranking import evaluate_ranking as jax_evaluate_ranking
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu.serve.service import RecommenderService as JaxRecommenderService
from recommendation_tpu_torch.cli import build_service
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.ranking import evaluate_ranking
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.serve.http import serve_http
from recommendation_tpu_torch.serve.service import RecommenderService
from recommendation_tpu_torch.ops.topk import topk_agree
from recommendation_tpu_torch.weights import load_params, params_from_jax, save_params

SCORE_TOL = 1e-6
K = 10


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, tiny_data):
    """(JAX service, port service, port data, JAX params as numpy) for one
    compute dtype, built from the same triples and the same parameters."""
    dtype = request.param
    config = jax_default_config()
    jax_graph = JaxDeviceGraph(tiny_data, backend="dense", compute_dtype=dtype)
    model = JaxLightGCN(config)
    params, state = model.init(jax.random.PRNGKey(0), jax_graph)
    ju, ji = model.eval_embeddings(params, state, jax_graph)
    jax_service = JaxRecommenderService(ju, ji, tiny_data, jax_graph)
    params_np = jax.device_get(params)

    data = Interaction(tiny_data.training_data, tiny_data.test_data)
    graph = DeviceGraph(data, compute_dtype=dtype, device="cpu")
    ours = build("lightgcn", default_config())
    u, i = ours.eval_embeddings(params_from_jax("lightgcn", params_np, device="cpu"), {}, graph)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)
    return jax_service, RecommenderService(u, i, data, graph), data, params_np


def _as_arrays(results, data):
    scores = np.array([[r["score"] for r in row] for row in results], np.float32)
    ids = np.array([[data.get_item_id(r["item"]) for r in row] for row in results])
    return scores, ids


def test_recommend_matches_jax(pair):
    jax_service, service, data, _ = pair
    users = list(data.user)
    got = service.recommend(users + ["nope"], k=K)
    want = jax_service.recommend(users + ["nope"], k=K)
    assert got[-1] is None and want[-1] is None
    assert topk_agree(*_as_arrays(got[:-1], data), *_as_arrays(want[:-1], data), SCORE_TOL)
    # no train positive is recommended
    for user, row in zip(users, got):
        assert not {r["item"] for r in row} & set(data.training_set_u[user])


def test_recommend_ids_types_and_no_exclusion(pair):
    jax_service, service, _, _ = pair
    uids = [0, 3, 7, 3]
    for excl in (True, False):
        s, i = service.recommend_ids(uids, K, exclude_seen=excl)
        s_ref, i_ref = jax_service.recommend_ids(uids, K, exclude_seen=excl)
        assert s.dtype == np.float32 and i.dtype == np.int32 and i.shape == (4, K)
        assert topk_agree(s, i, np.asarray(s_ref), np.asarray(i_ref), SCORE_TOL)


def test_microbatcher_matches_jax(pair):
    jax_service, service, data, _ = pair
    uids = list(range(data.user_num))[:24]
    s_ref, i_ref = jax_service.recommend_ids(uids, K)
    batcher = service.enable_batching(max_batch=256, max_wait_ms=20.0)
    try:
        results, errors = {}, []
        gate = threading.Barrier(len(uids))

        def worker(u):
            try:
                gate.wait(timeout=10)
                results[u] = service.recommend_ids([u], K)
            except Exception as e:  # noqa: BLE001 - collected and asserted below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(u,)) for u in uids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors and not any(t.is_alive() for t in threads)
        s = np.concatenate([results[u][0] for u in uids])
        i = np.concatenate([results[u][1] for u in uids])
        assert topk_agree(s, i, np.asarray(s_ref), np.asarray(i_ref), SCORE_TOL)
        assert batcher.stats["requests"] == len(uids)
        assert batcher.stats["device_calls"] < len(uids)  # the burst coalesced
    finally:
        service.disable_batching()


def test_http_matches_jax(pair):
    jax_service, service, data, _ = pair
    server = serve_http(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert json.load(urllib.request.urlopen(f"{base}/healthz"))["status"] == "ok"
        users = list(data.user)[:5]
        got = [json.load(urllib.request.urlopen(f"{base}/recommend?user={u}&k={K}"))["items"]
               for u in users]
        want = jax_service.recommend(users, k=K)
        assert topk_agree(*_as_arrays(got, data), *_as_arrays(want, data), SCORE_TOL)
        body = json.dumps({"users": [users[0], "nope"], "k": 3}).encode()
        req = urllib.request.Request(f"{base}/recommend", data=body,
                                     headers={"Content-Type": "application/json"})
        batch = json.load(urllib.request.urlopen(req))["results"]
        assert len(batch[0]["items"]) == 3 and batch[1]["items"] is None
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/recommend?user=nope")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/recommend?user={users[0]}&k=abc")
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        service.disable_batching()


def test_evaluate_ranking_matches_jax(pair, tiny_data):
    jax_service, service, data, _ = pair
    ours = evaluate_ranking(service.user_emb, service.item_emb, data, service.graph)
    ref = jax_evaluate_ranking(jax_service.user_emb, jax_service.item_emb, tiny_data,
                               jax_service.graph)
    assert ours.metrics.keys() == ref.metrics.keys()
    for name, value in ref.metrics.items():
        assert ours.metrics[name] == pytest.approx(value, abs=1e-12), name
    assert np.array_equal(ours.test_user_ids, ref.test_user_ids)
    assert ours.report(data, [10]) == ref.report(tiny_data, [10])


def test_checkpoint_round_trip_serves_the_same(pair, tmp_path):
    jax_service, service, data, params_np = pair
    path = str(tmp_path / "lightgcn.npz")
    save_params(path, params_from_jax("lightgcn", params_np, device="cpu"))
    loaded = load_params(path, "lightgcn", device="cpu")
    for name in ("user_emb", "item_emb"):
        assert torch.equal(loaded[name], torch.from_numpy(np.asarray(params_np[name])))
    config = default_config(**{"graph.compute_dtype": service.graph.compute_dtype})
    restored = build_service("lightgcn", path, config, data.training_data, data.test_data,
                             device="cpu")
    assert torch.equal(restored.user_emb, service.user_emb)
    assert torch.equal(restored.item_emb, service.item_emb)


def test_params_from_jax_rejects_wrong_layout():
    with pytest.raises(ValueError):
        params_from_jax("lightgcn", {"user_emb": np.zeros((2, 2))}, device="cpu")
    with pytest.raises(KeyError):  # a model the port does not have yet
        params_from_jax("diffnet", {}, device="cpu")
    with pytest.raises(ValueError):  # ported since: its layout wants its names
        params_from_jax("graphsage", {}, device="cpu")


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "recommendation_tpu_torch", *args],
                          capture_output=True, text=True, timeout=120)


def _write_tiny_set(data, root):
    from recommendation_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(root), data.training_data, data.test_data)
    return str(root / "train.txt"), str(root / "test.txt")


TRAIN_SETS = ["--set", "max.epoch=2", "--set", "batch.size=512", "--set", "embedding.size=16"]


@pytest.fixture(scope="module")
def port_data(tiny_data):
    return Interaction(tiny_data.training_data, tiny_data.test_data)


def test_cli_models_and_serve_without_checkpoint(port_data, tmp_path, monkeypatch):
    """``serve`` without ``--checkpoint`` trains first; driven through
    ``cli.main`` with the HTTP server replaced, so no port is opened."""
    from recommendation_tpu_torch import cli
    from recommendation_tpu_torch.serve import http

    out = _cli("models")
    assert out.returncode == 0 and "lightgcn" in out.stdout.split()
    out = _cli("serve", "--model", "lightgcn", "--device", "cpu", "--checkpoint", "missing.npz")
    assert out.returncode == 2 and "not found" in out.stderr
    data = port_data
    tr, te = _write_tiny_set(data, tmp_path)
    served = []
    monkeypatch.setattr(http, "serve_http", lambda service, **kw: served.append(service))
    assert cli.main(["serve", "--model", "lightgcn", "--device", "cpu", "--train", tr,
                     "--test", te, *TRAIN_SETS]) == 0
    (service,) = served
    assert service.user_emb.shape == (data.user_num, 16) and not service.user_emb.requires_grad
    s, i = service.recommend_ids([0, 1], K)
    assert np.isfinite(s).all() and i.shape == (2, K)


def test_cli_train_prints_finite_metrics(port_data, tmp_path):
    tr, te = _write_tiny_set(port_data, tmp_path)
    out_json = tmp_path / "result.json"
    out = _cli("train", "--model", "lightgcn", "--device", "cpu", "--train", tr, "--test", te,
               *TRAIN_SETS, "--out", str(out_json))
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"Recall@20", "NDCG@20"} <= set(metrics)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values())
    assert json.loads(out_json.read_text())["metrics"] == metrics


def test_serve_from_checkpoint_dir_and_recommender(port_data, tmp_path):
    """Train with checkpoints, then serve from the directory: the service's
    tables are the eval embeddings of the newest checkpoint's parameters;
    ``from_recommender`` serves the trainer's (best) parameters."""
    from recommendation_tpu_torch.cli import train_recommender
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    data = port_data
    config = default_config(**{"max.epoch": 2, "batch.size": 512, "embedding.size": 16,
                               "checkpoint.dir": str(tmp_path / "ckpt")})
    rec = train_recommender("lightgcn", config, data.training_data, data.test_data, device="cpu")
    live = RecommenderService.from_recommender(rec)
    want = rec.model.eval_embeddings(rec.params, rec.state, rec.graph)
    assert torch.equal(live.user_emb, want[0]) and torch.equal(live.item_emb, want[1])
    restored = build_service("lightgcn", str(tmp_path / "ckpt"), default_config(
        **{"embedding.size": 16}), data.training_data, data.test_data, device="cpu")
    payload = CheckpointManager(str(tmp_path / "ckpt")).restore_latest()
    assert payload["epoch"] == 1
    want = rec.model.eval_embeddings(payload["params"], {}, rec.graph)
    assert torch.equal(restored.user_emb, want[0]) and torch.equal(restored.item_emb, want[1])
    assert live.user_emb.grad_fn is None and restored.user_emb.grad_fn is None
    with pytest.raises(FileNotFoundError):
        build_service("lightgcn", str(tmp_path), default_config(), data.training_data,
                      data.test_data, device="cpu")
