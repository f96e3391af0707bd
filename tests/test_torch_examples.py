"""The port's examples (``examples/torch_*.py``, the counterparts of the
JAX package's ``examples/*.py``) run end to end on the CPU at a tiny size:
LightGCN's training, the DirectAU grid, and MHCN on a mesh in a one-rank
gloo world. Each takes ``--device`` (default ``cuda``): without a card the
default raises."""

import importlib.util
import json
import math
import pathlib
import socket

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TINY = ["--set", "embedding.size=16", "--set", "batch.size=512", "--set", "eval.interval=1",
        "--set", "item.ranking.topN=[10,20]"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset, write_dataset

    root = tmp_path_factory.mktemp("examples")
    write_dataset(str(root), *make_synthetic_dataset(n_users=60, n_items=100,
                                                     n_interactions=2500, seed=3))
    return root / "train.txt", root / "test.txt"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_torch_train_lightgcn_trains_on_the_cpu(files):
    metrics = _example("torch_train_lightgcn").main(
        ["--device", "cpu", "--set", "max.epoch=1", *TINY, str(files[0]), str(files[1])])
    assert {"Recall@20", "NDCG@20"} <= set(metrics)
    assert all(math.isfinite(v) for v in metrics.values()) and metrics["Recall@20"] > 0


def test_torch_train_lightgcn_defaults_to_the_card(files, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example("torch_train_lightgcn").main(["--set", "max.epoch=1", *TINY, str(files[0]),
                                               str(files[1])])


def test_torch_tune_directau_sweeps_on_the_cpu(files, tmp_path):
    out = tmp_path / "tune.json"
    results = _example("torch_tune_directau").main(
        ["--device", "cpu", "--train", str(files[0]), "--test", str(files[1]), "--out", str(out),
         "--set", "max.epoch=1", *TINY, "--set", "batch.size=128"])
    assert len(results) == 6 and not any("error" in r for r in results)
    assert len(json.loads(out.read_text())) == 6


def test_torch_train_social_multichip_trains_mhcn_on_a_gloo_mesh(files, monkeypatch, capsys):
    """MHCN through ``ShardedGraphRecommender`` over gloo in a world of one
    rank, this process (torchrun's variables over a free localhost port):
    its epochs eager (gloo's collectives run on the host); the example
    leaves the world."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                           RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(key, value)
    metrics = _example("torch_train_social_multichip").main(
        ["--device", "cpu", "--mesh", "1x1", "--train", str(files[0]), "--test", str(files[1]),
         "--set", "max.epoch=1", *TINY])
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "rank 0: epochs eager (gloo's collectives run on the host)" in out, out[-2000:]
    assert {"Recall@20", "NDCG@20"} <= set(metrics)
    assert all(math.isfinite(v) for v in metrics.values())
