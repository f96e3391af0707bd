"""The port's tuner (``recommendation_tpu_torch/tune/``) against the JAX
package's: the one-at-a-time grid and every preset equal the JAX
package's; ``print_summary`` gives the same lines from one results list;
``GridTuner`` and ``UnivariateTuner`` on a tiny set at one epoch on the
CPU run every configuration, isolate a failing one, skip what a results
JSON recorded (``--resume``) and write one CSV header, the union of every
row's keys; the CLI's ``tune`` parses its arguments and runs a sweep."""

import csv
import json

import pytest

from recommendation_tpu.tune import generate_independent_grid as jax_independent_grid
from recommendation_tpu.tune import print_summary as jax_print_summary
from recommendation_tpu.tune.presets import PRESETS as JAX_PRESETS
from recommendation_tpu.tune.presets import get_preset as jax_get_preset
from recommendation_tpu.utils.logging import Log as JaxLog
from recommendation_tpu_torch.cli import _parse_grid, main
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset, write_dataset
from recommendation_tpu_torch.tune import (
    GridTuner,
    UnivariateTuner,
    generate_independent_grid,
    print_summary,
)
from recommendation_tpu_torch.tune.presets import PRESETS, get_preset
from recommendation_tpu_torch.utils.logging import Log

TINY = dict(n_users=60, n_items=100, n_interactions=2500, seed=3)
ONE_EPOCH = {"max.epoch": 1, "embedding.size": 8}


@pytest.fixture(scope="module")
def sets():
    return make_synthetic_dataset(**TINY)


def test_independent_grid_equals_jax():
    defaults = {"embedding.size": 64, "learning.rate": 1e-3, "loss": "bpr"}
    grid = {"embedding.size": [32, 64, 128], "loss": ["bpr", "bce"], "n_negs": [1, 2]}
    assert generate_independent_grid(defaults, grid) == jax_independent_grid(defaults, grid)
    assert generate_independent_grid({}, {}) == jax_independent_grid({}, {})


def test_presets_equal_jax():
    assert PRESETS == JAX_PRESETS
    for name in PRESETS:
        assert get_preset(name.upper()) == jax_get_preset(name)
    with pytest.raises(KeyError, match="no tuning preset"):
        get_preset("nope")


def test_print_summary_equals_jax():
    results = [
        {"config": {"embedding.size": 8}, "metrics": {"NDCG@20": 0.1, "Recall@20": 0.3,
                                                      "HitRatio@20": 0.5, "Precision@20": 0.01}},
        {"config": {"embedding.size": 16}, "metrics": {"NDCG@20": 0.2, "Recall@20": 0.25,
                                                       "HitRatio@20": 0.6, "Precision@20": 0.02}},
        {"config": {"embedding.size": -1}, "error": "ValueError: bad"},
    ]
    for ns in ((20,), (10, 20)):
        got = print_summary(results, log=Log(echo=False), Ns=ns)
        assert got == jax_print_summary(results, log=JaxLog(echo=False), Ns=ns)
    assert print_summary([], log=Log(echo=False)) == jax_print_summary([], log=JaxLog(echo=False))


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_grid_tuner_isolates_resumes_and_writes(sets, tmp_path):
    train, test = sets
    grid = {"embedding.size": [8, 16], "optimizer": ["adam", "nope"]}
    tuner = GridTuner("lightgcn", train, test, grid, base_config=default_config(**ONE_EPOCH),
                      device="cpu", log=Log(echo=False))
    results = tuner.run()
    assert [r["config"] for r in results] == [
        {"embedding.size": e, "optimizer": o} for e in (8, 16) for o in ("adam", "nope")]
    ok = [r for r in results if "metrics" in r]
    bad = [r for r in results if "error" in r]
    assert len(ok) == 2 and len(bad) == 2
    assert all(r["config"]["optimizer"] == "nope" and "unknown optimizer" in r["error"]
               for r in bad)
    assert all(0.0 <= r["metrics"]["Recall@20"] <= 1.0 for r in ok)
    assert tuner.best()["config"]["optimizer"] == "adam"
    out, table = str(tmp_path / "r.json"), str(tmp_path / "r.csv")
    tuner.save_json(out)
    tuner.save_csv(table)
    rows = _read_csv(table)
    header = rows[0]
    assert len(rows) == 5 and len(set(header)) == len(header)
    assert {"embedding.size", "optimizer", "Recall@20", "error"} <= set(header)
    assert all(len(r) == len(header) for r in rows)
    # resume: the recorded configurations are skipped, a new one runs
    more = GridTuner("lightgcn", train, test, {"embedding.size": [8, 16, 4], "optimizer": ["adam"]},
                     base_config=default_config(**ONE_EPOCH), device="cpu", log=Log(echo=False),
                     graph=tuner.graph)
    resumed = more.run(resume_path=out)
    assert len(resumed) == 5 and resumed[:4] == json.load(open(out))
    assert resumed[4]["config"] == {"embedding.size": 4, "optimizer": "adam"}
    assert "metrics" in resumed[4]
    assert any("resuming: 4 configurations" in line for line in more.log.contents())


def test_univariate_tuner_runs_each_key_against_defaults(sets):
    train, test = sets
    defaults = {"embedding.size": 8, "LightGCN.n_layers": 2}
    grid = {"embedding.size": [8, 12], "LightGCN.n_layers": [1]}
    tuner = UnivariateTuner("lightgcn", train, test, grid, defaults=defaults,
                            base_config=default_config(**ONE_EPOCH), device="cpu",
                            log=Log(echo=False))
    results = tuner.run()
    assert [r["config"] for r in results] == [
        {"embedding.size": 8, "LightGCN.n_layers": 2},
        {"embedding.size": 12, "LightGCN.n_layers": 2},
        {"embedding.size": 8, "LightGCN.n_layers": 1},
    ]
    assert all("metrics" in r for r in results)


def test_cli_tune_parses_and_runs(sets, tmp_path, capsys):
    assert _parse_grid(["a=1,2.5,x", "b=[1, 2]"]) == {"a": [1, 2.5, "x"], "b": ["[1", " 2]"]}
    train, test = sets
    write_dataset(str(tmp_path), train, test)
    out, table = str(tmp_path / "r.json"), str(tmp_path / "r.csv")
    args = ["tune", "--model", "lightgcn", "--train", str(tmp_path / "train.txt"),
            "--test", str(tmp_path / "test.txt"), "--device", "cpu", "--set", "max.epoch=1",
            "--grid", "embedding.size=8,12", "--out", out, "--csv", table]
    assert main(args) == 0
    first = json.load(open(out))
    assert [r["config"] for r in first] == [{"embedding.size": 8}, {"embedding.size": 12}]
    assert "HYPERPARAMETER TUNING SUMMARY" in capsys.readouterr().out
    assert main(args + ["--resume"]) == 0  # every configuration recorded: none runs
    assert json.load(open(out)) == first
    assert "resuming: 2 configurations" in capsys.readouterr().out
    # a preset, its grid cut by --grid overrides (and the univariate mode it names)
    out2 = str(tmp_path / "p.json")
    assert main(["tune", "--model", "lightgcn", "--preset", "--train", str(tmp_path / "train.txt"),
                 "--test", str(tmp_path / "test.txt"), "--device", "cpu",
                 "--set", "max.epoch=1", "--set", "embedding.size=8",
                 "--grid", "embedding.size=64", "--grid", "LightGCN.n_layers=3",
                 "--grid", "learning.rate=0.01", "--grid", "loss=bpr", "--grid", "n_negs=1",
                 "--out", out2]) == 0
    preset_runs = json.load(open(out2))
    assert len(preset_runs) == 1 and preset_runs[0]["config"] == get_preset("lightgcn")["defaults"]
