"""Tuner / experiment driver (layer L8), the counterpart of
``recommendation_tpu/tune/tuner.py``.

Covers both tuner generations (SURVEY.md §2.3):
  * full cartesian grids (`gcl.py:163-175`, `directau.py:311-316`,
    `ncl.py:425-539`);
  * univariate one-at-a-time sweeps against a defaults dict
    (`univariate/buir.py:369-380`, `lightgcn.py:154-162`,
    `univariate/gcl_univariate.py:129-135` ``generate_independent_grid``).

Behavior contracts kept: per-config fault isolation recording
``{'config':…, 'error': str(e)}`` and continuing (`ncl.py:484-488`), JSON
dump (`ncl.py:490-493`) and CSV append (`lightgcn.py:164-173`, one header,
the union of every row's keys) result artifacts, ``--resume`` from the
results JSON (recorded configurations are skipped), best-by-Recall
selection (`gcl.py:256-259`), and the ``print_summary`` best-per-metric
report (`directau.py:361-380`). The dataset and the graph are built once
and shared across configurations, on ``device`` (default ``"cuda"``); as in
the JAX package, that shared graph is built on the configured backend
without ``graph.compute_dtype``, so every configuration propagates in f32.
"""

from __future__ import annotations

import itertools
import json
import os
import traceback
from typing import Any, Dict, Iterable, List, Optional, Sequence

from recommendation_tpu_torch.config import Config, default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models import registry
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log, append_csv, save_json


def generate_independent_grid(defaults: Dict[str, Any], grid: Dict[str, Sequence]) -> List[Dict]:
    """One-at-a-time configs: for each key, vary it over its values with all
    other keys at defaults (`univariate/gcl_univariate.py:129-135`)."""
    configs = []
    for key, values in grid.items():
        for v in values:
            if key in defaults and defaults[key] == v:
                continue
            c = dict(defaults)
            c[key] = v
            c["_varied"] = key
            configs.append(c)
    return [dict(defaults, _varied="(defaults)")] + configs


def _key(config: Dict[str, Any]) -> str:
    return json.dumps(config, sort_keys=True, default=str)


class _TunerBase:
    def __init__(
        self,
        model_name: str,
        train_set: Sequence,
        test_set: Sequence,
        base_config: Optional[Config] = None,
        social_triples: Optional[Sequence] = None,
        graph: Optional[DeviceGraph] = None,
        log: Optional[Log] = None,
        device="cuda",
    ):
        self.model_name = model_name
        self.base = base_config if base_config is not None else default_config()
        self.log = log or Log(name=f"tune-{model_name}")
        self.results: List[Dict] = []
        self.data = Interaction(train_set, test_set)
        backend = self.base.get("graph.backend", "auto")
        if graph is not None:
            self.graph = graph
        elif social_triples is not None:
            from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph

            self.graph = SocialDeviceGraph(self.data, social_triples, backend=backend,
                                           device=device)
        else:
            self.graph = DeviceGraph(self.data, backend=backend, device=device)

    def _configs(self) -> Iterable[Dict[str, Any]]:
        raise NotImplementedError

    def run(self, resume_path: Optional[str] = None) -> List[Dict]:
        """Run the sweep. ``resume_path`` points at a results JSON from an
        earlier (interrupted) run: configurations already recorded there are
        skipped."""
        done: set = set()
        if resume_path and os.path.exists(resume_path):
            with open(resume_path) as f:
                prior = json.load(f)
            self.results.extend(prior)
            done = {_key(r.get("config", {})) for r in prior}
            self.log.add(f"resuming: {len(done)} configurations already recorded")

        configs = list(self._configs())
        self.log.add(f"{self.model_name} tuning — total configurations: {len(configs)}")
        for i, overrides in enumerate(configs, 1):
            overrides = {k: v for k, v in overrides.items() if not k.startswith("_")}
            if done and _key(overrides) in done:
                continue
            conf = self.base.copy().with_overrides(**overrides)
            self.log.add(f"[{i}/{len(configs)}] {overrides}")
            try:
                model = registry.build(self.model_name, conf)
                rec = GraphRecommender(model, self.data, conf, graph=self.graph,
                                       log=Log(echo=False))
                metrics = rec.execute()
                self.results.append({"config": dict(overrides), "metrics": metrics})
                self.log.add(
                    "  -> " + " ".join(f"{k}={v:.5f}" for k, v in metrics.items() if "@" in k)
                )
            except Exception as e:  # per-config isolation (`ncl.py:484-488`)
                self.results.append(
                    {"config": dict(overrides), "error": f"{type(e).__name__}: {e}"}
                )
                self.log.add(f"  -> ERROR {type(e).__name__}: {e}")
                self.log.add(traceback.format_exc(limit=3))
        return self.results

    # -- results artifacts ----------------------------------------------------

    def best(self, metric: str = "Recall@20") -> Optional[Dict]:
        valid = [r for r in self.results if "metrics" in r]
        return max(valid, key=lambda r: r["metrics"].get(metric, 0.0), default=None)

    def save_json(self, path: str) -> None:
        save_json(path, self.results)
        self.log.add(f"saved results to {path}")

    def save_csv(self, path: str) -> None:
        rows = []
        for r in self.results:
            row = dict(r.get("config", {}))
            row.update(r.get("metrics", {}))
            if "error" in r:
                row["error"] = r["error"]
            rows.append(row)
        # the union of keys, so metric rows and error rows share one header
        fieldnames: list[str] = []
        for row in rows:
            for k in row:
                if k not in fieldnames:
                    fieldnames.append(k)
        for row in rows:
            append_csv(path, row, fieldnames=fieldnames)
        self.log.add(f"appended results to {path}")


class GridTuner(_TunerBase):
    """Full cartesian product over ``grid`` (`directau.py:311-316`)."""

    def __init__(self, model_name, train_set, test_set, grid: Dict[str, Sequence], **kw):
        super().__init__(model_name, train_set, test_set, **kw)
        self.grid = grid

    def _configs(self):
        keys = list(self.grid.keys())
        for combo in itertools.product(*self.grid.values()):
            yield dict(zip(keys, combo))


class UnivariateTuner(_TunerBase):
    """One-parameter-at-a-time sweep against defaults
    (`univariate/buir.py:369-380`)."""

    def __init__(
        self, model_name, train_set, test_set, grid: Dict[str, Sequence],
        defaults: Optional[Dict[str, Any]] = None, **kw,
    ):
        super().__init__(model_name, train_set, test_set, **kw)
        self.grid = grid
        self.defaults = defaults or {}

    def _configs(self):
        return generate_independent_grid(self.defaults, self.grid)


def print_summary(results: List[Dict], log: Optional[Log] = None, Ns: Sequence[int] = (20,)):
    """Best-config-per-metric report (`directau.py:361-380`)."""
    log = log or Log(name="summary")
    success = [r for r in results if "metrics" in r]
    failed = [r for r in results if "error" in r]
    log.add("=" * 80)
    log.add("HYPERPARAMETER TUNING SUMMARY")
    log.add(f"Total: {len(results)} | Success: {len(success)} | Failed: {len(failed)}")
    for n in Ns:
        for metric in (f"NDCG@{n}", f"Recall@{n}", f"HitRatio@{n}", f"Precision@{n}"):
            if not success:
                continue
            best = max(success, key=lambda r: r["metrics"].get(metric, 0.0))
            log.add(f"[Best {metric}] {best['metrics'].get(metric, 0.0):.5f} | {best['config']}")
    return log.contents()
