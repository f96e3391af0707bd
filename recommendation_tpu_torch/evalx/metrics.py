"""Ranking metrics (layer L7) — the exact reference contract, built once.
A copy of ``recommendation_tpu/evalx/metrics.py``.

Formulas (`ncl.py:133-162`, `selfcf.py:95-149`; SURVEY.md §2.3):
  hits[u]    = |top-N(u) ∩ test(u)|
  HitRatio   = Σ_u hits[u] / Σ_u |test(u)|
  Precision  = Σ_u hits[u] / (|users|·N)
  Recall     = mean_u hits[u]/|test(u)|
  F1         = 2PR/(P+R)
  NDCG       = mean_u DCG_u/IDCG_u, DCG = Σ_{rank r of hit} 1/log2(r+2),
               IDCG = Σ_{i < min(|test(u)|, N)} 1/log2(i+2)
MAE/RMSE rating metrics mirror `univariate/diffnet.py:638-657`.

The legacy ``Measure.NDCG`` variant (`univariate/diffnet.py:611-622`,
natural log instead of log2) is the SAME function: every DCG and IDCG term
scales by the constant ln(2), which cancels in the DCG/IDCG ratio — so one
implementation covers both reference families exactly.

Two surfaces: the dict-based ``Metric`` statics (drop-in for reference-style
``{user: [(item, score)]}`` results) and the vectorized ``ranking_metrics``
over top-k id arrays (what the device pipeline produces). Both share the same
math and are cross-tested.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


class Metric:
    @staticmethod
    def hits(origin: Dict, res: Dict) -> Dict:
        return {
            u: len(set(origin[u]).intersection(i[0] for i in res.get(u, [])))
            for u in origin
            if u in res
        }

    @staticmethod
    def hit_ratio(origin: Dict, hits: Dict) -> float:
        total = sum(len(origin[u]) for u in origin)
        return round(sum(hits.values()) / total, 5)

    @staticmethod
    def precision(hits: Dict, n: int) -> float:
        return round(sum(hits.values()) / (len(hits) * n), 5)

    @staticmethod
    def recall(hits: Dict, origin: Dict) -> float:
        return round(float(np.mean([hits[u] / len(origin[u]) for u in hits])), 5)

    @staticmethod
    def F1(prec: float, recall: float) -> float:
        if prec + recall:
            return round(2 * prec * recall / (prec + recall), 5)
        return 0.0

    @staticmethod
    def NDCG(origin: Dict, res: Dict, n: int) -> float:
        score = 0.0
        for u in res:
            dcg = sum(
                1.0 / math.log2(i + 2) for i, item in enumerate(res[u]) if item[0] in origin[u]
            )
            idcg = sum(1.0 / math.log2(i + 2) for i in range(min(len(origin[u]), n)))
            score += dcg / idcg if idcg else 0.0
        return round(score / len(res), 5)

    @staticmethod
    def MAE(res: Sequence) -> float:
        """res rows: (user, item, true, pred) (`univariate/diffnet.py:638-646`)."""
        err = [abs(r[2] - r[3]) for r in res]
        return round(float(np.mean(err)), 5) if err else 0.0

    @staticmethod
    def RMSE(res: Sequence) -> float:
        err = [(r[2] - r[3]) ** 2 for r in res]
        return round(float(np.sqrt(np.mean(err))), 5) if err else 0.0


def ranking_evaluation(origin: Dict, res: Dict, Ns: Sequence[int]) -> List[str]:
    """Reference-format string report (`ncl.py:165-177`)."""
    out = []
    for n in Ns:
        pred = {u: res[u][:n] for u in res}
        hits = Metric.hits(origin, pred)
        out.append(f"Top {n}\n")
        out += [
            f"Hit Ratio:{Metric.hit_ratio(origin, hits)}\n",
            f"Precision:{Metric.precision(hits, n)}\n",
            f"Recall:{Metric.recall(hits, origin)}\n",
            f"NDCG:{Metric.NDCG(origin, pred, n)}\n",
        ]
    return out


# -- vectorized path ----------------------------------------------------------

_DISCOUNT_CACHE: dict[int, np.ndarray] = {}


def _discounts(n: int) -> np.ndarray:
    if n not in _DISCOUNT_CACHE:
        _DISCOUNT_CACHE[n] = 1.0 / np.log2(np.arange(n) + 2.0)
    return _DISCOUNT_CACHE[n]


def ranking_metrics(
    top_ids: np.ndarray, test_items: List[np.ndarray], Ns: Sequence[int]
) -> Dict[str, float]:
    """Metrics from top-k id arrays.

    top_ids: i32[U, max(Ns)] ranked item ids for each evaluated user;
    test_items[u]: that user's held-out item ids (non-empty).
    Returns a flat structured dict {"Recall@20": ..., ...} — replacing the
    reference's string-parse round trip (`ncl.py:274`, SURVEY.md §5)."""
    top_ids = np.asarray(top_ids)
    n_users, max_n = top_ids.shape
    assert max(Ns) <= max_n
    hit_mat = np.zeros_like(top_ids, dtype=bool)
    test_sizes = np.zeros(n_users, dtype=np.int64)
    for u, items in enumerate(test_items):
        hit_mat[u] = np.isin(top_ids[u], items, assume_unique=False)
        test_sizes[u] = len(items)

    disc = _discounts(max_n)
    out: Dict[str, float] = {}
    for n in Ns:
        hits = hit_mat[:, :n].sum(axis=1)
        out[f"HitRatio@{n}"] = float(hits.sum() / test_sizes.sum())
        out[f"Precision@{n}"] = float(hits.sum() / (n_users * n))
        out[f"Recall@{n}"] = float(np.mean(hits / test_sizes))
        dcg = (hit_mat[:, :n] * disc[:n]).sum(axis=1)
        ideal_counts = np.minimum(test_sizes, n)
        idcg_cum = np.concatenate([[0.0], np.cumsum(disc)])
        idcg = idcg_cum[ideal_counts]
        out[f"NDCG@{n}"] = float(np.mean(np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)))
    return out
