"""Deterministic synthetic dataset generator (ML-100K-shaped).

A copy of ``recommendation_tpu/data/synthetic.py::make_synthetic_dataset``
and ``load_or_make_dataset``: the same numpy RNG calls in the same order, so
the same seed gives the same triples. Power-law item popularity +
latent-factor user/item affinities, so that embedding models can beat a
popularity baseline.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def make_synthetic_dataset(
    n_users: int = 943,
    n_items: int = 1682,
    n_interactions: int = 100_000,
    n_factors: int = 8,
    test_fraction: float = 0.2,
    seed: int = 7,
) -> Tuple[List[list], List[list]]:
    """Return (train_triples, test_triples) of ``[user, item, rating]`` with
    string ids, holdout split per user (leave-last-fraction-out)."""
    rng = np.random.default_rng(seed)
    pu = rng.normal(size=(n_users, n_factors)).astype(np.float32)
    qi = rng.normal(size=(n_items, n_factors)).astype(np.float32)
    item_pop = rng.zipf(1.3, size=n_items).astype(np.float64)
    item_pop /= item_pop.sum()

    seen = set()
    triples = []
    # Users get interactions proportional to a lognormal activity level.
    activity = rng.lognormal(0.0, 1.0, size=n_users)
    activity /= activity.sum()
    user_counts = np.maximum(5, (activity * n_interactions).astype(int))
    for u in range(n_users):
        # Per-user affinity: latent dot product + popularity prior.
        scores = pu[u] @ qi.T
        logits = scores / (scores.std() + 1e-6) + 0.7 * np.log(item_pop * n_items + 1e-9)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        k = min(int(user_counts[u]), n_items - 1)
        items = rng.choice(n_items, size=k, replace=False, p=p)
        for i in items:
            if (u, int(i)) not in seen:
                seen.add((u, int(i)))
                triples.append((u, int(i)))

    rng.shuffle(triples)
    train, test = [], []
    per_user: dict[int, list] = {}
    for u, i in triples:
        per_user.setdefault(u, []).append(i)
    for u, items in per_user.items():
        n_test = max(1, int(len(items) * test_fraction))
        for i in items[n_test:]:
            train.append([f"u{u}", f"i{i}", 1.0])
        for i in items[:n_test]:
            test.append([f"u{u}", f"i{i}", 1.0])
    return train, test


def write_dataset(path: str, train: List[list], test: List[list]) -> None:
    """Write reference-format ``train.txt``/``test.txt`` triples."""
    os.makedirs(path, exist_ok=True)
    for name, rows in (("train.txt", train), ("test.txt", test)):
        with open(os.path.join(path, name), "w") as f:
            for u, i, w in rows:
                f.write(f"{u} {i} {w}\n")


def load_or_make_dataset(root: str = "dataset/synthetic_ml100k", **kwargs):
    """Load the cached synthetic dataset, generating it on first use. (The
    JAX package's ``hard=True`` regime is not part of the serving slice.)"""
    from recommendation_tpu_torch.data.io import load_data

    train_path = os.path.join(root, "train.txt")
    test_path = os.path.join(root, "test.txt")
    if not (os.path.exists(train_path) and os.path.exists(test_path)):
        train, test = make_synthetic_dataset(**kwargs)
        write_dataset(root, train, test)
    return load_data(train_path), load_data(test_path)
