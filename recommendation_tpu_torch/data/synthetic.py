"""Deterministic synthetic datasets.

A copy of ``recommendation_tpu/data/synthetic.py``: ``make_synthetic_dataset``
(ML-100K-shaped: power-law item popularity + latent-factor user/item
affinities), ``make_hard_dataset`` (the same statistics with clustered,
conditional signal and popularity noise, so that models separate from the
popularity list), ``load_or_make_dataset`` (either, cached as triples),
``make_flat_interactions`` (the large-graph benchmark's edges, whose ranking
optimum is the popularity list), ``make_clustered_interactions`` (the same
scale with genre structure, which a quality gate can fail) and
``ArrayInteraction`` (the loop-free interaction view over edge arrays): the
same numpy RNG calls in the same order, so the same seed gives the same
data.
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


def make_hard_dataset(
    n_users: int = 943,
    n_items: int = 1682,
    n_interactions: int = 100_000,
    n_clusters: int = 12,
    n_factors: int = 16,
    noise_rate: float = 0.3,
    signal: float = 0.55,
    test_fraction: float = 0.2,
    seed: int = 11,
) -> Tuple[List[list], List[list]]:
    """ML-100K-statistics dataset with DISCRIMINATING difficulty.

    :func:`make_synthetic_dataset`'s low-rank latent signal is strong
    enough that every propagation scheme finds it and models tie near the
    popularity list. This regime is built so models separate:

      * items belong to clusters ("genres"); users hold sparse Dirichlet
        mixtures over clusters. Collaborative signal is *conditional* —
        propagation through co-cluster neighbors genuinely helps, so graph
        encoders beat matrix factorization and contrastive regularizers
        matter in the tail;
      * ``noise_rate`` of each user's picks are popularity-only draws
        (exploration noise), putting a ceiling on achievable recall and
        separating models by their robustness to false positives;
      * steeper zipf(1.5) long tail: most items are cold, so tail quality
        dominates the metric instead of head memorization;
      * a weak overall ``signal`` scale keeps short runs in the Recall@20
        band that ML-100K papers report, below the easy set's ceiling.

    Split protocol matches the reference's random leave-fraction-out on the
    `ncl.py:575-576` triple format.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, n_factors)).astype(np.float32)
    item_cluster = rng.integers(0, n_clusters, size=n_items)
    qi = (
        centers[item_cluster]
        + 0.9 * rng.normal(size=(n_items, n_factors)).astype(np.float32)
    )
    user_mix = rng.dirichlet(np.full(n_clusters, 0.25), size=n_users).astype(np.float32)
    pu = (
        user_mix @ centers
        + 0.5 * rng.normal(size=(n_users, n_factors)).astype(np.float32)
    )
    item_pop = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** 1.5
    # decorrelate popularity from cluster structure
    item_pop = item_pop[rng.permutation(n_items)]
    item_pop /= item_pop.sum()

    activity = rng.lognormal(0.0, 0.9, size=n_users)
    activity /= activity.sum()
    user_counts = np.maximum(20, (activity * n_interactions).astype(int))  # ML-100K min 20

    seen = set()
    triples = []
    log_pop = np.log(item_pop * n_items + 1e-9)
    for u in range(n_users):
        scores = pu[u] @ qi.T
        logits = signal * scores / (scores.std() + 1e-6) + 0.8 * log_pop
        p = np.exp(logits - logits.max())
        p /= p.sum()
        k = min(int(user_counts[u]), n_items - 1)
        n_noise = int(k * noise_rate)
        picks = rng.choice(n_items, size=k - n_noise, replace=False, p=p)
        noise = rng.choice(n_items, size=n_noise, replace=False, p=item_pop)
        for i in np.concatenate([picks, noise]):
            if (u, int(i)) not in seen:
                seen.add((u, int(i)))
                triples.append((u, int(i)))

    rng.shuffle(triples)
    per_user: dict[int, list] = {}
    for u, i in triples:
        per_user.setdefault(u, []).append(i)
    train, test = [], []
    for u, items in per_user.items():
        n_test = max(1, int(len(items) * test_fraction))
        for i in items[n_test:]:
            train.append([f"u{u}", f"i{i}", 1.0])
        for i in items[:n_test]:
            test.append([f"u{u}", f"i{i}", 1.0])
    return train, test


def make_flat_interactions(n_users: int, n_items: int, n_interactions: int,
                           seed: int = 0) -> np.ndarray:
    """Vectorized large-scale edge generator (no per-user loop): zipf item
    popularity x lognormal user activity, deduplicated. Returns int64[E, 2]
    (user, item): throughput benchmarks at Yelp/Gowalla scale, where the
    ranking optimum is the popularity list."""
    rng = np.random.default_rng(seed)
    n_interactions = min(n_interactions, n_users * n_items)
    user_w = rng.lognormal(0.0, 1.0, size=n_users)
    user_p = user_w / user_w.sum()
    item_w = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_p = item_w / item_w.sum()
    # oversample-and-dedupe, growing the factor until the target is met
    # (skewed distributions collide heavily on dense grids)
    factor = 1.3
    pairs = np.empty((0, 2), dtype=np.int64)
    while len(pairs) < n_interactions and factor < 64:
        target = int(n_interactions * factor)
        users = rng.choice(n_users, size=target, p=user_p)
        items = rng.choice(n_items, size=target, p=item_p)
        pairs = np.unique(np.stack([users, items], axis=1), axis=0)
        factor *= 2
    rng.shuffle(pairs)
    return pairs[:n_interactions]


def make_clustered_interactions(
    n_users: int,
    n_items: int,
    n_interactions: int,
    n_clusters: int = 64,
    prefs_per_user: int = 3,
    noise_rate: float = 0.25,
    tail: float = 3.0,
    seed: int = 0,
    return_structure: bool = False,
) -> "np.ndarray":
    """Vectorized large-scale edge generator WITH collaborative signal.

    :func:`make_flat_interactions` draws user and item independently, so the
    optimal ranker on it is the popularity baseline: fine for throughput
    benchmarks, useless for learning-quality evidence. This is the
    large-scale, loop-free analog of :func:`make_hard_dataset`'s conditional
    regime: items belong to ``n_clusters`` genres, each user holds a sparse
    ``prefs_per_user``-cluster Dirichlet mixture, ``1-noise_rate`` of picks
    come from the user's clusters (within-cluster zipf-ish tail, exponent
    ``1/tail - 1``), the rest are popularity-only exploration noise. A model
    that learns user→cluster affinity beats global popularity by a wide
    margin; one that only learns popularity cannot.

    Returns int64[E, 2] (user, item), deduplicated and shuffled: the same
    contract as :func:`make_flat_interactions` (the split is
    :class:`ArrayInteraction`'s). It can return fewer than
    ``n_interactions`` rows: the oversampling stops at a factor of 64 even
    where dedup leaves it short. With ``return_structure=True`` it also
    returns ``(item_cluster, prefs)``.
    """
    rng = np.random.default_rng(seed)
    n_interactions = min(n_interactions, n_users * n_items)

    # Items sorted by cluster: cluster c owns the contiguous slot range
    # [starts[c], starts[c+1]) so within-cluster draws are one gather.
    item_cluster = rng.integers(0, n_clusters, size=n_items)
    order = np.argsort(item_cluster, kind="stable").astype(np.int64)
    sizes = np.bincount(item_cluster, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]

    # Sparse per-user mixtures: prefs_per_user clusters + Dirichlet weights
    # (drawn from non-empty clusters so the slot gather stays in range).
    nonempty = np.flatnonzero(sizes > 0)
    prefs = nonempty[rng.integers(0, len(nonempty), size=(n_users, prefs_per_user))]
    mix = rng.dirichlet(np.ones(prefs_per_user), size=n_users).astype(np.float32)

    user_w = rng.lognormal(0.0, 1.0, size=n_users)
    user_p = user_w / user_w.sum()
    item_w = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_p = (item_w / item_w.sum())[rng.permutation(n_items)]  # decorrelated

    factor = 1.3
    pairs = np.empty((0, 2), dtype=np.int64)
    while len(pairs) < n_interactions and factor < 64:
        target = int(n_interactions * factor)
        users = rng.choice(n_users, size=target, p=user_p)
        # Which preference slot: gumbel-max over the [target, P] mixture rows.
        g = rng.gumbel(size=(target, prefs_per_user)).astype(np.float32)
        slot = np.argmax(np.log(mix[users] + 1e-9) + g, axis=1)
        cluster = prefs[users, slot]
        # Within-cluster zipf-ish rank, then gather through the sorted order.
        v = rng.random(size=target)
        rank = np.floor(sizes[cluster] * v**tail).astype(np.int64)
        items = order[starts[cluster] + np.minimum(rank, sizes[cluster] - 1)]
        # Exploration noise: popularity-only draws, cluster-blind.
        noise = rng.random(size=target) < noise_rate
        items[noise] = rng.choice(n_items, size=int(noise.sum()), p=item_p)
        pairs = np.unique(np.stack([users, items], axis=1), axis=0)
        factor *= 2
    rng.shuffle(pairs)
    pairs = pairs[:n_interactions]
    if return_structure:
        return pairs, item_cluster, prefs
    return pairs


class ArrayInteraction:
    """Interaction-compatible view over integer edge arrays, without the
    Python dicts of ``Interaction``: the first ``test_fraction`` of the
    pairs are held out. It has what ``DeviceGraph``, the trainer and
    ``evaluate_ranking`` read; the id maps and the string report do not
    exist (as in the JAX package)."""

    def __init__(self, pairs: np.ndarray, n_users: int, n_items: int, test_fraction: float = 0.0):
        import scipy.sparse as sp

        from recommendation_tpu_torch.data.interaction import normalize_graph_mat

        n_test = int(len(pairs) * test_fraction)
        test_pairs = pairs[:n_test]
        train_pairs = pairs[n_test:]
        self.user_num = n_users
        self.item_num = n_items
        self.edge_users = train_pairs[:, 0].astype(np.int32)
        self.edge_items = train_pairs[:, 1].astype(np.int32)
        self.edge_weights = np.ones(len(train_pairs), dtype=np.float32)
        self.training_data = train_pairs  # array view; len() works
        self.interaction_mat = sp.csr_matrix(
            (self.edge_weights, (self.edge_users, self.edge_items)), shape=(n_users, n_items)
        )
        rows = np.concatenate([self.edge_users, self.edge_items + n_users])
        cols = np.concatenate([self.edge_items + n_users, self.edge_users])
        n = n_users + n_items
        self.ui_adj = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
        self.norm_adj = normalize_graph_mat(self.ui_adj)
        self.test_pairs = test_pairs

    def training_size(self):
        return self.user_num, self.item_num, len(self.edge_users)

    def test_user_ids(self) -> np.ndarray:
        return np.unique(self.test_pairs[:, 0]).astype(np.int32)

    def test_items_by_user(self):
        """Per-user test-item arrays aligned with ``test_user_ids()``
        (ascending user id), O(T log T) numpy."""
        tp = self.test_pairs
        order = np.lexsort((tp[:, 1], tp[:, 0]))
        sorted_pairs = tp[order]
        _, starts = np.unique(sorted_pairs[:, 0], return_index=True)
        return np.split(sorted_pairs[:, 1].astype(np.int32), starts[1:])


def write_dataset(path: str, train: List[list], test: List[list]) -> None:
    """Write reference-format ``train.txt``/``test.txt`` triples."""
    os.makedirs(path, exist_ok=True)
    for name, rows in (("train.txt", train), ("test.txt", test)):
        with open(os.path.join(path, name), "w") as f:
            for u, i, w in rows:
                f.write(f"{u} {i} {w}\n")


def load_or_make_dataset(root: str = "dataset/synthetic_ml100k", hard: bool = False, **kwargs):
    """Load the cached synthetic dataset, generating it on first use.
    ``hard=True`` selects the discriminating regime (``make_hard_dataset``),
    cached separately under ``<root>_hard``."""
    from recommendation_tpu_torch.data.io import load_data

    if hard:
        root = root.rstrip("/") + "_hard"
    train_path = os.path.join(root, "train.txt")
    test_path = os.path.join(root, "test.txt")
    if not (os.path.exists(train_path) and os.path.exists(test_path)):
        maker = make_hard_dataset if hard else make_synthetic_dataset
        train, test = maker(**kwargs)
        write_dataset(root, train, test)
    return load_data(train_path), load_data(test_path)
