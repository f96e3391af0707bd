"""Batching and negative sampling on the device (counterpart of
``recommendation_tpu/sampling.py``).

An epoch is a keyed permutation of the padded edge list, cut into
[n_batches, B] blocks (the tail padded cyclically); negatives are drawn
uniformly and rejection-corrected against the user's train positives
without a data-dependent shape: k = n_redraws + 1 candidates are checked
at once, the first that is not a positive wins, and a user's precomputed
guaranteed negative stands in when all k collide. A train positive is
never emitted as a negative.

Every function that draws takes its randomness as **raw 32-bit words**: an
int64 tensor with values in [0, 2^32), the bits ``jax.random.bits`` would
give. The functions that draw those words from a ``torch.Generator``
(``draw_words``, ``uniform_ints``, ``permutation_words``, ``epoch_words``)
are separate, so a test can hand the port and the JAX package the same
bits and compare their outputs bit for bit. They draw on the generator's
own device: the trainer's generator lies on the graph's device, so an
epoch's words are drawn there, inside a captured epoch's graph on the card
(``train/graphed.py``), as the JAX epoch draws them inside its jitted
program. A seed therefore gives other words on the card (Philox) than on
the CPU (mt19937); a test that hands both packages the same words draws
them from a host generator.

The 32-bit arithmetic of the JAX sampler (``uint32`` multiplies and
shifts) is done in int64 and masked to 32 bits, and ``bits_to_ints`` keeps
JAX's exact float32 arithmetic. Where the JAX sampler picks a word out of a
gathered row by a broadcast compare (a TPU form), the port gathers the
word; the value is the same.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

WORD = 1 << 32
MASK32 = WORD - 1


class PairwiseBatch(NamedTuple):
    users: torch.Tensor  # i32[B]
    pos_items: torch.Tensor  # i32[B]
    neg_items: torch.Tensor  # i32[B]
    weight: torch.Tensor  # f32[B] 1.0 for real rows, 0.0 for padding
    # the data group of a sharded trainer whose ranks each hold a slice of
    # the global batch in rank order (``ops/group.py``); None: the whole batch
    group: Any = None
    # with a group, the global batch (a PairwiseBatch with no group) that
    # this one is a rank's slice of (``ops.group.global_batch``)
    whole: Any = None


class PointwiseBatch(NamedTuple):
    """Labeled (user, item, y) rows: each positive edge gives one y=1 row
    and ``n_negs`` y=0 rows (`univariate/diffnet.py:968-991`)."""

    users: torch.Tensor  # i32[B*(1+n_negs)]
    items: torch.Tensor  # i32[B*(1+n_negs)]
    labels: torch.Tensor  # f32[B*(1+n_negs)]
    weight: torch.Tensor  # f32[B*(1+n_negs)]


class EpochWords(NamedTuple):
    """The words one epoch draws: the permutation's round keys ``perm_ks``
    (ints in [0, n_edges)) and salts, and the negatives' words ``neg``,
    [k+1, E_pad] on the edge-order path, else [k+1, n_batches, B]."""

    perm_ks: torch.Tensor
    perm_salts: torch.Tensor
    neg: torch.Tensor


# -- drawing words from a generator -------------------------------------------


def draw_words(generator: torch.Generator, shape, device) -> torch.Tensor:
    """int64 words uniform in [0, 2^32), drawn on ``generator``'s device and
    moved to ``device`` (no move for the trainer's generator, which lies on
    the graph's device)."""
    return torch.randint(0, WORD, tuple(shape), generator=generator, device=generator.device,
                         dtype=torch.int64).to(device)


def uniform_ints(generator: torch.Generator, shape, n: int, device) -> torch.Tensor:
    """Uniform i32 in [0, n) through ``bits_to_ints``."""
    return bits_to_ints(draw_words(generator, shape, device), n)


def permutation_rounds(n: int) -> int:
    return max(24, 2 * int(np.ceil(np.log2(max(n, 2)))))


def permutation_words(generator: torch.Generator, n: int, device, rounds: int | None = None):
    """(ks, salts) for ``keyed_permutation``: in the JAX function's order,
    the round keys first, then the salts."""
    rounds = permutation_rounds(n) if rounds is None else rounds
    ks = uniform_ints(generator, (rounds,), n, device)
    salts = draw_words(generator, (rounds,), device)
    return ks, salts


def negative_words(generator: torch.Generator, n_sets: int, batch: int, device,
                   n_redraws: int = 4) -> torch.Tensor:
    """Words for ``n_sets`` calls of ``sample_negatives`` on a batch:
    [n_sets, n_redraws + 2, batch]."""
    return draw_words(generator, (n_sets, n_redraws + 2, batch), device)


def epoch_words(generator: torch.Generator, graph, batch_size: int,
                n_redraws: int = 4, device=None) -> EpochWords:
    """All the words ``epoch_batches`` needs for one epoch, on ``device``
    (the graph's by default)."""
    device = graph.device if device is None else device
    ks, salts = permutation_words(generator, graph.n_edges, device)
    k = n_redraws + 1
    if graph.has_edge_bitmap_fb:
        shape = (k + 1, graph.edge_ui.shape[0])
    else:
        shape = (k + 1, _n_batches(graph, batch_size), batch_size)
    return EpochWords(ks, salts, draw_words(generator, shape, device))


# -- the draws ------------------------------------------------------------------


def bits_to_ints(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Map words to uniform i32 in [0, n) through the top 24 bits in f32,
    as the JAX package does (no integer modulo). Requires n < 2^24, which
    every catalog the dense backend holds meets."""
    if n >= (1 << 24):
        raise ValueError(f"bits_to_ints needs n < 2^24, got {n}")
    scale = float(np.float32(n * 2.0**-24))  # rounded to f32 once, as jnp.float32
    f = (bits >> 8).to(torch.float32) * scale
    return torch.clamp(f.to(torch.int32), max=n - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), c < 2^32, without leaving int64:
    the high half of ``a`` contributes only its product's low 16 bits."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def keyed_permutation(ks: torch.Tensor, salts: torch.Tensor, n: int) -> torch.Tensor:
    """Exact pseudorandom permutation of [0, n) (i32[n]): the swap-or-not
    shuffle of the JAX package. Round r pairs x with (ks[r] - x) mod n and
    swaps the pair iff a hash bit of its larger member, salted by
    ``salts[r]``, is set; every round is an involution, so the composition
    is a bijection for any words."""
    device = ks.device
    x = torch.arange(n, dtype=torch.int64, device=device)
    ks = ks.to(torch.int64)
    for r in range(ks.shape[0]):
        xp = ks[r] - x
        xp = torch.where(xp < 0, xp + n, xp)
        mx = torch.maximum(x, xp)
        h = _mul32(mx, 0x9E3779B1) ^ salts[r]
        h = _mul32(h ^ (h >> 15), 0x85EBCA6B)
        h = h ^ (h >> 13)
        x = torch.where((h & 1) > 0, xp, x)
    return x.to(torch.int32)


def _is_positive(graph, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """bool[B]: is (u, i) a train edge? By the padded positives table where
    it exists, else the dense i8 mask, else a binary search over the CSR
    rows — the JAX package's order of preference."""
    users = users.long()
    if graph.has_pos_table:
        return (graph.user_positives[users] == items[:, None]).any(dim=1)
    if graph.has_pos_mask:
        return graph.user_pos_mask[users, items.long()] > 0
    lo = graph.csr_indptr[users]
    hi = graph.csr_indptr[users + 1]
    end = hi
    n_iters = max(1, int(np.ceil(np.log2(max(2, graph.max_degree + 1))))) + 1
    flat = graph.csr_items
    last = flat.shape[0] - 1
    for _ in range(n_iters):  # vectorized lower_bound
        active = lo < hi
        mid = (lo + hi) // 2
        v = flat[torch.clamp(mid, 0, last).long()]
        go_right = active & (v < items)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < end) & (flat[torch.clamp(lo, 0, last).long()] == items)


def _bitmap_bad(bitmap_rows: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """bool[k, N]: is candidate ``draws[j, n]`` set in row n of the bitmap?
    The bitmap is an i32 view, so ``>>`` is an arithmetic shift, as in JAX."""
    word = bitmap_rows.gather(1, (draws >> 5).T.long()).T  # [k, N]
    return ((word >> (draws & 31)) & 1) > 0


def _first_good(draws: torch.Tensor, bad: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """The first candidate that is not a positive, else the fallback."""
    first = torch.argmax((~bad).to(torch.int32), dim=0)  # the first maximum
    chosen = draws.gather(0, first[None])[0]
    return torch.where(bad.all(dim=0), fallback.to(chosen.dtype), chosen)


def _check_words(words: torch.Tensor, shape) -> None:
    if tuple(words.shape) != tuple(shape):
        raise ValueError(f"expected words of shape {tuple(shape)}, got {tuple(words.shape)}")


def sample_negatives(words: torch.Tensor, graph, users: torch.Tensor,
                     n_redraws: int = 4) -> torch.Tensor:
    """i32[B] negatives for ``users`` from ``words`` [k+1, B]: k candidate
    rows and one fallback column, as one ``jax.random.bits`` call gives.
    The bitmap path tests a candidate's bit in the user's packed row, the
    table path compares it with the padded positives row, and the
    sequential path replaces a colliding candidate round by round."""
    k = n_redraws + 1
    _check_words(words, (k + 1,) + tuple(users.shape))
    n_fb = graph.user_fallback_neg.shape[1]
    draws = bits_to_ints(words[:k], graph.n_items)  # [k, B]
    fb_col = bits_to_ints(words[k], n_fb)
    ul = users.long()
    fallback = graph.user_fallback_neg.reshape(-1)[ul * n_fb + fb_col.long()]
    if graph.has_pos_bitmap:
        return _first_good(draws, _bitmap_bad(graph.user_pos_bitmap[ul], draws), fallback)
    if graph.has_pos_table:
        pos_rows = graph.user_positives[ul]  # [B, max_deg]
        bad = (pos_rows[None, :, :] == draws[:, :, None]).any(dim=2)
        return _first_good(draws, bad, fallback)
    neg = draws[0]
    for j in range(1, k):
        neg = torch.where(_is_positive(graph, users, neg), draws[j], neg)
    return torch.where(_is_positive(graph, users, neg), fallback, neg)


def _sample_from_rows(words: torch.Tensor, graph, rows: torch.Tensor, n_redraws: int):
    """Negatives for N examples whose (bitmap + fallback) rows are ``rows``
    [N, W + n_fb], from ``words`` [k+1, N]."""
    k = n_redraws + 1
    n_fb = graph.user_fallback_neg.shape[1]
    w = graph.user_pos_bitmap.shape[1]
    draws = bits_to_ints(words[:k], graph.n_items)  # [k, N]
    fb_col = bits_to_ints(words[k], n_fb)  # [N]
    fallback = rows[:, w:w + n_fb].gather(1, fb_col[:, None].long())[:, 0]
    return _first_good(draws, _bitmap_bad(rows[:, :w], draws), fallback)


def sample_negatives_epoch(words: torch.Tensor, graph, users: torch.Tensor,
                           n_redraws: int = 4) -> torch.Tensor:
    """Negatives for a whole epoch, ``users`` i32[n_batches, B], from
    ``words`` [k+1, n_batches, B]. With the bitmap, one fused row per
    example (``user_bitmap_fb``); otherwise ``sample_negatives`` per batch
    on that batch's words (``words[:, b]``), as the JAX package's vmap over
    per-batch keys."""
    k = n_redraws + 1
    _check_words(words, (k + 1,) + tuple(users.shape))
    if not graph.has_pos_bitmap:
        return torch.stack([sample_negatives(words[:, b], graph, users[b], n_redraws)
                            for b in range(users.shape[0])])
    uflat = users.reshape(-1)
    rows = graph.user_bitmap_fb[uflat.long()]
    negs = _sample_from_rows(words.reshape(k + 1, -1), graph, rows, n_redraws)
    return negs.reshape(users.shape)


def sample_negatives_epoch_edges(words: torch.Tensor, graph, n_redraws: int = 4) -> torch.Tensor:
    """One negative per edge, in static edge order (i32[E_pad]), from
    ``words`` [k+1, E_pad]: the membership rows are the static
    ``edge_bitmap_fb``. Padding rows' draws are never consumed."""
    rows = graph.edge_bitmap_fb
    _check_words(words, (n_redraws + 2, rows.shape[0]))
    return _sample_from_rows(words, graph, rows, n_redraws)


def _n_batches(graph, batch_size: int) -> int:
    return max(1, -(-graph.n_edges // batch_size))


def _epoch_index(perm: torch.Tensor, n_edges: int, total: int) -> torch.Tensor:
    """The permutation, tiled cyclically to ``total`` rows."""
    if total > n_edges:
        return perm.repeat(-(-total // n_edges))[:total]
    return perm


def shuffled_epoch_fused(perm: torch.Tensor, graph, batch_size: int, negs_e: torch.Tensor):
    """(users, items, negs, weights, n_batches): the edges in ``perm``'s
    order with each edge's negative riding the same row gather; each
    [n_batches, B]. The tail batch is padded cyclically from the front of
    the permutation."""
    e = graph.n_edges
    n_batches = _n_batches(graph, batch_size)
    idx = _epoch_index(perm, e, n_batches * batch_size).long()
    table = torch.cat([graph.edge_ui, negs_e[: graph.edge_ui.shape[0], None]], dim=1)
    rows = table[idx]
    users = rows[:, 0].reshape(n_batches, batch_size)
    items = rows[:, 1].reshape(n_batches, batch_size)
    negs = rows[:, 2].reshape(n_batches, batch_size)
    weight = torch.ones((n_batches, batch_size), dtype=torch.float32, device=users.device)
    return users, items, negs, weight, n_batches


def shuffled_epoch(perm: torch.Tensor, graph, batch_size: int):
    """(users, items, weights, n_batches): ``shuffled_epoch_fused`` without
    negatives."""
    e = graph.n_edges
    n_batches = _n_batches(graph, batch_size)
    idx = _epoch_index(perm, e, n_batches * batch_size).long()
    rows = graph.edge_ui[idx]
    users = rows[:, 0].reshape(n_batches, batch_size)
    items = rows[:, 1].reshape(n_batches, batch_size)
    weight = torch.ones((n_batches, batch_size), dtype=torch.float32, device=users.device)
    return users, items, weight, n_batches


def epoch_batches(words: EpochWords, graph, batch_size: int, n_redraws: int = 4):
    """One epoch's (users, items, negs, weights, n_batches): the one entry
    point the trainer draws through. The edge-order sampler where the graph
    carries ``edge_bitmap_fb``, else the per-position sampler."""
    perm = keyed_permutation(words.perm_ks, words.perm_salts, graph.n_edges)
    if graph.has_edge_bitmap_fb:
        negs_e = sample_negatives_epoch_edges(words.neg, graph, n_redraws)
        return shuffled_epoch_fused(perm, graph, batch_size, negs_e)
    users, items, weights, n_batches = shuffled_epoch(perm, graph, batch_size)
    negs = sample_negatives_epoch(words.neg, graph, users, n_redraws)
    return users, items, negs, weights, n_batches


def sample_pointwise(words: torch.Tensor, graph, users: torch.Tensor, pos_items: torch.Tensor,
                     n_negs: int = 4, weight: torch.Tensor | None = None,
                     n_redraws: int = 4) -> PointwiseBatch:
    """1 positive + ``n_negs`` labeled negatives per edge, from ``words``
    [n_negs, k+1, B]; column blocks [positives; negs_1; ...; negs_n]."""
    _check_words(words, (n_negs, n_redraws + 2) + tuple(users.shape))
    b = users.shape[0]
    negs = [sample_negatives(words[j], graph, users, n_redraws) for j in range(n_negs)]
    w = torch.ones((b,), dtype=torch.float32, device=users.device) if weight is None else weight
    return PointwiseBatch(
        users=torch.cat([users] * (1 + n_negs)),
        items=torch.cat([pos_items.to(torch.int32), *negs]),
        labels=torch.cat([torch.ones((b,), dtype=torch.float32, device=users.device),
                          torch.zeros((b * n_negs,), dtype=torch.float32, device=users.device)]),
        weight=torch.cat([w] * (1 + n_negs)),
    )


def popularity_baseline_topk(graph, k: int) -> np.ndarray:
    """The k most popular items (ties by id), the baseline the integration
    tests beat (SURVEY.md §4)."""
    counts = torch.zeros(graph.n_items, dtype=torch.float32, device=graph.device)
    counts.index_add_(0, graph.edge_items.long(), graph.edge_valid)
    return torch.argsort(-counts, stable=True)[:k].cpu().numpy()
