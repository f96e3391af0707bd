"""Full-catalog masked top-k (counterpart of ``recommendation_tpu/ops/topk.py``).

Scores are ``user_emb @ item_embᵀ`` in f32; each user's train positives are
masked to −1e8 (`selfcf.py:419-421` semantics) before ``torch.topk``. The JAX
package leaves these to XLA, not Pallas, so they stay plain torch here. Its
power-of-two padding of query blocks only bounds JAX's compile cache and is
dropped: PyTorch does not compile per shape.

``mask_seen_post_merge`` and ``train_edge_keys`` are copies of the JAX
package's host helpers for the sharded evaluator and service, which mask
train positives after the sharded top-k's merge.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_VALUE = -1e8


def mask_seen_post_merge(scores, ids, uid_arr, train_keys, n_items,
                         mask_value=MASK_VALUE):
    """Host-side vectorized train-positive masking for over-fetched top-k
    candidates after a sharded merge (shared by the sharded evaluator,
    `parallel/trainer.py::test`, and the serving path).

    ``train_keys`` = int64 ``user * n_items + item`` of every train edge;
    ``ids >= n_items`` marks row-padding from `pad_rows_to`. Returns a
    masked COPY of ``scores``. Sorted keys (as the sharded evaluator and
    service keep them) are searched in place of ``np.isin``'s sort of
    both arrays a call: the same mask."""
    uid_arr = np.asarray(uid_arr, dtype=np.int64)
    ids = np.asarray(ids)
    valid = ids < n_items
    query = uid_arr[:, None] * n_items + np.where(valid, ids, 0)
    train_keys = np.asarray(train_keys)
    if len(train_keys) and np.all(train_keys[1:] >= train_keys[:-1]):
        at = np.minimum(np.searchsorted(train_keys, query), len(train_keys) - 1)
        seen = (train_keys[at] == query) & valid
    else:
        seen = np.isin(query, train_keys) & valid
    out = np.asarray(scores).copy()
    out[seen | ~valid] = mask_value
    return out


def train_edge_keys(interaction_mat, n_items):
    """int64 ``user * n_items + item`` keys of every train edge (the
    immutable structure `mask_seen_post_merge` queries against)."""
    coo = interaction_mat.tocoo()
    return coo.row.astype(np.int64) * n_items + coo.col.astype(np.int64)


def mask_trained(scores: torch.Tensor, user_positives: torch.Tensor) -> torch.Tensor:
    """Mask each user's train positives to −1e8 (returns a new tensor).

    scores: f32[B, n_items]; user_positives: int[B, max_deg] padded with −1.
    A scatter-min, as the JAX version: real positives take MASK_VALUE, the −1
    pads take +inf and leave the score untouched."""
    pos = user_positives.long()
    fill = torch.where(
        pos >= 0,
        torch.tensor(MASK_VALUE, dtype=scores.dtype, device=scores.device),
        torch.tensor(float("inf"), dtype=scores.dtype, device=scores.device),
    )
    return scores.scatter_reduce(1, pos.clamp(min=0), fill, reduce="amin")


def masked_topk(scores: torch.Tensor, user_positives: torch.Tensor, k: int):
    """(top_scores, top_ids) over items with train positives excluded."""
    return torch.topk(mask_trained(scores, user_positives), k, dim=1)


def topk_with_exclusions(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    user_positives: torch.Tensor,
    k: int,
    batch_size: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-catalog MIPS top-k for a block of users, batched to bound the
    [B, n_items] score buffer. Returns (scores f32[U, k], ids int64[U, k]),
    on the embeddings' device."""
    outs_s, outs_i = [], []
    for start in range(0, user_emb.shape[0], batch_size):
        scores = user_emb[start:start + batch_size] @ item_emb.T
        s, i = masked_topk(scores, user_positives[start:start + batch_size], k)
        outs_s.append(s)
        outs_i.append(i)
    if not outs_s:
        empty = user_emb.new_empty((0, k))
        return empty, empty.long()
    return torch.cat(outs_s), torch.cat(outs_i)


def topk_agree(scores_a, ids_a, scores_b, ids_b, tol: float) -> bool:
    """True when two top-k answers for the same users agree up to ties.

    Scores (sorted descending per row) must match within ``tol``. Tied scores
    may come out in either order, so an id is compared only where its score
    is separated from both neighbours in the row by more than ``2·tol``; the
    last position is not compared, since an item just outside the top-k may
    tie with it."""
    sa, sb = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    if sa.shape != sb.shape or ia.shape != ib.shape or sa.shape != ia.shape:
        return False
    if not np.all(np.abs(sa - sb) <= tol):
        return False
    k = sb.shape[1]
    if k < 2:
        return True
    gap = np.full(sb.shape, np.inf)
    step = sb[:, :-1] - sb[:, 1:]
    gap[:, :-1] = step
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    check = gap > 2 * tol
    check[:, -1] = False
    return bool(np.all((ia == ib) | ~check))
