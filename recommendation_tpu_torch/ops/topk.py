"""Full-catalog masked top-k (counterpart of ``recommendation_tpu/ops/topk.py``).

Scores are ``user_emb @ item_embᵀ`` in f32; each user's train positives are
masked to −1e8 (`selfcf.py:419-421` semantics) before ``torch.topk``. The JAX
package leaves these to XLA, not Pallas, so they stay plain torch here. Its
power-of-two padding of query blocks only bounds JAX's compile cache and is
dropped: PyTorch does not compile per shape.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_VALUE = -1e8


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
