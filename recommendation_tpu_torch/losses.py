"""Losses of the ported models (counterpart of ``recommendation_tpu/losses.py``).

The same formulas as the JAX package, differentiable under autograd:
the BPR loss keeps the reference's ``1e-5`` inside the log, and the L2
term is the un-squared Frobenius norm divided by the row count.
``info_nce``'s [B, B] product is plain torch, as the JAX package leaves it
to XLA; the full-catalog denominators go through ``ops/lse.py``. DirectAU's
alignment and uniformity are here too, with ``uniformity_streaming``: the
JAX package's ``lax.scan`` of [N, 1024] blocks (``ops/pallas_losses.py``,
not a kernel) as a loop of plain torch products, which ``uniformity_loss``
takes from 4096 rows on so that the [N, N] distances never exist at once.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with a zero-safe gradient: an all-zero row gives value 0
    and gradient 0 (the double ``where`` keeps the norm's 0/0 out)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    norm = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return torch.where(sq > 0, x / torch.clamp(norm, min=eps), torch.zeros_like(x))


def bpr_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor) -> torch.Tensor:
    """-mean log(1e-5 + sigmoid(pos - neg))  (`ncl.py:116-120`)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    return -torch.mean(torch.log(1e-5 + torch.sigmoid(pos_score - neg_score)))


def _bce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy over pos/neg scores (`lightgcn.py:109-113`)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    logits = torch.cat([pos_score, neg_score])
    labels = torch.cat([torch.ones_like(pos_score), torch.zeros_like(neg_score)])
    return torch.mean(_bce_rows(logits, labels))


def pointwise_bce_loss(scores: torch.Tensor, labels: torch.Tensor,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted BCE over labeled (user, item, y) scores; ``weight`` masks
    padding rows (`univariate/diffnet.py:968-991`)."""
    per_row = _bce_rows(scores, labels)
    if weight is None:
        return torch.mean(per_row)
    return torch.sum(per_row * weight) / torch.clamp(torch.sum(weight), min=1.0)


def safe_frobenius_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_F with gradient 0 at x = 0 (torch.norm's subgradient there)."""
    sq = torch.sum(x * x)
    return torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def l2_reg_loss(reg: float, *embs: torch.Tensor) -> torch.Tensor:
    """reg * Σ ||x||_F / x.shape[0] — NOT squared (`ncl.py:122-123`)."""
    return reg * sum(safe_frobenius_norm(x) / x.shape[0] for x in embs)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temperature: float,
             b_cos: bool = True) -> torch.Tensor:
    """Symmetric-view InfoNCE: -mean diag(log_softmax(v1·v2ᵀ/τ))
    (`ncl.py:125-130`, `ssl4rec.py:19-23`)."""
    if b_cos:
        view1, view2 = _l2_normalize(view1), _l2_normalize(view2)
    scores = view1 @ view2.T / temperature
    return -torch.mean(torch.diagonal(torch.log_softmax(scores, dim=1)))


# -- DirectAU -----------------------------------------------------------------


def alignment_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean ||x̂ - ŷ||²  (`directau.py:245-246`)."""
    return torch.mean(torch.sum((_l2_normalize(x) - _l2_normalize(y)) ** 2, dim=1))


UNIFORMITY_STREAMING_ROWS = 4096  # from here on uniformity_loss streams


def uniformity_loss(x: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """log(mean exp(-t·||x̂_a - x̂_b||²) + 1e-8) over all unordered pairs
    (`directau.py:248-251`, torch.pdist semantics: a < b, no self-pairs).
    From ``UNIFORMITY_STREAMING_ROWS`` rows on it takes
    ``uniformity_streaming``."""
    if x.shape[0] >= UNIFORMITY_STREAMING_ROWS:
        return uniformity_streaming(x, t=t)
    x = _l2_normalize(x)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)
    mask = torch.triu(torch.ones((n, n), dtype=torch.bool, device=x.device), diagonal=1)
    n_pairs = n * (n - 1) // 2
    mean_exp = torch.sum(torch.where(mask, torch.exp(-t * d2), torch.zeros_like(d2)))
    return torch.log(mean_exp / max(n_pairs, 1) + 1e-8)


def uniformity_streaming(x: torch.Tensor, t: float = 2.0, block_n: int = 1024) -> torch.Tensor:
    """``uniformity_loss`` block by block: the distances of every row to
    ``block_n`` rows at a time, their upper-triangle terms summed in block
    order, so only [N, block_n] exists at once. The JAX package's
    ``uniformity_streaming``, normalization included (a plain division by
    max(norm, 1e-12), not ``_l2_normalize``'s)."""
    xn = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    n = x.shape[0]
    sq = torch.sum(xn * xn, dim=1)
    rows = torch.arange(n, device=x.device)[:, None]
    total = xn.new_zeros(())
    for start in range(0, n, block_n):
        xb, sqb = xn[start:start + block_n], sq[start:start + block_n]
        d2 = torch.clamp(sq[:, None] + sqb[None, :] - 2.0 * (xn @ xb.T), min=0.0)
        cols = start + torch.arange(xb.shape[0], device=x.device)[None, :]
        total = total + torch.sum(torch.where(rows < cols, torch.exp(-t * d2),
                                              torch.zeros_like(d2)))
    n_pairs = n * (n - 1) // 2
    return torch.log(total / max(n_pairs, 1) + 1e-8)


def direct_au_loss(user_emb: torch.Tensor, item_emb: torch.Tensor, gamma: float) -> torch.Tensor:
    """align(u, i) + γ·(uniform(u) + uniform(i))/2  (`directau.py:238-243`)."""
    align = alignment_loss(user_emb, item_emb)
    uniform = (uniformity_loss(user_emb) + uniformity_loss(item_emb)) / 2.0
    return align + gamma * uniform
