"""Losses of the ported models (counterpart of ``recommendation_tpu/losses.py``).

The same formulas as the JAX package, differentiable under autograd:
the BPR loss keeps the reference's ``1e-5`` inside the log, and the L2
term is the un-squared Frobenius norm divided by the row count.
``info_nce``'s [B, B] product is plain torch, as the JAX package leaves it
to XLA; the full-catalog denominators go through ``ops/lse.py``.
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
