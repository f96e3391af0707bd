"""Losses of the ported models (counterpart of ``recommendation_tpu/losses.py``).

The same formulas as the JAX package, differentiable under autograd:
the BPR loss keeps the reference's ``1e-5`` inside the log, and the L2
term is the un-squared Frobenius norm divided by the row count.
``info_nce``'s [B, B] product is plain torch, as the JAX package leaves it
to XLA; the full-catalog denominators go through ``ops/lse.py``. The
contrastive, bootstrap and decorrelation losses of the augmenting models
(SelfCF, BUIR, SSL4Rec, GCL, GRACE, G-BT, BGRL) are plain torch too, as
the JAX package's are plain jnp. Every normalization goes through the
zero-safe ``_l2_normalize``: edge dropout isolates nodes, and their zero
rows give a gradient of 0, not NaN. DirectAU's
alignment and uniformity are here too, with ``uniformity_streaming``: the
JAX package's ``lax.scan`` of [N, 1024] blocks (``ops/pallas_losses.py``,
not a kernel) as a loop of plain torch products, which ``uniformity_loss``
takes from 4096 rows on so that the [N, N] distances never exist at once.

The losses over a batch take a ``group``: the data group of a sharded
trainer (``parallel/trainer.py``), over whose ranks the batch's rows are
split (the batch carries it, ``PairwiseBatch.group``). Then each gives
the global batch's value on every rank, and each rank's backward is its
own rows' share of the global gradient:
  * a mean or a sum over rows (BPR, BCE, alignment, the bootstraps) is
    the group's sum (``ops/group.py``'s ``reduce_sum``, an all-reduce
    whose backward is the identity), a mean over the global row count;
  * a Frobenius norm is the root of the group's sum of squares;
  * a term whose partners run over the whole batch (``info_nce``,
    ``batch_softmax_loss``, ``uniformity_loss``) takes the rank's rows as
    its queries and the global batch's rows as its keys, which the caller
    reads from its whole tables by the global batch's ids
    (``ops.group.global_batch``); the rank's queries are the rows
    ``[offset, offset + n)`` of the global batch.
With no group (``None``) the group's sum is the rank's own value, the
offset 0 and the queries every row: the single-device operations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from recommendation_tpu_torch.graph import augment
from recommendation_tpu_torch.ops.group import group_rows, rank_offset, reduce_sum


def batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the global batch: ``torch.mean`` with no
    group, else the group's sum over the global element count."""
    if group is None:
        return torch.mean(x)
    return reduce_sum(torch.sum(x), group) / group_rows(x.numel(), group)


def batch_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the global batch: ``torch.sum`` with no group,
    else the group's sum of the rank's sums."""
    return reduce_sum(torch.sum(x), group)


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with a zero-safe gradient: an all-zero row gives value 0
    and gradient 0 (the double ``where`` keeps the norm's 0/0 out)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    norm = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return torch.where(sq > 0, x / torch.clamp(norm, min=eps), torch.zeros_like(x))


def bpr_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor,
             group=None) -> torch.Tensor:
    """-mean log(1e-5 + sigmoid(pos - neg))  (`ncl.py:116-120`)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    return -batch_mean(torch.log(1e-5 + torch.sigmoid(pos_score - neg_score)), group)


def _bce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor,
             group=None) -> torch.Tensor:
    """Binary cross-entropy over pos/neg scores (`lightgcn.py:109-113`)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    logits = torch.cat([pos_score, neg_score])
    labels = torch.cat([torch.ones_like(pos_score), torch.zeros_like(neg_score)])
    return batch_mean(_bce_rows(logits, labels), group)


def pointwise_bce_loss(scores: torch.Tensor, labels: torch.Tensor,
                       weight: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """Weighted BCE over labeled (user, item, y) scores; ``weight`` masks
    padding rows (`univariate/diffnet.py:968-991`)."""
    per_row = _bce_rows(scores, labels)
    if weight is None:
        return batch_mean(per_row, group)
    return reduce_sum(torch.sum(per_row * weight), group) / torch.clamp(
        reduce_sum(torch.sum(weight), group), min=1.0)


def safe_frobenius_norm(x: torch.Tensor, group=None) -> torch.Tensor:
    """||x||_F with gradient 0 at x = 0 (torch.norm's subgradient there);
    with a ``group``, of the rows of every rank's ``x``."""
    sq = reduce_sum(torch.sum(x * x), group)
    return torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def l2_reg_loss(reg: float, *embs: torch.Tensor, group=None) -> torch.Tensor:
    """reg * Σ ||x||_F / x.shape[0] — NOT squared (`ncl.py:122-123`); with a
    ``group``, over the global batch's rows."""
    return reg * sum(safe_frobenius_norm(x, group) / group_rows(x.shape[0], group)
                     for x in embs)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temperature: float,
             b_cos: bool = True, group=None) -> torch.Tensor:
    """Symmetric-view InfoNCE: -mean diag(log_softmax(v1·v2ᵀ/τ))
    (`ncl.py:125-130`, `ssl4rec.py:19-23`). With a ``group``, ``view1``
    holds the rank's rows and ``view2`` the global batch's: each of the
    rank's rows against every key, its positive the key of its own global
    row."""
    if b_cos:
        view1, view2 = _l2_normalize(view1), _l2_normalize(view2)
    scores = view1 @ view2.T / temperature
    lo = rank_offset(view1.shape[0], group)
    return -batch_mean(torch.diagonal(torch.log_softmax(scores, dim=1), offset=lo), group)


def masked_info_nce(anchor: torch.Tensor, sample: torch.Tensor, pos_mask: torch.Tensor,
                    neg_mask: torch.Tensor, tau: float) -> torch.Tensor:
    """Matrix-mask InfoNCE (`univariate/grace.py:213-224`): the denominator
    over the positive and negative entries, the numerator averaged over
    each anchor's positives."""
    anchor, sample = _l2_normalize(anchor), _l2_normalize(sample)
    sim = anchor @ sample.T / tau
    masked = torch.where(pos_mask + neg_mask > 0, sim, torch.full_like(sim, -torch.inf))
    log_prob = sim - torch.logsumexp(masked, dim=1, keepdim=True)
    per_anchor = torch.sum(log_prob * pos_mask, dim=1) / torch.clamp(
        torch.sum(pos_mask, dim=1), min=1e-12)
    return -torch.mean(per_anchor)


def batch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       temperature: float, group=None) -> torch.Tensor:
    """In-batch sampled-softmax retrieval loss (`ssl4rec.py:25-30`), with the
    reference's +1e-6 inside the log. With a ``group``, ``user_emb`` holds
    the rank's rows and ``item_emb`` the global batch's."""
    user_emb, item_emb = _l2_normalize(user_emb), _l2_normalize(item_emb)
    lo = rank_offset(user_emb.shape[0], group)
    pos_items = item_emb[lo:lo + user_emb.shape[0]]
    pos_score = torch.exp(torch.sum(user_emb * pos_items, dim=-1) / temperature)
    ttl_score = torch.sum(torch.exp(user_emb @ item_emb.T / temperature), dim=1)
    return batch_mean(-torch.log(pos_score / ttl_score + 1e-6), group)


# -- DirectAU -----------------------------------------------------------------


def alignment_loss(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """mean ||x̂ - ŷ||²  (`directau.py:245-246`), over the global batch's
    rows with a ``group``."""
    return batch_mean(torch.sum((_l2_normalize(x) - _l2_normalize(y)) ** 2, dim=1), group)


UNIFORMITY_STREAMING_ROWS = 4096  # from here on uniformity_loss streams


def _group_queries(n: int, group) -> tuple[int, int]:
    """(first row, row count) of a rank's queries among the global batch's
    ``n`` rows: all of them with no group."""
    if group is None:
        return 0, n
    m = n // dist.get_world_size(group)
    return rank_offset(m, group), m


def uniformity_loss(x: torch.Tensor, t: float = 2.0, group=None) -> torch.Tensor:
    """log(mean exp(-t·||x̂_a - x̂_b||²) + 1e-8) over all unordered pairs
    (`directau.py:248-251`, torch.pdist semantics: a < b, no self-pairs).
    From ``UNIFORMITY_STREAMING_ROWS`` rows on it takes
    ``uniformity_streaming``. With a ``group``, ``x`` holds the global
    batch's rows and the rank sums the pairs (a, b) whose ``a`` is one of
    its rows, a < b by global index; the group's sum of those sums goes
    into the log."""
    if x.shape[0] >= UNIFORMITY_STREAMING_ROWS:
        return uniformity_streaming(x, t=t, group=group)
    x = _l2_normalize(x)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    n_pairs = n * (n - 1) // 2
    lo, m = _group_queries(n, group)
    q = x[lo:lo + m]
    d2 = torch.clamp(sq[lo:lo + m, None] + sq[None, :] - 2.0 * (q @ x.T), min=0.0)
    mask = (lo + torch.arange(m, device=x.device))[:, None] < torch.arange(n, device=x.device)
    mine = torch.sum(torch.where(mask, torch.exp(-t * d2), torch.zeros_like(d2)))
    return torch.log(reduce_sum(mine, group) / max(n_pairs, 1) + 1e-8)


def uniformity_streaming(x: torch.Tensor, t: float = 2.0, block_n: int = 1024,
                         group=None) -> torch.Tensor:
    """``uniformity_loss`` block by block: the distances of every row to
    ``block_n`` rows at a time, their upper-triangle terms summed in block
    order, so only [N, block_n] exists at once. The JAX package's
    ``uniformity_streaming``, normalization included (a plain division by
    max(norm, 1e-12), not ``_l2_normalize``'s). With a ``group``, ``x``
    holds the global batch's rows, the rank's rows are the queries (as in
    ``uniformity_loss``), and the group's sum goes into the log."""
    xn = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    n = x.shape[0]
    sq = torch.sum(xn * xn, dim=1)
    lo, m = _group_queries(n, group)
    q, sqq = xn[lo:lo + m], sq[lo:lo + m]
    rows = lo + torch.arange(m, device=x.device)[:, None]
    total = xn.new_zeros(())
    for start in range(0, n, block_n):
        xb, sqb = xn[start:start + block_n], sq[start:start + block_n]
        d2 = torch.clamp(sqq[:, None] + sqb[None, :] - 2.0 * (q @ xb.T), min=0.0)
        cols = start + torch.arange(xb.shape[0], device=x.device)[None, :]
        total = total + torch.sum(torch.where(rows < cols, torch.exp(-t * d2),
                                              torch.zeros_like(d2)))
    n_pairs = n * (n - 1) // 2
    return torch.log(reduce_sum(total, group) / max(n_pairs, 1) + 1e-8)


def direct_au_loss(user_emb: torch.Tensor, item_emb: torch.Tensor, gamma: float) -> torch.Tensor:
    """align(u, i) + γ·(uniform(u) + uniform(i))/2  (`directau.py:238-243`)."""
    align = alignment_loss(user_emb, item_emb)
    uniform = (uniformity_loss(user_emb) + uniformity_loss(item_emb)) / 2.0
    return align + gamma * uniform


# -- bootstrap (negative-free) ------------------------------------------------


def cosine_bootstrap_loss(p: torch.Tensor, z: torch.Tensor, group=None) -> torch.Tensor:
    """1 - mean cos(p, z), no gradient to ``z``  (`selfcf.py:518-519`)."""
    z = z.detach()
    return 1.0 - batch_mean(torch.sum(_l2_normalize(p) * _l2_normalize(z), dim=-1), group)


def selfcf_loss(u_online, u_target, i_online, i_target, group=None) -> torch.Tensor:
    """The cosine bootstrap both ways, halved (`selfcf.py:520-525`)."""
    return (cosine_bootstrap_loss(u_online, i_target, group) / 2.0
            + cosine_bootstrap_loss(i_online, u_target, group) / 2.0)


def buir_loss(u_online, u_target, i_online, i_target, group=None) -> torch.Tensor:
    """mean[(2 - 2·cos(u_on, i_tg)) + (2 - 2·cos(i_on, u_tg))], the targets
    detached (`univariate/buir.py:263-277`)."""
    u_online, u_target = _l2_normalize(u_online), _l2_normalize(u_target)
    i_online, i_target = _l2_normalize(i_online), _l2_normalize(i_target)
    loss_ui = 2.0 - 2.0 * torch.sum(u_online * i_target.detach(), dim=-1)
    loss_iu = 2.0 - 2.0 * torch.sum(i_online * u_target.detach(), dim=-1)
    return batch_mean(loss_ui + loss_iu, group)


# -- decorrelation and graph contrast -----------------------------------------


def barlow_twins_loss(h1: torch.Tensor, h2: torch.Tensor, lambda_: float | None = None,
                      batch_norm: bool = True, eps: float = 1e-15) -> torch.Tensor:
    """Cross-correlation decorrelation loss (`univariate/gbt.py:203-217`):
    each view standardized by the unbiased std (ddof 1), ``eps`` added
    outside it."""
    batch_size, feature_dim = h1.shape
    if lambda_ is None:
        lambda_ = 1.0 / feature_dim
    if batch_norm:
        z1 = (h1 - h1.mean(dim=0)) / (h1.std(dim=0, unbiased=True) + eps)
        z2 = (h2 - h2.mean(dim=0)) / (h2.std(dim=0, unbiased=True) + eps)
        c = z1.T @ z2 / batch_size
    else:
        c = h1.T @ h2 / batch_size
    on_diag = torch.sum((1.0 - torch.diagonal(c)) ** 2)
    eye = torch.eye(feature_dim, dtype=torch.bool, device=c.device)
    off_diag = torch.sum(torch.where(eye, torch.zeros_like(c), c) ** 2)
    return on_diag + lambda_ * off_diag


def grace_dual_branch_loss(z1: torch.Tensor, z2: torch.Tensor, tau: float) -> torch.Tensor:
    """GRACE's dual-branch InfoNCE with intra-view negatives
    (`univariate/grace.py:213-224`, DualBranchContrast 469-502): for anchor
    i of one view the positive is row i of the other; the negatives are
    every row of the other view and every other row of its own (the
    intra-view diagonal is -inf), one logsumexp over the [N, 2N]
    concatenation. Symmetrized over the two views."""

    def one_side(a, b):
        a, b = _l2_normalize(a), _l2_normalize(b)
        inter = a @ b.T / tau  # [N, N]; the diagonal holds the positives
        intra = a @ a.T / tau
        eye = torch.eye(a.shape[0], dtype=torch.bool, device=a.device)
        intra = torch.where(eye, torch.full_like(intra, -torch.inf), intra)
        denom = torch.logsumexp(torch.cat([inter, intra], dim=1), dim=1)
        return -torch.mean(torch.diagonal(inter) - denom)

    return (one_side(z1, z2) + one_side(z2, z1)) / 2.0


def bootstrap_g2l_loss(h1_pred, h2_pred, g1_target, g2_target) -> torch.Tensor:
    """BGRL's G2L bootstrap (`univariate/bgrl_g2l.py:277-308,436-446`): each
    view's node predictions against the other view's graph-level target
    readout, 2 - 2·cos, symmetrized; the readout is scaled by
    1 / max(||g||_F, 1e-12) and detached."""
    g1, g2 = g1_target.detach(), g2_target.detach()

    def side(h, g):
        h = _l2_normalize(h)
        g = g / torch.clamp(safe_frobenius_norm(g), min=1e-12)
        return torch.mean(2.0 - 2.0 * h @ g)

    return (side(h1_pred, g2) + side(h2_pred, g1)) / 2.0


def hierarchical_mim_loss(generator: torch.Generator, user_emb: torch.Tensor,
                          adj_user_emb: torch.Tensor) -> torch.Tensor:
    """MHCN's hierarchical self-supervision (`univariate/mhcn.py:480-505`):
    local MIM user↔hyperedge (shuffled negatives) + global MIM against the
    graph readout. ``adj_user_emb`` = H_c @ user_emb (the hyperedge
    embeddings). Its three row permutations come from ``generator`` on the
    tables' device (``graph.augment.permutation``), in the JAX package's
    order."""
    n, dev = user_emb.shape[0], user_emb.device

    def score(a, b):
        return torch.sum(a * b, dim=1)

    shuf1 = user_emb[augment.permutation(generator, n, dev)]
    shuf2 = adj_user_emb[augment.permutation(generator, n, dev)]
    pos = score(user_emb, adj_user_emb)
    neg1 = score(shuf1, adj_user_emb)
    neg2 = score(shuf2, user_emb)
    local = torch.sum(-torch.log(torch.sigmoid(pos - neg1) + 1e-12)
                      - torch.log(torch.sigmoid(neg1 - neg2) + 1e-12))
    readout = torch.mean(adj_user_emb, dim=0, keepdim=True)
    gpos = score(adj_user_emb, readout)
    gneg = score(adj_user_emb[augment.permutation(generator, n, dev)], readout)
    return local + torch.sum(-torch.log(torch.sigmoid(gpos - gneg) + 1e-12))
