"""k-means on the device: NCL's E-step (counterpart of
``recommendation_tpu/ops/kmeans.py``).

Lloyd iterations with distances as ‖x‖² − 2x·cᵀ + ‖c‖² (one product),
``argmin`` assignment (the first minimum, as ``jnp.argmin``) and segment
means, an empty cluster keeping its centroid. The
random draws are arguments: ``init_idx`` (the k initial rows) and, for the
mini-batch variant, ``batch_idx`` [n_iters, bsz] (the rows of each
iteration). ``kmeans_init`` and ``kmeans_batches`` draw them from a
``torch.Generator``; a test hands both versions the same indices.

The segment sums are deterministic: the rows sorted stably by cluster,
then each cluster's rows added in row order (``torch.segment_reduce``),
with no atomic adds. So every run, and every rank of a sharded trainer
that clusters the same tables, gets the same bits on the card; on the CPU
the sums are ``index_add_``'s, which adds in index order, bit for bit.
The clusters' row counts are read off the sorted assignments
(``searchsorted``), the JAX package's ``segment_sum`` counts: unlike
``torch.bincount``, which reads its input's maximum on the host on the
card, nothing is read on the host, so a CUDA graph can capture the
E-step (NCL's ``e_step_cadence='batch'``, inside every step).
"""

from __future__ import annotations

import torch


def kmeans_init(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct row indices in [0, n), int64 on ``generator``'s device."""
    if not 1 <= k <= n:
        raise ValueError(f"k-means needs 1 <= k <= n, got k={k}, n={n}")
    return torch.randperm(n, generator=generator, device=generator.device)[:k]


def kmeans_batches(generator: torch.Generator, n: int, n_iters: int, bsz: int) -> torch.Tensor:
    """[n_iters, bsz] row indices in [0, n), with replacement, int64 on
    ``generator``'s device."""
    return torch.randint(0, n, (n_iters, bsz), generator=generator, device=generator.device)


def _sq_dist(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ centroids.T)
            + torch.sum(centroids * centroids, dim=1)[None, :])


def cluster_counts(ordered: torch.Tensor, k: int) -> torch.Tensor:
    """The number of each cluster's rows, int64[k], from the assignments
    sorted ascending: the differences of each cluster's first position
    (``torch.bincount(assign, minlength=k)``'s integers)."""
    edges = torch.arange(k + 1, dtype=ordered.dtype, device=ordered.device)
    starts = torch.searchsorted(ordered, edges)
    return starts[1:] - starts[:-1]


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """(each cluster's sum of its rows, in row order; its row count) as
    f32[k, d] and f32[k]: one stable sort of the assignments, then a
    segment sum over the sorted rows, an empty cluster 0."""
    ordered, order = torch.sort(assign, stable=True)
    lengths = cluster_counts(ordered, k)
    sums = torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0, unsafe=True)
    return sums, lengths.to(x.dtype)


def kmeans(x: torch.Tensor, init_idx: torch.Tensor, n_iters: int = 10):
    """Lloyd k-means from the rows ``init_idx``. Returns (centroids f32[K, d],
    assignments i32[N]); the assignments are those of the last iteration,
    made against the centroids it started from, as the JAX scan returns."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    x = x.float()
    centroids = x[init_idx.to(x.device).long()]
    k = centroids.shape[0]
    for _ in range(n_iters):
        assign = torch.argmin(_sq_dist(x, centroids), dim=1)
        sums, counts = _segment_sums(x, assign, k)
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts, min=1.0)[:, None], centroids)
    return centroids, assign.to(torch.int32)


def kmeans_minibatch(x: torch.Tensor, init_idx: torch.Tensor, batch_idx: torch.Tensor,
                     n_iters: int = 10, assign_chunk: int = 131_072):
    """Mini-batch k-means (Sculley 2010) from the rows ``init_idx``: each
    iteration assigns the rows ``batch_idx[t]`` and moves each centroid
    toward its batch mean at rate 1/count; then every row is assigned in
    ``assign_chunk``-row chunks. Returns (centroids f32[K, d],
    assignments i32[N])."""
    if batch_idx.dim() != 2 or batch_idx.shape[0] != n_iters:
        raise ValueError(f"batch_idx must be [n_iters={n_iters}, bsz], "
                         f"got {tuple(batch_idx.shape)}")
    x = x.float()
    centroids = x[init_idx.to(x.device).long()]
    k = centroids.shape[0]
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    batch_idx = batch_idx.to(x.device).long()
    for t in range(n_iters):
        xb = x[batch_idx[t]]
        assign = torch.argmin(_sq_dist(xb, centroids), dim=1)
        b_sums, b_counts = _segment_sums(xb, assign, k)
        counts = counts + b_counts
        eta = torch.where(counts > 0, b_counts / torch.clamp(counts, min=1.0),
                          torch.zeros_like(counts))
        b_mean = b_sums / torch.clamp(b_counts, min=1.0)[:, None]
        centroids = torch.where(b_counts[:, None] > 0,
                                centroids + eta[:, None] * (b_mean - centroids), centroids)
    chunk = min(assign_chunk, x.shape[0])
    assigns = [torch.argmin(_sq_dist(x[s:s + chunk], centroids), dim=1)
               for s in range(0, x.shape[0], chunk)]
    return centroids, torch.cat(assigns).to(torch.int32)


def ncl_cluster_cap(n: int) -> int:
    """Max clusters = n // 39 (`ncl.py:350-351`), at least 1."""
    return max(1, n // 39)
