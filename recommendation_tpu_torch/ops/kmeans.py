"""k-means on the device: NCL's E-step (counterpart of
``recommendation_tpu/ops/kmeans.py``).

Lloyd iterations with distances as ‖x‖² − 2x·cᵀ + ‖c‖² (one product),
``argmin`` assignment (the first minimum, as ``jnp.argmin``) and segment
means through ``index_add_``, an empty cluster keeping its centroid. The
random draws are arguments: ``init_idx`` (the k initial rows) and, for the
mini-batch variant, ``batch_idx`` [n_iters, bsz] (the rows of each
iteration). ``kmeans_init`` and ``kmeans_batches`` draw them from a
``torch.Generator``; a test hands both versions the same indices. On the
card the segment sums use atomic adds, so their low bits may change from
run to run.
"""

from __future__ import annotations

import torch


def kmeans_init(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct row indices in [0, n), int64 on the CPU."""
    if not 1 <= k <= n:
        raise ValueError(f"k-means needs 1 <= k <= n, got k={k}, n={n}")
    return torch.randperm(n, generator=generator)[:k]


def kmeans_batches(generator: torch.Generator, n: int, n_iters: int, bsz: int) -> torch.Tensor:
    """[n_iters, bsz] row indices in [0, n), with replacement, int64 on the CPU."""
    return torch.randint(0, n, (n_iters, bsz), generator=generator)


def _sq_dist(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ centroids.T)
            + torch.sum(centroids * centroids, dim=1)[None, :])


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    sums = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device).index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, assign, torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
    return sums, counts


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
