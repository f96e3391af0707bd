"""Full-catalog masked top-k (counterpart of ``recommendation_tpu/ops/topk.py``).

Scores are ``user_emb @ item_embᵀ`` in f32; each user's train positives are
masked to −1e8 (`selfcf.py:419-421` semantics) before ``torch.topk``. The JAX
package leaves these to XLA, not Pallas, so they stay plain torch here.

The JAX package jits the block (``_score_block``) and pads a tail block to
a power of two (``_pow2_bucket``), so that at most log2(1024) + 1 programs
exist per (k, n_items). The port keeps that form for the same reason: a
CUDA graph replays one fixed shape. ``ScoreBlock`` holds one graph per
(rows, positives width, k) over static input buffers, all in one memory
pool, so the largest block's score buffer is paid once; on the CPU it runs
the same body eagerly. ``topk_with_exclusions`` cuts users into blocks of
``batch_size`` and pads the tail with zero rows and −1 positives, as the
JAX function does.

``mask_seen_post_merge`` and ``train_edge_keys`` are copies of the JAX
package's host helpers for the sharded evaluator and service, which mask
train positives after the sharded top-k's merge.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MASK_VALUE = -1e8


def mask_seen_post_merge(scores, ids, uid_arr, train_keys, n_items,
                         mask_value=MASK_VALUE):
    """Host-side vectorized train-positive masking for over-fetched top-k
    candidates after a sharded merge (shared by the sharded evaluator,
    `parallel/trainer.py::test`, and the serving path).

    ``train_keys`` = int64 ``user * n_items + item`` of every train edge,
    SORTED (the callers sort them once; ``train_edge_keys`` of a canonical
    CSR matrix is sorted): they are searched, where the JAX package's
    ``np.isin`` sorts both arrays a call; the same mask.
    ``ids >= n_items`` marks row-padding from `pad_rows_to`. Returns a
    masked COPY of ``scores``."""
    uid_arr = np.asarray(uid_arr, dtype=np.int64)
    ids = np.asarray(ids)
    valid = ids < n_items
    query = uid_arr[:, None] * n_items + np.where(valid, ids, 0)
    train_keys = np.asarray(train_keys)
    seen = np.zeros(query.shape, dtype=bool)
    if len(train_keys):
        at = np.minimum(np.searchsorted(train_keys, query), len(train_keys) - 1)
        seen = (train_keys[at] == query) & valid
    out = np.asarray(scores).copy()
    out[seen | ~valid] = mask_value
    return out


def train_edge_keys(interaction_mat, n_items):
    """int64 ``user * n_items + item`` keys of every train edge (the
    immutable structure `mask_seen_post_merge` queries against)."""
    coo = interaction_mat.tocoo()
    return coo.row.astype(np.int64) * n_items + coo.col.astype(np.int64)


def mask_trained_(scores: torch.Tensor, user_positives: torch.Tensor) -> torch.Tensor:
    """Mask each user's train positives to −1e8 in place; returns ``scores``.

    scores: f32[B, n_items]; user_positives: int[B, max_deg] padded with −1.
    A scatter-min, as the JAX version: real positives take MASK_VALUE, the −1
    pads take +inf and leave the score untouched."""
    pos = user_positives.long()
    # the fills made on the device (a CUDA graph captures no host copy)
    fill = torch.where(pos >= 0, torch.full_like(pos, MASK_VALUE, dtype=scores.dtype),
                       torch.full_like(pos, float("inf"), dtype=scores.dtype))
    return scores.scatter_reduce_(1, pos.clamp(min=0), fill, reduce="amin")


def mask_trained(scores: torch.Tensor, user_positives: torch.Tensor) -> torch.Tensor:
    """``mask_trained_`` on a copy of ``scores``."""
    return mask_trained_(scores.clone(), user_positives)


def masked_topk(scores: torch.Tensor, user_positives: torch.Tensor, k: int):
    """(top_scores, top_ids) over items with train positives excluded."""
    return torch.topk(mask_trained(scores, user_positives), k, dim=1)


def pow2_bucket(n: int, cap: int) -> int:
    """The least power of two >= ``n``, at most ``cap``: a padded block's
    rows (the JAX package's ``_pow2_bucket``)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


def wave_rows(b: int) -> int:
    """The rows a service pads a wave of ``b`` users to (the JAX service's
    rule): a power of two up to 1,024, a larger wave as it is."""
    return pow2_bucket(max(b, 1), max(1024, b))


def score_block(user_rows: torch.Tensor, item_emb: torch.Tensor, user_positives: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's masked top-k (the JAX package's ``_score_block``): the
    [rows, n_items] scores in f32, the positives masked in place, top-k."""
    scores = user_rows @ item_emb.T
    return torch.topk(mask_trained_(scores, user_positives), k, dim=1)


class ScoreBlock:
    """``score_block`` as CUDA graphs on the card, one per padded shape.

    A graph is keyed by (source, rows, positives width, k) and reads static
    buffers: the item table (``items``, a copy of the table it was made
    with when it captures), and per key the block's inputs. Three sources:
      * ``rows`` (``topk``): the user rows and positives are given as
        device tensors and copied into the key's buffers before a replay;
        evaluation's blocks, whose tables change at every evaluation, so
        each call copies its item table into ``items``;
      * ``ids`` (``topk_ids``): the service's fixed tables; a block is the
        ids of its users, copied from the host into the key's buffer, and
        the graph gathers the user rows and (``positives="table"``) the
        positives rows itself; host positives (the host-CSR branch) are
        copied in, no exclusion is a column of −1;
      * ``merged`` (``merged_topk``, ``merged_ids``): a row-sharded table's
        top-k with its merge across the ranks (the sharded evaluator's
        blocks, the mesh service's waves; a ``parallel.collectives.
        sharded_topk`` that the caller passes, so the graph holds NCCL's
        all-gathers), keyed by (rows, k); the train positives are masked on
        the host after the merge, as the JAX package masks after
        ``fetch_global``. Every rank makes the same calls, so every rank
        captures the same keys in the same order.
    A key's first call runs the body once on the block's side stream (its
    warm-up: cuBLAS's handle and workspace for that stream), captures it
    and replays it; every answer on the card is a replay (``stats``). All
    graphs share one memory pool, so the largest block's score buffer is
    held once; a call holds one lock from its item table's copy to its last
    block's answer, each answer copied out of the pool before the next
    replay. Captures run in ``thread_local`` mode and leave the process's
    allocator cache as it is: other threads (a service's HTTP handlers)
    may make CUDA calls meanwhile. ``graphs=False`` runs the bodies eagerly
    on any device (the reference a replay is held to); on the CPU they
    always do. ``keys`` holds every key met, on any device; ``captures``
    each capture's key, seconds and the bytes of device memory it reserved
    (the pool's growth)."""

    def __init__(self, item_emb: torch.Tensor, user_emb: Optional[torch.Tensor] = None,
                 user_positives: Optional[torch.Tensor] = None, graphs: bool = True):
        self.device = item_emb.device
        self.capture = graphs and self.device.type == "cuda"
        self.items = item_emb.clone() if self.capture else item_emb
        self.user_emb, self.user_positives = user_emb, user_positives
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.stream = torch.cuda.Stream(self.device) if self.capture else None
        self._graphs: Dict[tuple, tuple] = {}  # key -> (graph, static inputs, output)
        self._lock = threading.Lock()
        self.keys: set = set()
        self.captures: List[dict] = []
        self.stats = {"replays": 0, "eager": 0}

    def _set_items(self, item_emb: torch.Tensor) -> None:
        """The item table the blocks score: copied into ``items`` where
        graphs read it at its address, else taken as it is. The caller
        holds the lock."""
        if item_emb is self.items:
            return
        if not self.capture:
            self.items = item_emb
            return
        if item_emb.shape != self.items.shape or item_emb.dtype != self.items.dtype:
            raise ValueError(f"item table {tuple(item_emb.shape)} {item_emb.dtype} where the "
                             f"graphs read {tuple(self.items.shape)} {self.items.dtype}")
        self.items.copy_(item_emb)

    def _run(self, key: tuple, sources: List[torch.Tensor], body):
        """``body(*inputs)`` on ``sources`` (the first dimension is the
        block's rows): eagerly, or through ``key``'s graph, its static
        inputs filled from ``sources``. The caller holds the lock and copies
        the output out."""
        self.keys.add(key)
        if not self.capture:
            self.stats["eager"] += 1
            return body(*sources)
        entry = self._graphs.get(key)
        if entry is None:
            inputs = [torch.empty(s.shape, dtype=s.dtype, device=self.device) for s in sources]
            for static, s in zip(inputs, sources):
                static.copy_(s)
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream):
                body(*inputs)  # the warm-up
                reserved = torch.cuda.memory_reserved(self.device)
                t0 = time.perf_counter()
                # capture_begin, not torch.cuda.graph: no synchronize and no
                # empty_cache of the whole process on a serving thread
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = body(*inputs)
                finally:
                    graph.capture_end()
            current.wait_stream(self.stream)
            self.captures.append({"key": "/".join(map(str, key)),
                                  "seconds": time.perf_counter() - t0,
                                  "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved})
            entry = self._graphs[key] = (graph, inputs, out)
        graph, inputs, out = entry
        for static, s in zip(inputs, sources):
            static.copy_(s)
        graph.replay()
        self.stats["replays"] += 1
        return out

    def topk(self, user_emb: torch.Tensor, item_emb: torch.Tensor,
             user_positives: torch.Tensor, k: int,
             batch_size: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
        """``topk_with_exclusions`` through this block's graphs: (scores
        f32[U, k], ids int64[U, k]) on the device, ``item_emb`` copied into
        the static table under the call's lock."""

        def one(u, pos):
            key = ("rows", u.shape[0], pos.shape[1], k)
            s, i = self._run(key, [u, pos], lambda u, pos: score_block(u, self.items, pos, k))
            return s.clone(), i.clone()

        with self._lock:
            self._set_items(item_emb)
            return padded_blocks(user_emb, user_positives, k, batch_size, one)

    def topk_ids(self, uids: np.ndarray, k: int, positives=None,
                 batch_size: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        """The service's masked top-k for the users ``uids`` (padded by the
        caller), in blocks of ``batch_size`` whose tail is padded to a power
        of two with user 0: (scores f32[B, k], ids i32[B, k]) on the host.
        ``positives``: None (no exclusion), ``"table"`` (rows of
        ``user_positives``) or host positives int32[B, width]."""
        uids = np.asarray(uids, dtype=np.int64)
        outs = []
        for start in range(0, len(uids), batch_size):
            ids = uids[start:start + batch_size]
            b = len(ids)
            rows = pow2_bucket(b, batch_size)
            ids = np.concatenate([ids, np.zeros(rows - b, np.int64)])
            sources = [torch.from_numpy(ids)]
            if isinstance(positives, np.ndarray):
                pos = positives[start:start + b]
                pos = np.concatenate([pos, np.full((rows - b, pos.shape[1]), -1, pos.dtype)])
                sources.append(torch.from_numpy(pos))
                width = pos.shape[1]
            else:
                width = self.user_positives.shape[1] if positives == "table" else 1
            key = ("ids", rows, width, k, "host" if len(sources) > 1 else positives or "none")

            def body(ids_t, pos_t=None):
                ids_t = ids_t.to(self.device)
                if pos_t is None:
                    pos_t = (self.user_positives[ids_t] if positives == "table" else
                             torch.full((rows, 1), -1, dtype=torch.int32, device=self.device))
                s, i = score_block(self.user_emb[ids_t], self.items, pos_t.to(self.device), k)
                # one output: the scores' bits and the ids, one copy to the host
                return torch.cat([s.view(torch.int32), i.to(torch.int32)], dim=1)

            with self._lock:
                outs.append(self._run(key, sources, body).cpu().numpy()[:b])
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        return (np.ascontiguousarray(out[:, :k]).view(np.float32),
                np.ascontiguousarray(out[:, k:]))


    def merged_topk(self, user_rows: torch.Tensor, item_emb: torch.Tensor, k: int, merge,
                    rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sharded evaluator's block: ``merge(user_rows, items, k)`` (a
        top-k over this rank's rows of a row-sharded item table whose
        candidates it merges across the ranks, a collective that every rank
        makes with the same shapes in the same order) on ``user_rows``
        padded with zero rows to ``rows``, through that shape's graph, the
        rank's rows ``item_emb`` copied into the static table. Returns
        (scores, ids) of the unpadded rows on the device."""
        b = user_rows.shape[0]
        rows = b if rows is None else rows
        if rows != b:
            user_rows = torch.cat([user_rows, user_rows.new_zeros((rows - b,)
                                                                  + tuple(user_rows.shape[1:]))])
        with self._lock:
            self._set_items(item_emb)
            s, i = self._run(("merged", rows, k), [user_rows],
                             lambda u: merge(u, self.items, k))
            return s[:b].clone(), i[:b].clone()

    def merged_ids(self, uids: np.ndarray, k: int, merge) -> Tuple[np.ndarray, np.ndarray]:
        """The mesh service's wave: ``merge`` (as ``merged_topk``'s) over
        the rows of ``user_emb`` at the users ``uids`` (padded by the
        caller), gathered in the graph: the ids copied into the key's
        buffer, one replay, the scores' bits and the ids in one int32
        output copied out. Returns (scores f32[B, k'], ids int64[B, k']) on
        the host, k' = ``merge``'s k."""
        rows = len(uids)

        def body(ids_t):
            s, i = merge(self.user_emb[ids_t.to(self.device)], self.items, k)
            return torch.cat([s.view(torch.int32), i.to(torch.int32)], dim=1)

        with self._lock:
            out = self._run(("merged_ids", rows, k),
                            [torch.from_numpy(np.asarray(uids, dtype=np.int64))],
                            body).cpu().numpy()
        width = out.shape[1] // 2
        return (np.ascontiguousarray(out[:, :width]).view(np.float32),
                out[:, width:].astype(np.int64))


def padded_blocks(user_emb: torch.Tensor, user_positives: torch.Tensor, k: int,
                  batch_size: int, block_topk) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block_topk(rows, positives)`` over blocks of ``batch_size`` users,
    the tail block padded to ``pow2_bucket(b, batch_size)`` rows with zero
    user rows and −1 positives, as the JAX package pads it; the answers
    sliced back and joined."""
    outs_s, outs_i = [], []
    for start in range(0, user_emb.shape[0], batch_size):
        ue = user_emb[start:start + batch_size]
        up = user_positives[start:start + batch_size]
        b = ue.shape[0]
        rows = pow2_bucket(b, batch_size)
        if rows != b:
            ue = torch.cat([ue, ue.new_zeros((rows - b, ue.shape[1]))])
            up = torch.cat([up, up.new_full((rows - b, up.shape[1]), -1)])
        s, i = block_topk(ue, up)
        outs_s.append(s[:b])
        outs_i.append(i[:b])
    if not outs_s:
        empty = user_emb.new_empty((0, k))
        return empty, empty.long()
    return torch.cat(outs_s), torch.cat(outs_i)


def topk_with_exclusions(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    user_positives: torch.Tensor,
    k: int,
    batch_size: int = 1024,
    block: Optional[ScoreBlock] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-catalog MIPS top-k for a block of users, batched to bound the
    [B, n_items] score buffer. Returns (scores f32[U, k], ids int64[U, k]),
    on the embeddings' device.

    The blocks (``padded_blocks``: the tail padded to a power of two) go
    through ``block``'s graphs (``ScoreBlock.topk``), or with no ``block``
    through ``score_block`` eagerly."""
    if block is not None:
        return block.topk(user_emb, item_emb, user_positives, k, batch_size)
    return padded_blocks(user_emb, user_positives, k, batch_size,
                         lambda u, pos: score_block(u, item_emb, pos, k))


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
