"""Online retrieval service (counterpart of ``recommendation_tpu/serve/service.py``).

``RecommenderService`` holds the frozen (user_emb, item_emb) tables on their
device and answers batch queries with the masked full-catalog top-k, train
positives excluded exactly as in evaluation.

A wave is padded as the JAX service pads it: its users to
``ops.topk.wave_rows(b)`` with user 0 (a power of two up to 1,024), in
blocks of 1,024 with the tail padded to a power of two, and, on the
host-CSR branch (a graph without a positives table), the positives'
width to a power of two. On the card each padded shape is one CUDA graph
of the service's ``ScoreBlock`` (``ops/topk.py``) that gathers the user
rows and the positives rows itself: a wave is one copy of its ids into
a static buffer, one replay and one copy of the answers out. A shape's
first wave pays its warm-up and capture (the JAX service pays a compile
a shape too); the graphs are captured on first use, on the thread that
serves the wave (the MicroBatcher's dispatcher), in ``thread_local``
mode, so the HTTP threads may make CUDA calls meanwhile. ``block.stats``
counts the replays (and the eager waves of the CPU). With a ``mesh``
(``parallel/mesh.py``) the item table is padded to a multiple of the model
axis and each model rank holds its rows: a wave, padded to
``wave_rows(b)`` with user 0 as above, gathers its user rows, scores the
rank's rows, merges the ranks' candidates
(``parallel.collectives.sharded_topk``), having over-fetched by the wave's
heaviest degree plus the padding rows, that count rounded up to a
multiple of 64 (capped at the padded table's rows) as the JAX service
rounds it, so that a wave's shape is one of a few; then the train
positives and the padding rows are masked on the host after the merge,
as the JAX service masks after ``fetch_global``, against train-edge keys
sorted once. Where the model group's collectives are NCCL's on a card,
each padded shape (rows, that count) is one CUDA graph of the service's
``ScoreBlock`` (``merged_ids``: the gather, the scores, the local top-k,
the all-gathers and the merge), captured on first use as above; over
gloo the same padded wave runs eagerly. Every rank of the mesh must make
the same queries in the same order (the merge is a collective), so a
service over several processes answers each wave in all of them, and
every rank captures the same shapes in the same order; the MicroBatcher
and HTTP front end are the single process's.

Construction paths:
  * ``RecommenderService.from_recommender(rec, mesh=None)`` — after training;
  * ``RecommenderService(user_emb, item_emb, data, graph, mesh=None)`` —
    with the tables from the model's ``eval_embeddings`` (e.g. restored
    parameters).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.ranking import host_positives
from recommendation_tpu_torch.ops.topk import (
    MASK_VALUE,
    ScoreBlock,
    mask_seen_post_merge,
    train_edge_keys,
    wave_rows,
)


class RecommenderService:
    def __init__(self, user_emb: torch.Tensor, item_emb: torch.Tensor, data: Interaction, graph,
                 mesh=None):
        if user_emb.device != item_emb.device or user_emb.device != graph.device:
            raise ValueError(
                f"tables and graph must share a device: {user_emb.device}, "
                f"{item_emb.device}, {graph.device}"
            )
        self.user_emb = user_emb.float().contiguous()
        self.item_emb = item_emb.float().contiguous()
        self.data = data
        self.graph = graph
        self.mesh = mesh
        self.block = None
        if mesh is None:
            self.block = ScoreBlock(self.item_emb, user_emb=self.user_emb,
                                    user_positives=(graph.user_positives if graph.has_pos_table
                                                    else None))
        else:
            from recommendation_tpu_torch.parallel.collectives import captures
            from recommendation_tpu_torch.parallel.embedding import pad_rows_to
            from recommendation_tpu_torch.parallel.mesh import (
                MODEL_AXIS,
                axis_group,
                axis_size,
                table_rows,
            )

            padded = pad_rows_to(self.item_emb, axis_size(mesh, MODEL_AXIS))
            lo, hi = table_rows(padded.shape[0], mesh)
            self._item_local = padded[lo:hi].contiguous()
            self._n_padded = padded.shape[0]
            self._train_keys = np.sort(train_edge_keys(data.interaction_mat, data.item_num))
            self.block = ScoreBlock(self._item_local, user_emb=self.user_emb,
                                    graphs=captures(axis_group(mesh, MODEL_AXIS)))

    @classmethod
    def from_recommender(cls, rec, mesh=None) -> "RecommenderService":
        user_emb, item_emb = rec.model.eval_embeddings(rec.model_params(), rec.state, rec.graph)
        return cls(user_emb, item_emb, rec.data, rec.graph, mesh=mesh)

    # -- request batching ------------------------------------------------------

    _batcher = None

    def enable_batching(self, max_batch: int = 1024, max_wait_ms: float = 2.0):
        """Route concurrent ``recommend_ids`` calls through a dispatcher
        thread that answers each wave with one device call
        (`serve/batching.py`). Idempotent; returns the batcher (its
        ``.stats`` count requests vs device calls)."""
        if self._batcher is None:
            from recommendation_tpu_torch.serve.batching import MicroBatcher

            self._batcher = MicroBatcher(self, max_batch, max_wait_ms)
        return self._batcher

    def disable_batching(self):
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    # -- queries --------------------------------------------------------------

    def recommend_ids(
        self, user_ids: Sequence[int], k: int = 10, exclude_seen: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores f32[B,k], item ids i32[B,k]) for INTERNAL user ids.
        With batching enabled, enqueues and waits on the shared dispatcher
        (one device call per wave of concurrent requests)."""
        batcher = self._batcher  # snapshot: disable_batching may race
        if batcher is not None:
            from recommendation_tpu_torch.serve.batching import BatcherClosed

            try:
                return batcher.submit(user_ids, k, exclude_seen).result(timeout=60)
            except BatcherClosed:
                # batcher closed around the submit — the request is still
                # valid, answer it directly. Device errors propagate.
                pass
        return self._recommend_ids_device(user_ids, k, exclude_seen)

    def _recommend_ids_device(
        self, user_ids: Sequence[int], k: int = 10, exclude_seen: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """The device query (what the batcher dispatches): the wave padded
        to ``wave_rows(b)`` with user 0, through the service's graphs."""
        uids = np.asarray(user_ids, dtype=np.int64)
        if self.mesh is not None:
            return self._recommend_ids_sharded(uids, k, exclude_seen)
        padded, pos = self.wave_inputs(uids, exclude_seen)
        s, i = self.block.topk_ids(padded, k, pos)
        return s[:len(uids)], i[:len(uids)]

    def wave_inputs(self, user_ids: Sequence[int], exclude_seen: bool = True):
        """A wave's users padded with user 0 to ``wave_rows(b)`` and its
        positives (``ScoreBlock.topk_ids``' ``positives``): the table's
        rows, host positives at a power-of-two width, or None."""
        uids = np.asarray(user_ids, dtype=np.int64)
        padded = np.concatenate([uids, np.zeros(wave_rows(len(uids)) - len(uids), np.int64)])
        pos = None
        if exclude_seen:
            pos = ("table" if self.graph.has_pos_table
                   else host_positives(self.data, padded, pow2=True))
        return padded, pos

    def eager_block(self) -> ScoreBlock:
        """The service's block with its bodies run eagerly: the reference a
        replayed wave is held to."""
        if self.mesh is not None:
            return ScoreBlock(self._item_local, user_emb=self.user_emb, graphs=False)
        return ScoreBlock(self.item_emb, user_emb=self.user_emb,
                          user_positives=self.block.user_positives, graphs=False)

    def sharded_fetch(self, user_ids: Sequence[int], k: int, exclude_seen: bool = True) -> int:
        """The mesh query's candidate count for a wave: past its heaviest
        degree (with exclusions) plus the zero-scoring padding rows, rounded
        up to a multiple of 64, at most the padded table's rows."""
        over = 0
        if exclude_seen and len(user_ids):
            over = int(np.diff(self.data.interaction_mat.indptr)[np.asarray(user_ids)].max())
        kk = min(k + over + self._n_padded - self.data.item_num, self._n_padded)
        return min(-(-kk // 64) * 64, self._n_padded)

    def _recommend_ids_sharded(self, uids: np.ndarray, k: int,
                               exclude_seen: bool) -> tuple[np.ndarray, np.ndarray]:
        """The mesh's query: the wave padded to ``wave_rows(b)`` with user 0,
        ``sharded_fetch`` candidates merged through the block, the unpadded
        rows masked on the host."""
        from recommendation_tpu_torch.parallel.collectives import sharded_topk

        n_items = self.data.item_num
        padded, _ = self.wave_inputs(uids, False)
        s, i = self.block.merged_ids(padded, self.sharded_fetch(uids, k, exclude_seen),
                                     functools.partial(sharded_topk, mesh=self.mesh))
        s, i = s[:len(uids)], i[:len(uids)]
        keys = self._train_keys if exclude_seen else self._train_keys[:0]
        s = mask_seen_post_merge(s, i, uids, keys, n_items, MASK_VALUE)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(s, order, axis=1),
                np.take_along_axis(i, order, axis=1).astype(np.int32))

    def recommend(
        self, users: Sequence, k: int = 10, exclude_seen: bool = True
    ) -> List[Optional[List[Dict]]]:
        """External-id batch query. Unknown users yield None (caller decides
        the cold-start fallback)."""
        known = [(row, self.data.get_user_id(u)) for row, u in enumerate(users)]
        valid = [(row, uid) for row, uid in known if uid is not None]
        out: List[Optional[List[Dict]]] = [None] * len(users)
        if valid:
            rows, uids = zip(*valid)
            scores, ids = self.recommend_ids(list(uids), k, exclude_seen)
            for out_row, s_row, i_row in zip(rows, scores, ids):
                out[out_row] = [
                    {"item": self.data.id2item[int(i)], "score": float(s)}
                    for s, i in zip(s_row, i_row)
                ]
        return out
