"""Online retrieval service (counterpart of ``recommendation_tpu/serve/service.py``).

``RecommenderService`` holds the frozen (user_emb, item_emb) tables on their
device and answers batch queries with the masked full-catalog top-k, train
positives excluded exactly as in evaluation. This is the single-device
service; the JAX package's mesh branch (a row-sharded item table) waits for
the port of ``parallel/``.

Construction paths:
  * ``RecommenderService.from_recommender(rec)`` — after training;
  * ``RecommenderService(user_emb, item_emb, data, graph)`` — with the
    tables from the model's ``eval_embeddings`` (e.g. restored parameters).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.ranking import positives_for
from recommendation_tpu_torch.ops.topk import topk_with_exclusions


class RecommenderService:
    def __init__(self, user_emb: torch.Tensor, item_emb: torch.Tensor, data: Interaction, graph):
        if user_emb.device != item_emb.device or user_emb.device != graph.device:
            raise ValueError(
                f"tables and graph must share a device: {user_emb.device}, "
                f"{item_emb.device}, {graph.device}"
            )
        self.user_emb = user_emb.float().contiguous()
        self.item_emb = item_emb.float().contiguous()
        self.data = data
        self.graph = graph

    @classmethod
    def from_recommender(cls, rec) -> "RecommenderService":
        user_emb, item_emb = rec.model.eval_embeddings(rec.params, rec.state, rec.graph)
        return cls(user_emb, item_emb, rec.data, rec.graph)

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
        """The device query (what the batcher dispatches)."""
        uids = np.asarray(user_ids, dtype=np.int64)
        u = self.user_emb[torch.from_numpy(uids).to(self.user_emb.device)]
        if exclude_seen:
            pos = positives_for(self.data, self.graph, uids)
        else:
            pos = torch.full((len(uids), 1), -1, dtype=torch.int32, device=u.device)
        s, i = topk_with_exclusions(u, self.item_emb, pos, k)
        return s.cpu().numpy(), i.cpu().numpy().astype(np.int32)

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
