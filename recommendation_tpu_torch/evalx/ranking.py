"""Full-catalog ranking evaluation (counterpart of
``recommendation_tpu/evalx/ranking.py``): blocked MIPS scoring over all test
users, train-positive masking and top-k on the embeddings' device, then one
device→host copy of the [U_test, max_N] ids for the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.metrics import ranking_evaluation, ranking_metrics
from recommendation_tpu_torch.ops.topk import topk_with_exclusions


@dataclasses.dataclass
class RankingResult:
    metrics: Dict[str, float]
    top_ids: np.ndarray  # i32[U_test, max_N] internal item ids
    top_scores: np.ndarray
    test_user_ids: np.ndarray  # i32[U_test] internal user ids

    def as_reference_dict(self, data: Interaction) -> Dict:
        """{user: [(item, score), ...]} in external ids — the reference's
        ``test()`` return shape (`selfcf.py:408-428`)."""
        out = {}
        for row, uid in enumerate(self.test_user_ids):
            user = data.id2user[int(uid)]
            out[user] = [
                (data.id2item[int(i)], float(s))
                for i, s in zip(self.top_ids[row], self.top_scores[row])
            ]
        return out

    def report(self, data: Interaction, Ns: Sequence[int]) -> List[str]:
        origin = {u: set(items) for u, items in data.test_set.items()}
        return ranking_evaluation(origin, self.as_reference_dict(data), Ns)


def positives_for(data: Interaction, graph, uids: np.ndarray) -> torch.Tensor:
    """[len(uids), width] train positives padded with −1: rows of the graph's
    table, or, where the graph skipped it, built from the host CSR."""
    if graph.has_pos_table:
        return graph.user_positives[torch.from_numpy(uids.astype(np.int64)).to(graph.device)]
    mat = data.interaction_mat
    degs = np.diff(mat.indptr)[uids].astype(np.int64)
    width = max(1, int(degs.max()) if len(degs) else 1)
    pos = np.full((len(uids), width), -1, dtype=np.int32)
    rows = np.repeat(np.arange(len(uids), dtype=np.int64), degs)
    offs = np.arange(degs.sum(), dtype=np.int64) - np.repeat(np.cumsum(degs) - degs, degs)
    starts = mat.indptr[uids].astype(np.int64)
    pos[rows, offs] = mat.indices[offs + np.repeat(starts, degs)]
    return torch.from_numpy(pos).to(graph.device)


def evaluate_ranking(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    data: Interaction,
    graph,
    Ns: Sequence[int] = (10, 20, 30, 50),
    batch_size: int = 1024,
) -> RankingResult:
    """Score user_emb @ item_embᵀ for test users, mask train positives,
    extract top-max(N), compute all metrics."""
    test_uids = data.test_user_ids()
    rows = torch.from_numpy(test_uids.astype(np.int64)).to(user_emb.device)
    scores, ids = topk_with_exclusions(
        user_emb[rows], item_emb, positives_for(data, graph, test_uids),
        k=max(Ns), batch_size=batch_size,
    )
    ids_np = ids.cpu().numpy().astype(np.int32)
    metrics = ranking_metrics(ids_np, data.test_items_by_user(), Ns)
    return RankingResult(
        metrics=metrics,
        top_ids=ids_np,
        top_scores=scores.cpu().numpy(),
        test_user_ids=test_uids,
    )
