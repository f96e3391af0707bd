"""Full-catalog ranking evaluation (counterpart of
``recommendation_tpu/evalx/ranking.py``): blocked MIPS scoring over all test
users, train-positive masking and top-k on the embeddings' device, then one
device→host copy of the [U_test, max_N] ids for the metrics.

On the card the blocks replay CUDA graphs (``ops.topk.ScoreBlock``): one
``ScoreBlock`` a graph and item table shape (``score_block_for``), kept as
long as the graph. Its item table is a static buffer that each evaluation
copies the new table into (one device copy, 25.6 MB for the clustered
set's 100,000 × 64 table), rather than graphs keyed by the table's
address: every evaluation's tables are new tensors, so such keys would
capture anew at every evaluation.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.metrics import ranking_evaluation, ranking_metrics
from recommendation_tpu_torch.ops.topk import ScoreBlock, pow2_bucket, topk_with_exclusions


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


def host_positives(data: Interaction, uids: np.ndarray, pow2: bool = False) -> np.ndarray:
    """int32[len(uids), width] train positives from the host CSR, padded
    with −1; the width is the users' largest degree (at least 1), or with
    ``pow2`` its power of two (the JAX service's, at most the item count):
    a graph a width."""
    mat = data.interaction_mat
    degs = np.diff(mat.indptr)[uids].astype(np.int64)
    width = max(1, int(degs.max()) if len(degs) else 1)
    if pow2:
        width = pow2_bucket(width, mat.shape[1])
    pos = np.full((len(uids), width), -1, dtype=np.int32)
    rows = np.repeat(np.arange(len(uids), dtype=np.int64), degs)
    offs = np.arange(degs.sum(), dtype=np.int64) - np.repeat(np.cumsum(degs) - degs, degs)
    starts = mat.indptr[uids].astype(np.int64)
    pos[rows, offs] = mat.indices[offs + np.repeat(starts, degs)]
    return pos


def positives_for(data: Interaction, graph, uids: np.ndarray) -> torch.Tensor:
    """[len(uids), width] train positives padded with −1: rows of the graph's
    table, or, where the graph skipped it, built from the host CSR."""
    if graph.has_pos_table:
        return graph.user_positives[torch.from_numpy(uids.astype(np.int64)).to(graph.device)]
    return torch.from_numpy(host_positives(data, uids)).to(graph.device)


_BLOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def score_block_for(graph, item_emb: torch.Tensor) -> ScoreBlock:
    """The evaluation ``ScoreBlock`` of ``graph`` for tables like
    ``item_emb`` (its graphs and static item table live as long as the
    graph)."""
    blocks = _BLOCKS.setdefault(graph, {})
    key = (tuple(item_emb.shape), item_emb.dtype, item_emb.device)
    if key not in blocks:
        blocks[key] = ScoreBlock(item_emb)
    return blocks[key]


def evaluate_ranking(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    data: Interaction,
    graph,
    Ns: Sequence[int] = (10, 20, 30, 50),
    batch_size: int = 1024,
    block: Optional[ScoreBlock] = None,
) -> RankingResult:
    """Score user_emb @ item_embᵀ for test users, mask train positives,
    extract top-max(N), compute all metrics. The blocks go through
    ``block`` (None: ``score_block_for(graph, item_emb)``)."""
    test_uids = data.test_user_ids()
    rows = torch.from_numpy(test_uids.astype(np.int64)).to(user_emb.device)
    scores, ids = topk_with_exclusions(
        user_emb[rows], item_emb, positives_for(data, graph, test_uids),
        k=max(Ns), batch_size=batch_size,
        block=block if block is not None else score_block_for(graph, item_emb),
    )
    ids_np = ids.cpu().numpy().astype(np.int32)
    metrics = ranking_metrics(ids_np, data.test_items_by_user(), Ns)
    return RankingResult(
        metrics=metrics,
        top_ids=ids_np,
        top_scores=scores.cpu().numpy(),
        test_user_ids=test_uids,
    )
