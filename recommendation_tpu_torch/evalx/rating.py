"""Rating-prediction evaluation (MAE/RMSE), the counterpart of
``recommendation_tpu/evalx/rating.py`` (`univariate/diffnet.py:560-657`,
``Measure.ratingMeasure``).

The rating predictor is the score dot product, optionally clamped to the
rating scale, with the global train mean as the fallback for unseen pairs.
The dot products of every test pair run as one batched product on the
tables' device; the report is computed on the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.metrics import Metric


def global_mean(data: Interaction) -> float:
    if not len(data.edge_weights):
        return 0.0
    return float(np.mean(data.edge_weights))


def evaluate_rating(
    user_emb,
    item_emb,
    data: Interaction,
    clip: Tuple[float, float] | None = None,
) -> Dict[str, float]:
    """Predict r̂(u,i) = <e_u, e_i> for every test pair; MAE/RMSE report.
    The tables are tensors (on any device) or arrays."""
    ue = torch.as_tensor(user_emb)
    ie = torch.as_tensor(item_emb, device=ue.device)
    mean = global_mean(data)
    ids = [(data.get_user_id(u), data.get_item_id(i)) for u, i, _ in data.test_data]
    known = [k for k, (u, i) in enumerate(ids) if u is not None and i is not None]
    preds = np.full(len(ids), mean, dtype=np.float64)
    if known:
        uid = torch.tensor([ids[k][0] for k in known], dtype=torch.long, device=ue.device)
        iid = torch.tensor([ids[k][1] for k in known], dtype=torch.long, device=ue.device)
        dots = (ue[uid].float() * ie[iid].float()).sum(dim=1)
        preds[known] = dots.cpu().numpy()
    rows = []
    for (user, item, rating), pred in zip(data.test_data, preds):
        pred = float(pred)
        if clip is not None:
            pred = float(np.clip(pred, clip[0], clip[1]))
        rows.append((user, item, float(rating), pred))
    return {"MAE": Metric.MAE(rows), "RMSE": Metric.RMSE(rows)}
