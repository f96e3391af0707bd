"""Per-model sweep presets (a copy of ``recommendation_tpu/tune/presets.py``):
the reference scripts' `__main__` sweeps as data.

Every reference script ends in a hardcoded hyperparameter sweep; these
presets reproduce each script's search space over our canonical config keys
so that ``python -m recommendation_tpu_torch tune --model X --preset full`` is the
equivalent of ``python <script>.py``.

``mode`` mirrors the reference: top-level scripts run FULL cartesian grids
(`gcl.py:132-143`, `ncl.py:444-455`, `ssl4rec.py:274-284`,
`selfcf.py:604-616`, `directau.py:301-309`), `univariate/` scripts sweep one
key at a time against defaults (`univariate/buir.py:348-368`,
`univariate/mhcn.py:564-579`, `lightgcn.py:131-162`).

Key translation: the reference drifts between `emb_size`/`embedding.size`/
`factors`, `lr`/`learning.rate`, `lambda`/`reg.lambda` etc.; presets use
only canonical keys (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Dict

LR6 = [1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 0.2]
BATCHES = [128, 256, 512, 1024, 2048, 4096]
EMBS = [32, 64, 128, 256, 512, 1024]

PRESETS: Dict[str, dict] = {
    # `lightgcn.py:131-162` — univariate over defaults
    "lightgcn": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "LightGCN.n_layers": 3, "reg.lambda": 1e-4,
                     "n_negs": 1, "loss": "bpr", "optimizer": "adam", "learning.rate": 0.01},
        "grid": {"embedding.size": [32, 64, 128], "LightGCN.n_layers": [1, 2, 3, 4],
                 "learning.rate": [1e-3, 5e-3, 1e-2], "loss": ["bpr", "bce"],
                 "n_negs": [1, 2, 4]},
    },
    # `graphsage.py:137-168`, `gat.py:129-164` — univariate
    "graphsage": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "GraphSAGE.n_layers": 2, "learning.rate": 1e-2},
        "grid": {"embedding.size": [32, 64, 128], "GraphSAGE.n_layers": [1, 2, 3],
                 "learning.rate": [1e-3, 5e-3, 1e-2], "GraphSAGE.dropout": [0.0, 0.2, 0.5]},
    },
    "gat": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "GAT.num_heads": 4, "learning.rate": 5e-3},
        "grid": {"GAT.num_heads": [1, 2, 4, 8], "GAT.hidden": [32, 64],
                 "GAT.dropout": [0.0, 0.2, 0.5], "learning.rate": [1e-3, 5e-3, 1e-2]},
    },
    # `gcl.py:132-143` — full grid
    "gcl": {
        "mode": "grid",
        "grid": {"embedding.size": EMBS, "GCL.num_layers": [1, 2, 3, 4, 5],
                 "learning.rate": [1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2],
                 "weight.decay": [1e-5, 1e-4, 1e-3], "GCL.ssl_temp": [0.1, 0.2, 0.5],
                 "GCL.drop_edge": [0.1, 0.2, 0.3], "GCL.reg_weight": [1e-5, 1e-4, 1e-3],
                 "batch.size": BATCHES},
    },
    # `ncl.py:444-455` — full grid
    "ncl": {
        "mode": "grid",
        "grid": {"embedding.size": EMBS, "batch.size": [64] + BATCHES,
                 "learning.rate": [1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2],
                 "reg.lambda": [1e-4, 5e-4, 1e-3], "NCL.n_layers": [1, 2, 3, 4, 5],
                 "NCL.tau": [0.1, 0.2, 0.3], "NCL.ssl_reg": [1e-5, 1e-4, 1e-3],
                 "NCL.proto_reg": [1e-5, 1e-4, 1e-3], "NCL.alpha": [0.3, 0.5, 0.6],
                 "NCL.num_clusters": [20, 30, 50, 100, 200, 300],
                 "NCL.hyper_layers": [1, 2]},
    },
    # `ssl4rec.py:274-284` — full grid
    "ssl4rec": {
        "mode": "grid",
        "grid": {"n.layers": [1, 2, 3, 4, 5], "embedding.size": EMBS,
                 "batch.size": BATCHES, "learning.rate": LR6,
                 "reg.lambda": [1e-4, 1e-3, 1e-2], "SSL4Rec.tau": [0.07, 0.1, 0.2],
                 "SSL4Rec.alpha": [0.1, 0.2, 0.3], "SSL4Rec.drop": [0.1, 0.2, 0.3]},
    },
    # `selfcf.py:604-616` — full grid
    "selfcf": {
        "mode": "grid",
        "grid": {"embedding.size": EMBS, "batch.size": BATCHES, "learning.rate": LR6,
                 "reg.lambda": [1e-4, 1e-3, 1e-2], "reg.weight": [0.5, 1.0, 2.0],
                 "optimizer": ["adam", "sgd"], "SelfCF.tau": [0.07, 0.1, 0.2],
                 "SelfCF.n_layer": [1, 2, 3, 4, 5]},
    },
    # `directau.py:301-309` — full grid
    "directau": {
        "mode": "grid",
        "grid": {"embedding.size": [16] + EMBS[:-1], "batch.size": [16, 32, 64] + BATCHES[:-1],
                 "learning.rate": [1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3],
                 "reg.lambda": [1e-5, 1e-4, 1e-3], "optimizer": ["adam", "sgd"],
                 "DirectAU.gamma": [0.5, 1.0, 3.0], "DirectAU.n_layers": [1, 2, 3, 4, 5, 6]},
    },
    # `univariate/buir.py:348-368` — univariate
    "buir": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "batch.size": 2048, "reg.lambda": 1e-4,
                     "learning.rate": 1e-3, "BUIR.n_layer": 2, "BUIR.tau": 1.0,
                     "BUIR.drop_rate": 0.2},
        "grid": {"embedding.size": [16, 32, 64, 128, 256, 512], "batch.size": BATCHES,
                 "reg.lambda": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
                 "learning.rate": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
                 "BUIR.n_layer": [1, 2, 3, 4], "BUIR.tau": [0.1, 0.5, 1.0],
                 "BUIR.drop_rate": [0.1, 0.2, 0.3]},
    },
    # `univariate/mhcn.py:564-579` — univariate
    "mhcn": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                     "reg.lambda": 1e-4, "MHCN.n_layer": 2, "MHCN.ss_rate": 0.01},
        "grid": {"embedding.size": [16, 32, 64, 128, 256, 512], "batch.size": BATCHES,
                 "learning.rate": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
                 "reg.lambda": [1e-5, 1e-4, 1e-3, 1e-2, 1e-1],
                 "MHCN.n_layer": [1, 2, 3, 4], "MHCN.ss_rate": [0.001, 0.005, 0.01, 0.05]},
    },
    # `univariate/sept_social.py:492-559` — univariate
    "sept": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                     "reg.lambda": 1e-4, "SEPT.n_layer": 2, "SEPT.ss_rate": 0.005,
                     "SEPT.drop_rate": 0.3, "SEPT.ins_cnt": 10},
        "grid": {"embedding.size": [16, 32, 64, 128], "SEPT.n_layer": [1, 2, 3],
                 "SEPT.ss_rate": [0.001, 0.005, 0.01], "SEPT.drop_rate": [0.1, 0.3, 0.5],
                 "SEPT.ins_cnt": [5, 10, 20]},
    },
    # `univariate/diffnet.py:1152-1223` — univariate
    "diffnet": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                     "reg.lambda": 1e-4, "DiffNet.n_layer": 2},
        "grid": {"embedding.size": [16, 32, 64, 128], "DiffNet.n_layer": [1, 2, 3],
                 "learning.rate": [1e-4, 1e-3, 1e-2], "reg.lambda": [1e-5, 1e-4, 1e-3]},
    },
    # `univariate/esrf.py:1386-1464` — univariate
    "esrf": {
        "mode": "univariate",
        "defaults": {"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                     "reg.lambda": 1e-4, "ESRF.K": 10, "ESRF.beta": 0.1,
                     "ESRF.n_layer": 2},
        "grid": {"ESRF.K": [5, 10, 20, 30], "ESRF.beta": [0.05, 0.1, 0.2],
                 "ESRF.n_layer": [1, 2, 3], "learning.rate": [1e-4, 1e-3, 1e-2]},
    },
    # `univariate/grace.py:582-641`, `gbt.py:472-530`, `bgrl_g2l.py:610-686`
    "grace": {
        "mode": "univariate",
        "defaults": {"GRACE.hidden": 64, "GRACE.tau": 0.5, "learning.rate": 1e-3},
        "grid": {"GRACE.tau": [0.2, 0.5, 0.8], "GRACE.num_layers": [1, 2, 3],
                 "GRACE.drop_edge1": [0.2, 0.3, 0.4], "GRACE.drop_feat1": [0.2, 0.3]},
    },
    "gbt": {
        "mode": "univariate",
        "defaults": {"GBT.out_dim": 64, "learning.rate": 1e-3},
        "grid": {"GBT.drop_edge": [0.1, 0.25, 0.5], "GBT.drop_feat": [0.1, 0.25, 0.5],
                 "learning.rate": [1e-4, 1e-3, 1e-2]},
    },
    "bgrl": {
        "mode": "univariate",
        "defaults": {"BGRL.hidden": 64, "BGRL.momentum": 0.99, "learning.rate": 1e-3},
        "grid": {"BGRL.momentum": [0.9, 0.99, 0.999], "BGRL.num_layers": [1, 2, 3],
                 "BGRL.drop_edge": [0.1, 0.25, 0.5]},
    },
}


def get_preset(model_name: str) -> dict:
    key = model_name.lower()
    if key not in PRESETS:
        raise KeyError(f"no tuning preset for {model_name!r}; have {sorted(PRESETS)}")
    return PRESETS[key]
