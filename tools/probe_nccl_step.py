"""The sharded step's cost on one card (ROADMAP 13d), measured alone.

On ``chip_smoke.py``'s clustered graph (bucketed, f32, d = 64, L = 3,
B = 8192, Adam 1e-3, 110 steps an epoch), LightGCN at SHARDED_CONF:

  * ``world``: a (1, 1) world over NCCL of ``chip_smoke.py``'s own rank
    (``sharded_nccl_worker``) with no other world beside it: the build in
    parts (imports, the default group, the first collective of each group,
    the import of ``torch._dynamo``, the graph and placement), ``fit``'s two
    epochs (captured), the captured epoch against the eager one bit for bit
    (``graphed_check`` with the placement; a profiled replay), the eager
    step profiled (``profile_steps``, 5 steps), the sharded evaluator,
    the mesh service (waves eager and graphed) and MHCN's captured epochs
    on the hard set's bucketed social graph (``graphed_zoo_check`` on the
    mesh);
  * ``single``: after the world has ended, in this process, the single
    trainer's captured epoch (``graphed_check``) and its eager step
    (``profile_steps``) on the same graph, and the single MHCN's captured
    epochs (``graphed_zoo_check``) on the same social graph.

Every check of the world's holds as in ``chip_smoke.py``. Prints the
card's line and one JSON line, and writes it to ``--json`` where given.

    PYTHONPATH=. python3 tools/probe_nccl_step.py [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops import build as kernels
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the result line here too")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    kernels.build_all()
    data, graph, _ = cs.clustered_build()
    tmp = tempfile.mkdtemp(prefix="nccl_step_")
    try:
        pairs = os.path.join(tmp, "pairs.npz")
        np.savez(pairs, pairs=np.concatenate([data.test_pairs, data.training_data]),
                 n_users=graph.n_users, n_items=graph.n_items, test_fraction=0.1)
        out = os.path.join(tmp, "1x1")
        argv = [sys.executable, cs.__file__, "--sharded-nccl", out, pairs,
                json.dumps({**cs.SHARDED_CONF, "max.epoch": 2})]
        wall = cs.sharded_world(argv, 1, out)
        (fit_report,) = cs.rank_reports(out, 1)
        with open(os.path.join(out, "nccl_rank0.json")) as f:
            world = json.load(f)
        world.update(wall_s=wall, fit={k: fit_report[k] for k in (
            "graph_s", "build_s", "train_s", "epochs", "captures", "epoch_path")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    single = {"graphed": cs.graphed_check("lightgcn clustered bucketed, single", "lightgcn",
                                          data, graph, cs.LARGE_BATCH)}
    config = default_config(**cs.SHARDED_CONF)
    rec = GraphRecommender(build("lightgcn", config), data, config, graph=graph,
                           log=Log(echo=False), device="cuda")
    rec.build()
    single["eager_profile"] = cs.profile_steps(rec, cs.LARGE_BATCH)
    del rec
    hard = cs.Interaction(*cs.make_hard_dataset())
    social = cs.SocialDeviceGraph(hard, cs.synthesize_social(hard), backend="bucketed",
                                  device="cuda")
    single["mhcn"] = cs.graphed_zoo_check("mhcn hard bucketed float32, single", "mhcn", hard,
                                          social, cs.BATCH)
    single["seconds"] = time.perf_counter() - t0
    line = {"card": card, "world": world, "single": single}
    print(json.dumps(line))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
