"""How far NCL's and GAT's (2, 1) epochs sit from the single run, step by
step, beside planted faults, on the card.

On ``chip_smoke.py``'s clustered graph (bucketed, f32, d = 64, B = 8192,
Adam 1e-3, one epoch of 110 steps), NCL and GAT at their defaults, each
run with its tables and Adam moments copied after each count of STEPS
(``chip_smoke.StepSnapshot``) and at the epoch's end (its checkpoint):

  * ``single``: the single-rank trainer (the reference);
  * ``reversed``: the single trainer with each batch's rows reversed
    (another summation order, no data group);
  * ``data_2x1``: a (2, 1) world of this script's ranks over gloo on the
    one card (``ShardedGraphRecommender``);
  * ``double``, ``half``: the same world with a fault planted in the
    probe's placement, never in the program: the data group's summed
    gradient doubled, or each rank's batch cut to the first half of its
    rows.

Each run against ``single`` by part (tables, exp_avg, exp_avg_sq: the
largest difference over the largest magnitude, ``chip_smoke.table_gap``)
at each count. ``chip_smoke.py`` holds the (2, 1) epoch at its
SHARDED_SNAPSHOT_STEPS count. Prints one JSON line, and writes it to
``--json`` where given.

    PYTHONPATH=. python3 tools/probe_sharded_epochs.py [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops import build as kernels
from recommendation_tpu_torch.parallel.distributed import merged_checkpoint
from recommendation_tpu_torch.sampling import PairwiseBatch

MODELS = ("ncl", "gat")
STEPS = (1, 2, 4, 8, 16, 32, 64, 96)
WORLD_VARIANTS = ("data_2x1", "double", "half")


class Reversed(cs.StepSnapshot):
    """Each batch's rows in reverse order (a single trainer)."""

    def batch(self, whole):
        return super().batch(PairwiseBatch(*(a.flip(0) for a in whole[:4])))


class Doubled(cs.StepSnapshot):
    """A planted fault: the data group's summed gradient doubled."""

    def reduce_grads(self, grads):
        return [2.0 * g for g in super().reduce_grads(grads)]


class Half(cs.StepSnapshot):
    """A planted fault: each rank trains on the first half of its rows."""

    def batch(self, whole):
        b = super().batch(whole)
        n = b.users.shape[0] // 2
        return PairwiseBatch(*(a[:n] for a in b[:4]), b.group, b.whole)


WRAPS = {"single": cs.StepSnapshot, "reversed": Reversed, "data_2x1": cs.StepSnapshot,
         "double": Doubled, "half": Half}


def run_epoch(name, variant, data, graph, conf, ckpt, mesh=None):
    """One epoch with the variant's placement: (copies by count, the
    epoch's seconds)."""
    config = default_config(**{**conf, "max.epoch": 1, "checkpoint.dir": ckpt})
    if mesh is None:
        rec = cs.GraphRecommender(build(name, config), data, config, graph=graph,
                                  log=cs.Log(echo=False), device="cuda")
    else:
        from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender

        rec = ShardedGraphRecommender(build(name, config), data, config, graph=graph, mesh=mesh,
                                      log=cs.Log(echo=False), device=graph.device)
    rec.build()
    snap = WRAPS[variant](rec, STEPS)
    rec._placement = snap
    rec.train()
    torch.cuda.synchronize()
    return snap.payloads, rec.epoch_stats[0]["seconds"]


def rank_main(out, pairs_path, conf_json):
    """One rank of the (2, 1) world: every model and world variant; rank 0
    saves the copies to ``out/<model>_<variant>.pt``."""
    import torch.distributed as dist

    from recommendation_tpu_torch.graph.device import DeviceGraph
    from recommendation_tpu_torch.parallel.distributed import initialize, pairs_data
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize("gloo", "cuda")
    conf = json.loads(conf_json)
    data = pairs_data(pairs_path)
    graph = DeviceGraph(data, backend=conf["graph.backend"], device=device)
    mesh = make_mesh(MeshSpec(2, 1), "cuda")
    seconds = {}
    for name in MODELS:
        for variant in WORLD_VARIANTS:
            tag = f"{name}_{variant}"
            payloads, seconds[tag] = run_epoch(name, variant, data, graph, conf,
                                               os.path.join(out, tag), mesh)
            if dist.get_rank() == 0:
                torch.save(payloads, os.path.join(out, f"{tag}.pt"))
            torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        with open(os.path.join(out, "seconds.json"), "w") as f:
            json.dump(seconds, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--rank", nargs=3, default=None, metavar=("OUT", "PAIRS", "CONF"),
                    help="run as one rank of the (2, 1) world")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sharded_epochs: needs a CUDA device", file=sys.stderr)
        return 1
    kernels.build_all()
    if args.rank:
        rank_main(*args.rank)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    data, graph, _ = cs.clustered_build()
    tmp = tempfile.mkdtemp(prefix="probe_sharded_")
    try:
        out = compare(data, graph, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return 0


def compare(data, graph, tmp) -> dict:
    """Every run of the module's docstring in ``tmp``, and their gaps."""
    pairs_path = os.path.join(tmp, "pairs.npz")
    np.savez(pairs_path, pairs=np.concatenate([data.test_pairs, data.training_data]),
             n_users=graph.n_users, n_items=graph.n_items, test_fraction=0.1)
    conf = {"embedding.size": cs.EMB, "batch.size": cs.LARGE_BATCH, "learning.rate": cs.LR,
            "optimizer": "adam", "eval.interval": 1, "item.ranking.topN": [20],
            "graph.backend": "bucketed", "checkpoint.keep": 3}
    runs, seconds = {}, {}
    for name in MODELS:
        for variant in ("single", "reversed"):
            tag = f"{name}_{variant}"
            runs[tag], seconds[tag] = run_epoch(name, variant, data, graph, conf,
                                                os.path.join(tmp, tag))
            torch.cuda.empty_cache()
    world = os.path.join(tmp, "world")
    cs.sharded_world([sys.executable, os.path.abspath(__file__), "--rank", world, pairs_path,
                      json.dumps(conf)], 2, world)
    with open(os.path.join(world, "seconds.json")) as f:
        seconds.update(json.load(f))
    out = {"card": cs.card_line(), "steps": list(STEPS), "epoch_seconds": seconds}
    for name in MODELS:
        want = runs[f"{name}_single"]
        want_end = merged_checkpoint(os.path.join(tmp, f"{name}_single"), 0)
        for variant in ("reversed",) + WORLD_VARIANTS:
            tag = f"{name}_{variant}"
            if variant == "reversed":
                got, ckpt = runs[tag], os.path.join(tmp, tag)
            else:
                got, ckpt = torch.load(os.path.join(world, f"{tag}.pt")), os.path.join(world, tag)
            gaps = {str(s): cs.table_gap(got[s], want[s])[1] for s in STEPS}
            gaps["end"] = cs.table_gap(merged_checkpoint(ckpt, 0), want_end)[1]
            out[tag] = gaps
            print(json.dumps({tag: gaps}), flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
