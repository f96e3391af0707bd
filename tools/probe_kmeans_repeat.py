"""Does k-means give the same bits in two processes on the card?

NCL's E-step clusters the same tables in every rank of a sharded trainer,
so every rank must reach the same centroids and assignments. This probe
runs Lloyd k-means (10 iterations, k = 100) on the same seeded rows
([100,000, 64], the clustered set's item count, drawn around 100 centers)
in two processes on one card, each REPEATS times, with two segment sums:

  * ``index_add``: the sums ``ops/kmeans.py`` used before its repair
    (``index_add_``, which adds with float atomics on the card);
  * ``sorted``: the current ``ops.kmeans._segment_sums`` (one stable sort,
    then each cluster's rows in row order).

It prints one JSON line: each process's digests (SHA-256 of the centroids'
and assignments' bytes) by sum, and whether all of them agree. Then it
times both sums where NCL runs them, on ``chip_smoke.py``'s clustered set
at full width (bucketed, f32, d = 64, k = 100, NCL's defaults):

  * ``segment_sums_ms``: one call on the items' propagated rows with the
    E-step's assignments, device time (``chip_smoke.time_ms``);
  * ``e_step_ms``: ``NCL.e_step`` on both tables (Lloyd, 10 iterations),
    and ``step_ms``: one step (``step_grads``) with
    ``NCL.e_step_cadence='batch'`` (both E-steps inside the loss), each
    the median wall time of a synchronized call;
  * ``epoch_s_per_step``: one epoch at NCL's defaults (the E-step at
    the epoch's start), its seconds over its steps;

with the largest cluster's rows.

    PYTHONPATH=. python3 tools/probe_kmeans_repeat.py [--repeats 3] [--json OUT.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from recommendation_tpu_torch.ops import kmeans as km

N, D, K, ITERS = 100_000, 64, 100, 10


def index_add_sums(x, assign, k):
    sums = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device).index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, assign, torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
    return sums, counts


def digests(repeats: int) -> dict:
    g = torch.Generator().manual_seed(3)
    centers = torch.randn(K, D, generator=g) * 4
    x = (centers[torch.randint(0, K, (N,), generator=g)]
         + torch.randn(N, D, generator=g)).cuda()
    init = km.kmeans_init(g, N, K)
    sorted_sums = km._segment_sums
    out = {}
    for label, sums in (("index_add", index_add_sums), ("sorted", sorted_sums)):
        km._segment_sums = sums
        runs = []
        for _ in range(repeats):
            c, a = km.kmeans(x, init, ITERS)
            torch.cuda.synchronize()
            runs.append(hashlib.sha256(c.cpu().numpy().tobytes()
                                       + a.cpu().numpy().tobytes()).hexdigest()[:16])
        out[label] = runs
    km._segment_sums = sorted_sums
    return out


def wall_ms(fn, reps: int = 10) -> float:
    """Median wall milliseconds of a synchronized call of ``fn``, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def clustered_times() -> dict:
    """Both sums' times on the clustered set (see the module's docstring)."""
    import chip_smoke as cs
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models import build
    from recommendation_tpu_torch.ops import build as kernels
    from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
    from recommendation_tpu_torch.train.loop import step_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    data, graph, _ = cs.clustered_build()
    conf = {"embedding.size": cs.EMB, "batch.size": cs.LARGE_BATCH, "learning.rate": cs.LR,
            "optimizer": "adam", "max.epoch": 1, "eval.interval": 2,
            "graph.backend": "bucketed"}
    out = {}
    sorted_sums = km._segment_sums
    for label, sums in (("index_add", index_add_sums), ("sorted", sorted_sums)):
        km._segment_sums = sums
        row = out[label] = {}
        for cadence in (1, "batch"):
            config = default_config(**{**conf, "NCL.e_step_cadence": cadence})
            rec = cs.GraphRecommender(build("ncl", config), data, config, graph=graph,
                                      log=cs.Log(echo=False), device="cuda")
            rec.build()
            model, params = rec.model, rec.model_params()
            if cadence == 1:
                with torch.no_grad():
                    users, items = model.eval_embeddings(params, rec.state, graph)
                draws = model.cluster_draws(torch.Generator().manual_seed(0), graph)
                state = model.e_step(users, items, draws)
                k, assign = state["item_centroids"].shape[0], state["item_2cluster"].long()
                row["largest_cluster_rows"] = {
                    key: int(torch.bincount(state[f"{key}_2cluster"].long()).max())
                    for key in ("user", "item")}
                row["segment_sums_ms"] = cs.time_ms(lambda: sums(items, assign, k), reps=10)
                row["e_step_ms"] = wall_ms(lambda: model.e_step(users, items, draws))
                rec.train()
                torch.cuda.synchronize()
                row["epoch_s_per_step"] = rec.epoch_stats[0]["seconds"] / -(
                    -graph.n_edges // rec.batch_size)
            else:
                gen = torch.Generator().manual_seed(1)
                arrays = epoch_batches(epoch_words(gen, graph, rec.batch_size), graph,
                                       rec.batch_size)
                batch = PairwiseBatch(*(a[0] for a in arrays[:4]))
                row["step_ms"] = wall_ms(lambda: step_grads(
                    model, graph, rec.params, rec.state, batch,
                    torch.Generator().manual_seed(2)))
            del rec
            torch.cuda.empty_cache()
    km._segment_sums = sorted_sums
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kmeans_repeat: needs a CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(digests(args.repeats)))
        return 0
    procs = [subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                             "--repeats", str(args.repeats)], capture_output=True, text=True,
                            check=True, env=os.environ) for _ in range(2)]
    runs = [json.loads(p.stdout.strip().splitlines()[-1]) for p in procs]
    result = {"card": torch.cuda.get_device_name(0), "rows": [N, D], "k": K,
              "iterations": ITERS, "processes": runs}
    for label in ("index_add", "sorted"):
        seen = {d for r in runs for d in r[label]}
        result[f"{label}_distinct_digests"] = len(seen)
    print(json.dumps(result), flush=True)
    result["clustered"] = clustered_times()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
