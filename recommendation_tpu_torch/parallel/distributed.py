"""Multi-process execution (counterpart of ``recommendation_tpu/parallel/distributed.py``).

One process a rank and a device, joined by ``torch.distributed``:

  * ``initialize(backend, device)`` opens the default group from
    torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) over
    ``tcp://MASTER_ADDR:MASTER_PORT`` and sets the rank's device. The
    backend is the caller's: ``nccl`` wants a card for each local rank and
    raises where there are fewer; ``gloo`` runs on the CPU, or passes CUDA
    tensors through the host, so that several ranks may share one card
    (``cuda:LOCAL_RANK mod cards``). Nothing picks a backend or a device
    by itself;
  * ``make_hybrid_mesh(model)``: the ``(data, model)`` mesh whose model
    groups are ``model`` consecutive ranks of one node and whose data axis
    spans the nodes (torchrun numbers ranks node by node), the flat mesh
    on one node;
  * ``put_global`` / ``fetch_global``: a rank's rows of a host array that
    every rank holds; the full table from the model ranks' shards, as numpy;
  * ``spawn_world``: start a command as the ranks of one world on this
    machine, under a hard timeout that kills every rank;
  * ``_worker_train`` / ``_worker_serve`` at the JAX package's sizes and
    seeds (the 64 x 128 x 3000 set, d = 32, B = 64, 8 Adam steps on the
    batches of ``np.random.default_rng(123)``; LightGCN's tables served
    over a model axis that spans every rank, from a per-rank checkpoint);
    ``dryrun_multihost`` / ``dryrun_serve_multihost`` spawn them and hold
    them to the same computation in one process;
  * ``fit`` (``--jobs fit``): ``ShardedGraphRecommender`` of any
    registered model (``--model``, LightGCN by default) on a pairs file in
    every rank, over one layout, with its per-rank checkpoints and a report
    a rank (with the propagation path: edge-parallel on the segment backend
    at data > 1, each rank's rows and slots).

Every entry point runs on the card (the dryruns and the command line over
NCCL) unless the caller names another device or backend:

    python -m recommendation_tpu_torch.parallel.distributed --device cpu --backend gloo
    torchrun --nproc-per-node=4 -m recommendation_tpu_torch.parallel.distributed \\
        --worker --jobs train,serve --out DIR

The first spawns the dryrun's two workers on the CPU and compares them
with one process; the second runs the workers alone on a machine with a
card for each rank.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from recommendation_tpu_torch.ops.counts import kernel_wrappers
from recommendation_tpu_torch.parallel.collectives import all_gather_cat
from recommendation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    axis_group,
    axis_size,
    batch_rows,
    make_mesh,
    shard_params,
    table_rows,
)

BACKENDS = ("gloo", "nccl")
COLLECTIVE_TIMEOUT_S = 600  # a collective that waits longer fails the rank
WORKER = [sys.executable, "-m", "recommendation_tpu_torch.parallel.distributed", "--worker"]


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    return int(os.environ[name]) if os.environ.get(name) else default


def rank_device(device, backend: str, local_rank: int, local_world: int) -> torch.device:
    """The device of local rank ``local_rank`` of ``local_world``: the CPU,
    or ``cuda:LOCAL_RANK mod cards`` for ``"cuda"``; nccl needs a card for
    each local rank, on its own."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; pass device='cuda'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > n_cards:
        raise RuntimeError(f"the nccl backend needs a card for each local rank: "
                           f"{local_world} local ranks, {n_cards} cards")
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % n_cards)


def initialize(backend: str, device="cuda") -> torch.device:
    """Join the world that torchrun's variables describe and return this
    rank's device, made current where it is a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    master_port = _env_int("MASTER_PORT", None)
    world_size = _env_int("WORLD_SIZE", None)
    rank = _env_int("RANK", None)
    if master_port is None or world_size is None or rank is None:
        raise ValueError("initialize needs MASTER_PORT, WORLD_SIZE and RANK (torchrun sets them)")
    dev = rank_device(device, backend, _env_int("LOCAL_RANK", rank),
                      _env_int("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    master_addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}:{master_port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def make_hybrid_mesh(model: int = 1, device_type: str = "cuda"):
    """The ``(data, model)`` mesh with each model group inside one node
    (``LOCAL_WORLD_SIZE`` ranks a node, numbered node by node) and the
    data axis across the nodes: the data group's gradient sum is the only
    traffic between nodes. With one node it is the flat mesh."""
    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE", world)
    if local % model or world % local:
        raise ValueError(f"model={model} must divide the {local} ranks of a node "
                         f"(world {world})")
    return make_mesh(MeshSpec(data=world // model, model=model), device_type)


def put_global(x: np.ndarray, mesh, device) -> torch.Tensor:
    """This model rank's rows of a host array that every rank holds whole
    (all of it where its rows do not divide by ``model``)."""
    rows = table_rows(len(x), mesh)
    part = x if rows is None else x[rows[0]:rows[1]]
    return torch.from_numpy(np.ascontiguousarray(part)).to(device)


def fetch_global(x: torch.Tensor, mesh, n_rows: Optional[int] = None) -> np.ndarray:
    """The full table, as numpy on every rank, from each model rank's rows
    ``x`` (``n_rows``: the full table's; where they do not divide by the
    model axis, ``x`` is the whole table already)."""
    n_model = axis_size(mesh, MODEL_AXIS)
    if n_rows is not None and n_rows % n_model:
        return x.detach().cpu().numpy()
    return all_gather_cat(x.detach(), axis_group(mesh, MODEL_AXIS)).cpu().numpy()


def merged_checkpoint(directory: str, step: int) -> dict:
    """A run's checkpoint at ``step`` as full host tables: ``params``,
    ``exp_avg`` and ``exp_avg_sq`` by parameter name, ``step`` (Adam's
    count), ``epoch``, ``layout`` and ``draws`` (the device generator's
    state, rank 0's). From a sharded run's rank files (the
    row shards of data rank 0's model ranks in rank order, the replicated
    parameters from rank 0) or from a single-device run's file."""
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    rank0 = CheckpointManager(directory, rank=0)
    if step not in rank0.all_steps():
        payloads, sharded = [CheckpointManager(directory).restore(step)], set()
    else:
        first = rank0.restore(step)
        payloads = [first] + [CheckpointManager(directory, rank=r).restore(step)
                              for r in range(1, first["layout"]["model"])]
        sharded = set(first["sharded"])
    names = list(payloads[0]["params"])
    states = [p["optimizer"]["state"] for p in payloads]

    def full(k, parts):
        return torch.cat(parts) if k in sharded else parts[0]

    out = {"params": {k: full(k, [p["params"][k] for p in payloads]) for k in names},
           "epoch": payloads[0]["epoch"], "layout": payloads[0].get("layout"),
           "draws": payloads[0].get("draws")}
    for m in ("exp_avg", "exp_avg_sq"):
        out[m] = {k: full(k, [st[i][m] for st in states]) for i, k in enumerate(names)}
    out["step"] = {k: float(states[0][i]["step"]) for i, k in enumerate(names)}
    return out


def spawn_world(argv: Sequence[str], n_processes: int, timeout_s: float, log_dir: str,
                env: Optional[dict] = None,
                while_running: Optional[Callable[[], None]] = None) -> list[str]:
    """Run ``argv`` as the ``n_processes`` ranks of one world on this
    machine (torchrun's variables over a free localhost port, one log file
    a rank in ``log_dir``, one CPU thread a rank) and return each rank's
    output. ``while_running`` is called once the ranks have started (work
    of the caller's that overlaps theirs). A rank that exits non-zero, or a
    world that outlives ``timeout_s``, kills every rank and raises with the
    ranks' output."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    try:
        for r in range(n_processes):
            rank_env = dict(os.environ, **(env or {}), MASTER_ADDR="localhost",
                            MASTER_PORT=str(port), WORLD_SIZE=str(n_processes), RANK=str(r),
                            LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n_processes),
                            OMP_NUM_THREADS="1")
            log = open(os.path.join(log_dir, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(list(argv), env=rank_env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        if while_running is not None:
            while_running()
        while (any(p.poll() is None for p in procs) and time.monotonic() < deadline
               and not any(p.poll() not in (None, 0) for p in procs)):
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed or hung:
        what = (f"ranks {failed} failed" if failed else
                f"ranks {hung} outlived the {timeout_s:.0f} s timeout")
        tail = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs))
        raise RuntimeError(f"world of {n_processes}: {what}\n{tail}")
    return outs


# ---------------------------------------------------------------------------
# The JAX package's dryrun workers, at its sizes and seeds.
# ---------------------------------------------------------------------------


def _dryrun_graph(device):
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
    from recommendation_tpu_torch.graph.device import DeviceGraph

    train, test = make_synthetic_dataset(n_users=64, n_items=128, n_interactions=3000, seed=0)
    data = Interaction(train, test)
    return data, DeviceGraph(data, backend="segment", device=device)


def _rank_roundtrip(ckpt_path: str, payload: dict, layout: dict) -> None:
    """Save ``payload`` as this rank's checkpoint and read it back bit for
    bit with its layout."""
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_path, keep=1, rank=layout["rank"])
    mgr.save(0, {**payload, "layout": layout})
    back = mgr.restore(0)
    if back["layout"] != layout:
        raise AssertionError(f"checkpoint layout {back['layout']} != {layout}")
    for k, v in payload.items():
        if not torch.equal(back[k].to(v.device), v):
            raise AssertionError(f"checkpoint round trip diverged on {k}")


def _worker_train(out_path: Optional[str], ckpt_path: Optional[str] = None, device="cuda",
                  init_path: Optional[str] = None, single: bool = False) -> float:
    """LightGCN-BPR, 8 Adam steps on the 64 x 128 x 3000 set (segment
    backend, d = 32, B = 64) from the batches of
    ``np.random.default_rng(123)``, over ``make_hybrid_mesh(model=2)``
    (``single``: in this process alone, no group). ``init_path``: start
    from these parameters (a ``weights.save_params`` file) in place of the
    port's seed-0 init. With ``ckpt_path`` each rank round-trips its shards
    through its checkpoint file. Writes the final user table and the 8
    losses to ``out_path`` (rank 0); returns the last loss."""
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models.lightgcn import LightGCN
    from recommendation_tpu_torch.parallel.trainer import _Placement
    from recommendation_tpu_torch.sampling import PairwiseBatch
    from recommendation_tpu_torch.weights import load_params

    data, graph = _dryrun_graph(device)
    config = default_config(**{"embedding.size": 32, "batch.size": 64})
    model = LightGCN(config)
    if init_path:
        params = load_params(init_path, "lightgcn", device=graph.device)
    else:
        params, _ = model.init(torch.Generator().manual_seed(0), graph)
    bs, n_steps = 64, 8
    rng = np.random.default_rng(123)
    users = rng.integers(0, graph.n_users, (n_steps, bs)).astype(np.int32)
    pos = rng.integers(0, graph.n_items, (n_steps, bs)).astype(np.int32)
    neg = rng.integers(0, graph.n_items, (n_steps, bs)).astype(np.int32)
    batches = tuple(torch.from_numpy(a).to(graph.device)
                    for a in (users, pos, neg, np.ones((n_steps, bs), np.float32))) + (n_steps,)
    mesh = placement = None
    if not single:
        mesh = make_hybrid_mesh(model=2, device_type=graph.device.type)
        params, sharded = shard_params(params, mesh)
        placement = _Placement(mesh, sharded, batch_rows(bs, mesh))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    tensors = list(leaves.values())
    optimizer = torch.optim.Adam(tensors, lr=1e-3, eps=1e-8)
    losses = []
    for step in range(n_steps):
        full = leaves if placement is None else placement.gather(leaves)
        batch = PairwiseBatch(*(a[step] for a in batches[:4]))
        if placement is not None:
            batch = placement.batch(batch)
        loss, _ = model.loss(full, {}, batch, graph)
        grads = torch.autograd.grad(loss, tensors)
        if placement is not None:
            grads = placement.reduce_grads(grads)
        for p, g in zip(tensors, grads):
            p.grad = g
        optimizer.step()
        losses.append(float(loss.detach()))
    final_loss = losses[-1]
    if not np.isfinite(final_loss):
        raise RuntimeError(f"non-finite loss {final_loss}")
    rank = 0 if single else dist.get_rank()
    if ckpt_path and not single:
        _rank_roundtrip(ckpt_path, {k: v.detach() for k, v in leaves.items()},
                        {"data": axis_size(mesh, DATA_AXIS), "model": axis_size(mesh, MODEL_AXIS),
                         "rank": rank})
        dist.barrier()
        if rank == 0:
            print("CKPT_ROUNDTRIP ok")
    user_emb = (leaves["user_emb"].detach().cpu().numpy() if single
                else fetch_global(leaves["user_emb"], mesh, graph.n_users))
    if out_path and rank == 0:
        np.savez(out_path, user_emb=user_emb, losses=np.asarray(losses, np.float32))
    return final_loss


def _worker_serve(out_path: Optional[str], ckpt_path: Optional[str] = None, device="cuda",
                  init_path: Optional[str] = None, single: bool = False) -> None:
    """LightGCN's tables (seed-7 init, or ``init_path``) served over a
    model axis that spans every rank (``single``: the single-device
    service), 16 users of ``np.random.default_rng(11)``, k = 10, with and
    without exclusions. With ``ckpt_path`` the item table reaches the
    service through a per-rank checkpoint of its padded shards. Writes the
    answers to ``out_path`` (rank 0)."""
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models.lightgcn import LightGCN
    from recommendation_tpu_torch.parallel.embedding import pad_rows_to
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.weights import load_params

    data, graph = _dryrun_graph(device)
    model = LightGCN(default_config(**{"embedding.size": 32}))
    if init_path:
        params = load_params(init_path, "lightgcn", device=graph.device)
    else:
        params, _ = model.init(torch.Generator().manual_seed(7), graph)
    # the rank's own replicated graph: this product makes no collective
    user_emb, item_emb = model.eval_embeddings(params, {}, graph)
    mesh = None
    if not single:
        world = dist.get_world_size()
        mesh = make_mesh(MeshSpec(data=1, model=world), graph.device.type)
        if ckpt_path:
            padded = pad_rows_to(item_emb, world)
            local = put_global(padded.cpu().numpy(), mesh, graph.device)
            _rank_roundtrip(ckpt_path, {"item_emb": local},
                            {"data": 1, "model": world, "rank": dist.get_rank()})
            full = fetch_global(local, mesh, padded.shape[0])[:graph.n_items]
            item_emb = torch.from_numpy(full).to(graph.device)
    service = RecommenderService(user_emb, item_emb, data, graph, mesh=mesh)
    rng = np.random.default_rng(11)
    uids = rng.integers(0, data.user_num, 16).tolist()
    scores, ids = service.recommend_ids(uids, k=10, exclude_seen=True)
    scores_raw, ids_raw = service.recommend_ids(uids, k=10, exclude_seen=False)
    if not (np.all(np.isfinite(scores)) and np.all(np.isfinite(scores_raw))):
        raise RuntimeError("non-finite served scores")
    if out_path and (single or dist.get_rank() == 0):
        np.savez(out_path, scores=scores, ids=ids, scores_raw=scores_raw, ids_raw=ids_raw)
        print("SERVE ok")


def dryrun_multihost(n_processes: int = 2, device="cuda", backend: str = "nccl",
                     jobs: Sequence[str] = ("train",), timeout_s: float = 600.0) -> None:
    """Spawn ``n_processes`` workers of ``jobs`` (``train``, ``serve``) and
    hold them to the same jobs in this process alone: the user table and
    losses within atol 1e-5 and the checkpoint round trip (train), the
    served ids equal and the scores within atol 1e-5 (serve)."""
    tmp = tempfile.mkdtemp(prefix="multihost_")
    try:
        argv = WORKER + ["--jobs", ",".join(jobs), "--out", tmp,
                         "--ckpt", os.path.join(tmp, "ckpt"), "--device", str(device),
                         "--backend", backend]

        def one_process():
            for job in jobs:
                (_worker_train if job == "train" else _worker_serve)(
                    os.path.join(tmp, f"{job}_single.npz"), device=device, single=True)

        outs = spawn_world(argv, n_processes, timeout_s, os.path.join(tmp, "logs"),
                           while_running=one_process)
        for job in jobs:
            mp = np.load(os.path.join(tmp, f"{job}.npz"))
            sp = np.load(os.path.join(tmp, f"{job}_single.npz"))
            if job == "train":
                if not np.allclose(mp["user_emb"], sp["user_emb"], atol=1e-5):
                    raise AssertionError("multi-process tables diverged from one process")
                if not np.allclose(mp["losses"], sp["losses"], atol=1e-5):
                    raise AssertionError("multi-process losses diverged from one process")
                if not any("CKPT_ROUNDTRIP ok" in o for o in outs):
                    raise AssertionError("the per-rank checkpoint round trip is missing")
                print(f"dryrun_multihost ok: {n_processes} ranks ({backend}, {device}), "
                      f"final loss {float(mp['losses'][-1]):.5f} as in one process, "
                      f"per-rank checkpoint round trip ok")
            else:
                for key in ("ids", "ids_raw"):
                    if not np.array_equal(mp[key], sp[key]):
                        raise AssertionError(f"multi-process served {key} diverged")
                for key in ("scores", "scores_raw"):
                    if not np.allclose(mp[key], sp[key], atol=1e-5):
                        raise AssertionError(f"multi-process served {key} diverged")
                print(f"dryrun_serve_multihost ok: {n_processes} ranks on the model axis, "
                      f"ids equal to one process's, served from per-rank checkpoints")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun_serve_multihost(n_processes: int = 2, device="cuda", backend: str = "nccl",
                           timeout_s: float = 600.0) -> None:
    """``dryrun_multihost`` of the serving worker alone."""
    dryrun_multihost(n_processes, device, backend, ("serve",), timeout_s)


# ---------------------------------------------------------------------------
# fit: the sharded trainer on a pairs file, in every rank.
# ---------------------------------------------------------------------------


def pairs_data(path: str):
    """The interactions of a pairs file: an ``.npz`` of ``pairs`` [N, 2],
    ``n_users``, ``n_items`` and ``test_fraction``."""
    from recommendation_tpu_torch.data.synthetic import ArrayInteraction

    z = np.load(path)
    return ArrayInteraction(z["pairs"], int(z["n_users"]), int(z["n_items"]),
                            test_fraction=float(z["test_fraction"]))


def fit(data_path: str, mesh, config, out: str, device: torch.device, model: str = "lightgcn"):
    """``ShardedGraphRecommender`` of ``model`` on the pairs file
    ``data_path``, trained over ``mesh`` with ``config``, its per-rank
    checkpoints in ``out/ckpt``. Each rank writes ``out/rank<r>.json``: the
    model, the layout, the shards' rows, the epochs' losses and seconds,
    the graph's, the build's and ``train()``'s seconds, every kernel's
    launches over ``train()`` (``kernel_wrappers``), the propagation
    path with each rank's rows and slots (``edge_report``), and how the
    epochs ran (``epoch_report``: captured under NCCL, eager over gloo)
    with each capture's graph, seconds and pool bytes. Returns the
    trained recommender."""
    from recommendation_tpu_torch.graph.device import DeviceGraph
    from recommendation_tpu_torch.models import build
    from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    data = pairs_data(data_path)
    graph = DeviceGraph(data, backend=config.get("graph.backend", "auto"),
                        compute_dtype=config.get("graph.compute_dtype", "float32"), device=device)
    sync()
    t1 = time.perf_counter()
    config = config.with_overrides(**{"checkpoint.dir": os.path.join(out, "ckpt")})
    rec = ShardedGraphRecommender(build(model, config), data, config, graph=graph,
                                  mesh=mesh, log=Log(echo=False), device=device)
    rec.build()
    sync()
    t2 = time.perf_counter()
    kernels = kernel_wrappers()
    for f in kernels:
        f.launches = 0
    rec.train()
    sync()
    t3 = time.perf_counter()
    rank = dist.get_rank()
    os.makedirs(out, exist_ok=True)
    report = {
        "rank": rank, "model": rec.model.name, "layout": rec.layout(),
        "backend": dist.get_backend(),
        "device": str(device), "sharded": sorted(rec.sharded_params),
        "shard_rows": {k: int(v.shape[0]) for k, v in rec.params.items()},
        "steps_per_epoch": -(-graph.n_edges // rec.batch_size),
        "epochs": rec.epoch_stats, "graph_s": t1 - t0, "build_s": t2 - t1, "train_s": t3 - t2,
        "launches": {f.__name__: f.launches for f in kernels},
        "propagation": rec.edge_report(), "epoch_path": rec.epoch_report(),
        "captures": rec._graphed.captures if rec._graphed is not None else [],
    }
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    print(f"fit ok: rank {rank} of {rec.layout()}")
    return rec


def _main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m recommendation_tpu_torch.parallel.distributed")
    ap.add_argument("--worker", action="store_true",
                    help="run the jobs as one rank (torchrun's variables name it)")
    ap.add_argument("--jobs", default="train,serve",
                    help="comma list of train, serve (the dryrun workers) or fit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl", choices=BACKENDS)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds the dryrun's world may take")
    ap.add_argument("--out", default=None, help="directory the workers write to")
    ap.add_argument("--ckpt", default=None, help="per-rank checkpoint directory of the dryrun")
    ap.add_argument("--data", default=None, help="fit: .npz of pairs, n_users, n_items, test_fraction")
    ap.add_argument("--mesh", default="1x1", help="fit: the layout, DATAxMODEL")
    ap.add_argument("--model", default="lightgcn", help="fit: a registered model")
    ap.add_argument("--set", action="append", default=[], help="fit: config key=value")
    args = ap.parse_args(argv)
    jobs = [j for j in args.jobs.split(",") if j]
    torch.set_num_threads(1)  # the ranks and the one-process reference share the host
    if not args.worker:
        dryrun_multihost(2, args.device, args.backend, jobs, args.timeout)
        return
    device = initialize(args.backend, args.device)
    try:
        for job in jobs:
            if job == "fit":
                from recommendation_tpu_torch.cli import _parse_sets
                from recommendation_tpu_torch.config import default_config

                n_data, n_model = (int(v) for v in args.mesh.split("x"))
                fit(args.data, make_mesh(MeshSpec(n_data, n_model), device.type),
                    default_config(**_parse_sets(args.set)), args.out, device, args.model)
            elif job in ("train", "serve"):
                out = os.path.join(args.out, f"{job}.npz") if args.out else None
                ckpt = os.path.join(args.ckpt, job) if args.ckpt else None
                if job == "train":
                    loss = _worker_train(out, ckpt, device)
                    print(f"worker done: loss={loss:.5f}")
                else:
                    _worker_serve(out, ckpt, device)
            else:
                raise ValueError(f"unknown job {job!r}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
