"""The port's sharded trainer (``parallel/trainer.py``) in a gloo world of
two CPU processes against its single-device trainer, at the JAX package's
``tests/test_parallel_trainer.py`` configuration (3 epochs, B = 512,
d = 16) on its ``tiny_data`` (made in the workers with the port's copy of
``make_synthetic_dataset``).

One world is spawned for the file (``world``, module scope): each rank runs
this file as a script, builds a (1, 2) and a (2, 1) mesh over the same two
processes, and computes every case; rank 0 writes them to an ``.npz``.
The cases:
  * on the segment, bucketed and dense backends, the single-device run and
    the sharded runs' tables, epoch losses and Adam moments: (1, 2) bit for
    bit (and BUIR's, with its replicated predictor and its EMA targets,
    which ``post_step`` moves from the updated tables); (2, 1) within
    DATA_TOL elementwise and DATA_REL_TOL of each part's largest
    magnitude, the data group's sum in another order
    (the JAX package holds its data axis to 5e-3, ``test_parallel_trainer.py:
    61-62``);
  * the tables and moments held as row shards at (1, 2), whole at (2, 1);
    an odd row count replicated, not padded;
  * the sharded ``test()`` at (1, 2) equal to the single evaluator's metrics;
  * every registered model on the data axis (the zoo, on the dense
    backend; the social models on the social graph of ``tiny_data``): one
    step at (2, 1) against the single step (each rank's loss, the data
    group's summed gradient; NCL also with its E-step in every loss) and
    one epoch (the third, where ESRF is adversarial and SEPT's SSL on)
    against the single run's tables, state, moments and loss, within
    DATA_TOL and DATA_REL_TOL (EPOCH_REL_TOL where a discrete choice may
    flip); DirectAU's and NCL's summed gradients also against the JAX
    package's gradient of the same loss on the same parameters and batch;
    NCL's cluster state bit for bit across the ranks;
  * the per-rank checkpoints: the epoch-1 files hold the live shards and
    moments; a run resumed from the epoch-0 files equals the straight run's
    epoch 1 bit for bit; a (2, 1) run refuses the (1, 2) files;
  * the service's mesh branch at (1, 2) against the single service, and its
    padded waves (users to a power of two, the candidate count rounded up
    to 64) against the same waves unpadded (``_unpadded_wave``);
  * ``GraphedEpoch`` with each layout's placement (its bodies run eagerly
    on the CPU, as on a card without capture) against ``train_epoch`` with
    it bit for bit: two consecutive epochs (a fused block's form) and a
    chunked one; both ranks run the same graph keys in the same order; and
    the trainer over gloo reports its epochs eager and why.
And ``python -m recommendation_tpu_torch.parallel.distributed --device cpu
--backend gloo`` exits 0 (its workers against one process, train and
serve).

Workers run one thread each; the world has a hard timeout that kills its
processes and fails the fixture.
"""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = {
    "max.epoch": 3,
    "batch.size": 512,
    "embedding.size": 16,
    "item.ranking.topN": [10],
    "eval.interval": 3,
}
BACKENDS = ("segment", "bucketed", "dense")
LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1)}
# (2, 1) against one device after 3 epochs: the data group sums each
# gradient in another order, carried through Adam (f32; 6e-8 at most on
# this set): the repo's f32 bound, where the JAX package holds its data
# axis to 5e-3
DATA_TOL = dict(rtol=1e-5, atol=1e-6)
# and each part (tables, exp_avg, exp_avg_sq, losses) by its largest
# difference over its largest magnitude, since exp_avg_sq sits far under
# any absolute bound (2.1e-7 at most on this set, 1e-10 of scale)
DATA_REL_TOL = 1e-5
SERVE_TOL = 1e-5  # scores of a d = 16 dot product, f32
WORLD_TIMEOUT_S = 240
# every registered model, as the data axis's cases: NCL also with its
# E-step inside every loss. One step, and one epoch at ZOO_EPOCH of
# ZOO_EPOCH + 1 (ESRF's adversarial phase, SEPT's SSL on, a late E-step).
ZOO = ("lightgcn", "ncl", "ncl_batch", "directau", "selfcf", "buir", "ssl4rec", "gcl", "grace",
       "gbt", "bgrl", "graphsage", "gat", "diffnet", "sept", "sept_basic", "mhcn", "esrf")
SOCIAL = ("diffnet", "sept", "sept_basic", "mhcn", "esrf")
ZOO_EPOCH = 2
ZOO_CONF = {**CONF, "max.epoch": ZOO_EPOCH + 1, "eval.interval": ZOO_EPOCH + 1}
# narrow widths, and NCL's two contrastive terms weighted to matter beside BPR
ZOO_EXTRA = {
    "ncl": {"NCL.ssl_reg": 1e-3, "NCL.proto_reg": 1e-3},
    "ncl_batch": {"NCL.ssl_reg": 1e-3, "NCL.proto_reg": 1e-3, "NCL.e_step_cadence": "batch"},
    "gat": {"GAT.hidden": 8, "GAT.num_heads": 2},
    "ssl4rec": {"SSL4Rec.out_dim": 16},
    "gcl": {"GCL.proj_dim": 16},
    "grace": {"GRACE.proj_dim": 16},
}
# the epoch's bound where it differs from DATA_REL_TOL. ESRF's gradient
# spans nine orders of magnitude (a BPR summed over the batch beside the
# generator's entries through a gumbel softmax at temperature 0.2 over
# log(clamp(logits))): the data group's other summation order moves a small
# entry's low bits, and Adam's per-entry normalization carries that into a
# whole step of that entry (3.6e-5 of the tables' largest magnitude after
# one epoch; one step stays within DATA_REL_TOL)
EPOCH_REL_TOL = {"esrf": 1e-4}
JAX_CHECKED = ("directau", "ncl")
# edge-parallel propagation (the segment backend at (2, 1)): one step of the
# models over norm_adj and its with_vals copies (DirectAU's binarized one,
# BUIR's dropped edges) against the single step; LightGCN's and DirectAU's
# against the JAX package's gradient on its own edge-sharded placement
EDGE_CASES = ("lightgcn", "directau", "buir")
EDGE_JAX_CHECKED = ("lightgcn", "directau")
EDGE_CONF = {**ZOO_CONF, "graph.backend": "segment"}
# the mesh service's padded waves: users a wave (padded to 16, 16, 8)
PAD_WAVES = (13, 16, 5)
# GraphedEpoch with a placement: unchunked, and chunks of 2 steps (an epoch
# of the segment graph's 4 batches: 2 + 2)
GRAPHED_CHUNKS = (None, 2)


def _zoo_model(case):
    return "ncl" if case == "ncl_batch" else case


def _tiny_data():
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset

    train, test = make_synthetic_dataset(n_users=60, n_items=100, n_interactions=2500, seed=3)
    return Interaction(train, test)


# -- the worker: one rank of the world ------------------------------------------


def _state(rec, name):
    """A run's tables, epoch losses and Adam moments, full (the moments of a
    shard gathered over the model group)."""
    from recommendation_tpu_torch.parallel.collectives import all_gather_cat
    from recommendation_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group

    out = {f"{name}/loss": np.asarray([e["loss"] for e in rec.epoch_stats])}
    for k, v in rec.model_params().items():
        out[f"{name}/{k}"] = v.detach().numpy()
    sharded = getattr(rec, "sharded_params", set())
    for k, p in rec.params.items():
        st = rec.optimizer.state[p]
        if not st:  # a frozen parameter: no gradient, no moments
            continue
        out[f"{name}/shard_rows/{k}"] = np.asarray([p.shape[0] if p.dim() else 1,
                                                    st["exp_avg"].shape[0] if p.dim() else 1])
        for m in ("exp_avg", "exp_avg_sq"):
            t = st[m]
            if k in sharded:
                t = all_gather_cat(t, axis_group(rec.mesh, MODEL_AXIS))
            out[f"{name}/{m}/{k}"] = t.numpy()
        out[f"{name}/step/{k}"] = np.asarray(float(st["step"]))
    return out


def _one_step(rec, epoch, seed):
    """One step of a built trainer with nothing updated: ``epoch_begin``
    of ``epoch`` (its draws from a generator seeded ``seed``), then the
    loss on the first batch of an epoch drawn from a generator seeded
    ``seed + 1``, which also feeds the loss's draws. A sharded trainer
    takes its rows of that batch (its placement's ``batch``) and gives the
    data group's summed gradient. Returns (loss, {name: gradient}, the
    state the loss read, the global batch)."""
    from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
    from recommendation_tpu_torch.train.loop import step_grads

    state = rec.model.epoch_begin(rec.model_params(), rec.state, rec.graph,
                                  torch.Generator().manual_seed(seed), epoch)
    gen = torch.Generator().manual_seed(seed + 1)
    arrays = epoch_batches(epoch_words(gen, rec.graph, rec.batch_size), rec.graph,
                           rec.batch_size)
    whole = PairwiseBatch(*(a[0] for a in arrays[:4]))
    place = rec._placement
    batch = whole if place is None else place.batch(whole)
    loss, grads, _ = step_grads(rec.model, rec.graph, rec.params, state, batch, gen, place)
    names = [k for k, p in rec.params.items() if p.requires_grad]
    return loss.detach(), dict(zip(names, grads)), state, whole


def _rank_digests(tensors):
    """A digest of ``tensors``' bits on every rank: [rank 0's, rank 1's]."""
    import torch.distributed as dist

    digest = torch.tensor([int.from_bytes(hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in tensors)).digest()[:7], "big")])
    seen = [torch.zeros_like(digest) for _ in range(dist.get_world_size())]
    dist.all_gather(seen, digest)
    return [int(x) for x in seen]


def _payload_equal(a, b):
    """Two checkpoint payloads' shards and Adam moments bit for bit."""
    same = all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    for i, st in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        same &= all(torch.equal(st[m], other[m]) for m in ("exp_avg", "exp_avg_sq", "step"))
    return same and a["epoch"] == b["epoch"] and a["layout"] == b["layout"]


def _unpadded_wave(service, uids, k, exclude):
    """A mesh wave as the service answered it before it padded its waves:
    the wave's own rows, the candidates past its heaviest degree (with
    exclusions) and the padding rows, not rounded; merged, then masked."""
    from recommendation_tpu_torch.ops.topk import MASK_VALUE, mask_seen_post_merge
    from recommendation_tpu_torch.parallel.collectives import sharded_topk

    uids = np.asarray(uids, dtype=np.int64)
    n_items = service.data.item_num
    over = int(np.diff(service.data.interaction_mat.indptr)[uids].max()) if exclude else 0
    kk = min(k + over + service._n_padded - n_items, service._n_padded)
    s, i = sharded_topk(service.user_emb[torch.from_numpy(uids)], service._item_local, kk,
                        service.mesh)
    s, i = s.numpy(), i.numpy()
    keys = service._train_keys if exclude else service._train_keys[:0]
    s = mask_seen_post_merge(s, i, uids, keys, n_items, MASK_VALUE)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(s, order, axis=1),
            np.take_along_axis(i, order, axis=1).astype(np.int32))


def _graphed_epochs(rec, out, info, name, chunk):
    """Two consecutive epochs of a built sharded trainer through
    ``GraphedEpoch`` with its placement (``chunk``: its steps_per_call), or
    with ``name`` ending in "eager" through ``train_epoch``: the tables,
    moments, losses and the device generator's state after them, and the
    graph keys every rank ran."""
    import torch.distributed as dist

    from recommendation_tpu_torch.train.graphed import GraphedEpoch
    from recommendation_tpu_torch.train.loop import train_epoch

    runner = GraphedEpoch(rec.model, rec.optimizer, rec.graph, rec.params, rec.batch_size,
                          steps_per_call=chunk, placement=rec._placement)
    state, losses = rec.state, []
    for _ in range(2):
        if name.endswith("eager"):
            state, loss = train_epoch(rec.model, rec.optimizer, rec.graph, rec.params, state,
                                      rec._draws, rec.batch_size, placement=rec._placement)
        else:
            state, loss = runner.run(state, rec._draws)
        losses.append(float(loss))
    rec.state = state
    rec.epoch_stats = [{"loss": x} for x in losses]
    out.update(_state(rec, name))
    out[f"{name}/draws"] = rec._draws.get_state().numpy()
    if not name.endswith("eager"):
        keys = [None] * dist.get_world_size()
        dist.all_gather_object(keys, [list(k) for k in runner.keys])
        info[f"{name}/keys"] = keys
        info[f"{name}/chunks"] = runner.chunks


def _propagation(rec):
    """A sharded trainer's propagation path (None for a single trainer)."""
    return rec.edge_report()["propagation"] if hasattr(rec, "edge_report") else None


class _CountCollectives:
    """Counts ``torch.distributed``'s all-gathers and all-reduces while
    open."""

    NAMES = ("all_gather", "all_reduce", "all_gather_object")

    def __enter__(self):
        import torch.distributed as dist

        self.n, self.saved = 0, {k: getattr(dist, k) for k in self.NAMES}

        def counted(fn):
            def call(*args, **kwargs):
                self.n += 1
                return fn(*args, **kwargs)
            return call

        for k, fn in self.saved.items():
            setattr(dist, k, counted(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for k, fn in self.saved.items():
            setattr(dist, k, fn)


def _edge_forward(rec, graph, out, info):
    """The segment (2, 1) run's edge-parallel path: every rank's report,
    and ``eval_embeddings`` over its sharded graph beside the replicated
    graph's on the same tables (with the edge-parallel products it made)."""
    import torch.distributed as dist

    from recommendation_tpu_torch.ops.spmm import edge_parallel_matmul

    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, rec.edge_report())
    info["edge_reports"] = reports
    info["edge_e_pad"] = int(graph.norm_adj.vals.shape[0])
    info["edge_n_rows"] = int(graph.norm_adj.n_rows)
    params = rec.model_params()
    calls = edge_parallel_matmul.calls
    with torch.no_grad():
        sharded = rec.model.eval_embeddings(params, rec.state, rec.graph)
        info["edge_forward_calls"] = edge_parallel_matmul.calls - calls
        whole = rec.model.eval_embeddings(params, rec.state, graph)
    for tag, tables in (("sharded", sharded), ("replicated", whole)):
        for name, t in zip(("user", "item"), tables):
            out[f"edge/forward/{tag}/{name}"] = t.numpy()


def _edge_steps(trainer, graph, out, info):
    """EDGE_CASES' one step on the segment graph, single and (2, 1) (the
    edge-parallel products each made, the collectives of the single step),
    LightGCN's and DirectAU's inputs for the JAX package's gradient; then a
    single trainer on the same graph object, which must make no
    collective."""
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.ops.spmm import edge_parallel_matmul

    for case in EDGE_CASES:
        config = default_config(**EDGE_CONF)
        for name in ("single", "2x1"):
            rec = trainer(config, graph, None if name == "single" else name, case)
            rec.build()
            params0 = {k: v.detach().clone() for k, v in rec.model_params().items()}
            calls = edge_parallel_matmul.calls
            with _CountCollectives() as counted:
                loss, grads, state, whole = _one_step(rec, ZOO_EPOCH, seed=7)
            prefix = f"edge/{case}/{name}"
            info[f"{prefix}/calls"] = edge_parallel_matmul.calls - calls
            info[f"{prefix}/collectives"] = counted.n
            info[f"{prefix}/propagation"] = _propagation(rec)
            out[f"{prefix}/loss"] = np.asarray(float(loss))
            for k, g in grads.items():
                out[f"{prefix}/grad/{k}"] = g.numpy()
            if case in EDGE_JAX_CHECKED and name == "2x1":
                for k, v in params0.items():
                    out[f"edge/{case}/jax/params/{k}"] = v.numpy()
                for k, v in state.items():
                    out[f"edge/{case}/jax/state/{k}"] = v.numpy()
                for k, v in zip(("users", "pos_items", "neg_items", "weight"), whole):
                    out[f"edge/{case}/jax/batch/{k}"] = v.numpy()
    # the caller's graph after every sharded build: replicated, no collective
    info["edge_shared_graph_unsharded"] = graph.norm_adj.shard is None
    rec = trainer(default_config(**EDGE_CONF), graph)
    rec.build()
    with _CountCollectives() as counted:
        _one_step(rec, ZOO_EPOCH, seed=7)
        rec.test()
    info["edge_shared_graph_collectives"] = counted.n


def _worker(out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset
    from recommendation_tpu_torch.graph.device import DeviceGraph
    from recommendation_tpu_torch.models import build
    from recommendation_tpu_torch.parallel.distributed import initialize
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender
    from recommendation_tpu_torch.sampling import epoch_words
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.train.checkpoint import CheckpointManager
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    initialize("gloo", "cpu")
    rank = dist.get_rank()
    meshes = {name: make_mesh(MeshSpec(*shape), "cpu") for name, shape in LAYOUTS.items()}
    data = _tiny_data()
    out, info = {}, {}

    def trainer(config, graph, layout=None, model="lightgcn", d=data):
        if layout is None:
            return GraphRecommender(build(model, config), d, config, graph=graph,
                                    log=Log(echo=False), device="cpu")
        return ShardedGraphRecommender(build(model, config), d, config, graph=graph,
                                       mesh=meshes[layout], log=Log(echo=False), device="cpu")

    graphs = {b: DeviceGraph(data, backend=b, device="cpu") for b in BACKENDS}
    for backend in BACKENDS:
        config = default_config(**{**CONF, "graph.backend": backend})
        runs = {"single": trainer(config, graphs[backend])}
        runs.update({lay: trainer(config, graphs[backend], lay) for lay in LAYOUTS})
        for name, rec in runs.items():
            rec.build()
            # the first epoch's words, drawn from a replica of the trainer's
            # device generator, and the generator's state after training
            replica = torch.Generator()
            replica.set_state(rec._draws.get_state())
            info[f"words/{backend}/{name}"] = _rank_digests(
                epoch_words(replica, rec.graph, rec.batch_size))
            rec.train()
            info[f"draws_after/{backend}/{name}"] = _rank_digests([rec._draws.get_state()])
            out.update(_state(rec, f"{backend}/{name}"))
            info[f"propagation/{backend}/{name}"] = _propagation(rec)
        if backend == "segment":
            _edge_forward(runs["2x1"], graphs[backend], out, info)
            info["metrics_single"] = runs["single"].test().metrics
            info["metrics_sharded"] = runs["1x2"].test().metrics
            info["sharded_1x2"] = sorted(runs["1x2"].sharded_params)
            info["sharded_2x1"] = sorted(runs["2x1"].sharded_params)
            # the service's mesh branch on the (1, 2) run's tables
            u, i = runs["1x2"].model.eval_embeddings(runs["1x2"].model_params(), {},
                                                     graphs[backend])
            single = RecommenderService(u, i, data, graphs[backend])
            sharded = RecommenderService(u, i, data, graphs[backend], mesh=meshes["1x2"])
            rng = np.random.default_rng(11)
            for w in range(3):
                uids = rng.choice(data.user_num, 16, replace=False).tolist()
                for exclude in (True, False):
                    for tag, svc in (("single", single), ("mesh", sharded)):
                        s, ids = svc.recommend_ids(uids, k=10, exclude_seen=exclude)
                        out[f"serve/{w}/{exclude}/{tag}/scores"] = s
                        out[f"serve/{w}/{exclude}/{tag}/ids"] = ids
                        out[f"serve/{w}/{exclude}/users"] = np.asarray(uids)
            # waves padded to a power of two against the same waves unpadded
            for w, b in enumerate(PAD_WAVES):
                uids = rng.choice(data.user_num, b, replace=False).tolist()
                for exclude in (True, False):
                    for tag, (s, ids) in (
                            ("padded", sharded.recommend_ids(uids, k=10, exclude_seen=exclude)),
                            ("unpadded", _unpadded_wave(sharded, uids, 10, exclude))):
                        out[f"serve_pad/{w}/{exclude}/{tag}/scores"] = s
                        out[f"serve_pad/{w}/{exclude}/{tag}/ids"] = ids
                    info[f"serve_pad/{w}/{exclude}/fetch"] = sharded.sharded_fetch(uids, 10,
                                                                                    exclude)
            info["serve_pad_keys"] = sorted("/".join(map(str, k)) for k in sharded.block.keys)

    # a model with replicated parameters (the predictor) and a post_step
    # that reads the updated tables (BUIR's EMA targets), at (1, 2)
    config = default_config(**{**CONF, "graph.backend": "segment"})
    for name in ("single", "1x2"):
        rec = trainer(config, graphs["segment"], None if name == "single" else name, "buir")
        rec.build()
        rec.train()
        out.update(_state(rec, f"buir/{name}"))
        for k, v in rec.state.items():
            out[f"buir/{name}/state/{k}"] = v.numpy()

    # an odd row count is replicated: 63 users (odd), 99 items (odd)
    odd_train, odd_test = make_synthetic_dataset(n_users=63, n_items=99, n_interactions=2500,
                                                 seed=3)
    odd = Interaction(odd_train, odd_test)
    rec = trainer(default_config(**CONF), DeviceGraph(odd, backend="segment", device="cpu"),
                  "1x2", d=odd)
    rec.build()
    info["odd_rows"] = {k: list(v.shape) for k, v in rec.params.items()}
    info["odd_sharded"] = sorted(rec.sharded_params)
    info["sharded_graphed"] = rec._graphed is not None
    info["epoch_report"] = rec.epoch_report()

    # over gloo the sharded trainer runs its epochs eagerly and refuses fused epochs
    try:
        trainer(default_config(**{**CONF, "eval.interval": 2, "train.fuse_epochs": True}),
                graphs["segment"], "1x2").build()
        info["fuse_true_refused"] = None
    except ValueError as err:
        info["fuse_true_refused"] = str(err)

    # GraphedEpoch with each layout's placement against the eager loop with it
    for layout in LAYOUTS:
        for chunk in GRAPHED_CHUNKS:
            for mode in ("graphed", "eager"):
                rec = trainer(default_config(**{**CONF, "graph.backend": "segment"}),
                              graphs["segment"], layout)
                rec.build()
                _graphed_epochs(rec, out, info, f"graphed/{layout}/{chunk}/{mode}", chunk)

    # every registered model at (2, 1) against the single run: one step
    # (each rank's loss; the summed gradient), then one epoch
    from recommendation_tpu_torch.data.social import synthesize_social
    from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
    from recommendation_tpu_torch.models import available

    social = SocialDeviceGraph(data, synthesize_social(data, threshold=0.35, top_k=5),
                               backend="dense", device="cpu")
    info["zoo_trained_2x1"] = []
    for case in ZOO:
        config = default_config(**{**ZOO_CONF, **ZOO_EXTRA.get(case, {})})
        graph = social if case in SOCIAL else graphs["dense"]
        for name in ("single", "2x1"):
            rec = trainer(config, graph, None if name == "single" else name, _zoo_model(case))
            rec.build()
            params0 = {k: v.detach().clone() for k, v in rec.model_params().items()}
            loss, grads, state, whole = _one_step(rec, ZOO_EPOCH, seed=7)
            prefix = f"zoo/{case}/{name}"
            losses = [torch.zeros(()) for _ in range(dist.get_world_size())]
            dist.all_gather(losses, loss)
            out[f"{prefix}/first/loss"] = np.asarray([float(x) for x in losses])
            for k, g in grads.items():
                out[f"{prefix}/first/grad/{k}"] = g.numpy()
            if case in ("ncl", "ncl_batch"):
                digest = torch.tensor([int.from_bytes(hashlib.sha256(b"".join(
                    state[k].numpy().tobytes() for k in sorted(state))).digest()[:7], "big")])
                seen = [torch.zeros_like(digest) for _ in range(dist.get_world_size())]
                dist.all_gather(seen, digest)
                info[f"{case}_{name}_state_equal"] = all(torch.equal(x, seen[0]) for x in seen)
            if case in JAX_CHECKED and name == "2x1":
                for k, v in params0.items():
                    out[f"zoo/{case}/jax/params/{k}"] = v.numpy()
                for k, v in state.items():
                    out[f"zoo/{case}/jax/state/{k}"] = v.numpy()
                for k, v in zip(("users", "pos_items", "neg_items", "weight"), whole):
                    out[f"zoo/{case}/jax/batch/{k}"] = v.numpy()
            rec.start_epoch = ZOO_EPOCH  # one epoch: the last
            rec.train()
            out.update(_state(rec, prefix))
            for k, v in rec.state.items():
                if isinstance(v, torch.Tensor):
                    out[f"{prefix}/state/{k}"] = v.numpy()
            if name == "2x1":
                info["zoo_trained_2x1"].append(rec.model.name)
    info["registered"] = sorted({build(n, default_config()).name for n in available()})
    _edge_steps(trainer, graphs["segment"], out, info)

    # per-rank checkpoints: a straight two-epoch run, a run resumed from its
    # epoch-0 files, and a (2, 1) run on its files
    straight_dir = os.path.join(out_dir, "ckpt_straight")
    resumed_dir = os.path.join(out_dir, "ckpt_resumed")
    ck = {**CONF, "max.epoch": 2, "eval.interval": 1, "checkpoint.keep": 3,
          "graph.backend": "segment"}
    straight = trainer(default_config(**ck, **{"checkpoint.dir": straight_dir}),
                       graphs["segment"], "1x2")
    straight.build()
    straight.train()
    mine = CheckpointManager(straight_dir, rank=rank)
    saved = mine.restore(1)
    info["ckpt_roundtrip"] = (
        all(torch.equal(saved["params"][k], v.detach()) for k, v in straight.params.items())
        and all(torch.equal(saved["optimizer"]["state"][i]["exp_avg"],
                            straight.optimizer.state[p]["exp_avg"])
                for i, p in enumerate(straight.params.values()))
        and saved["layout"] == {"data": 1, "model": 2, "rank": rank})
    os.makedirs(resumed_dir, exist_ok=True)
    shutil.copy(mine._path(0), resumed_dir)
    resumed = trainer(default_config(**ck, **{"checkpoint.dir": resumed_dir}),
                      graphs["segment"], "1x2")
    resumed.build()
    info["resumed_start_epoch"] = resumed.start_epoch
    resumed.train()
    info["resume_equal"] = _payload_equal(
        CheckpointManager(resumed_dir, rank=rank).restore(1), saved)
    try:
        trainer(default_config(**ck, **{"checkpoint.dir": straight_dir}), graphs["segment"],
                "2x1").build()
        info["layout_mismatch"] = None
    except ValueError as err:
        info["layout_mismatch"] = str(err)

    flags = torch.tensor([int(info["ckpt_roundtrip"]), int(info["resume_equal"])])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)  # every rank's checks
    info["ckpt_roundtrip"], info["resume_equal"] = bool(flags[0]), bool(flags[1])
    if rank == 0:
        np.savez(os.path.join(out_dir, "cases.npz"), **out)
        with open(os.path.join(out_dir, "info.json"), "w") as f:
            json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()


# -- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from recommendation_tpu_torch.parallel.distributed import spawn_world

    out = tmp_path_factory.mktemp("parallel_trainer")
    spawn_world([sys.executable, __file__, str(out)], 2, WORLD_TIMEOUT_S, str(out / "logs"),
                env={"PYTHONPATH": str(ROOT)})
    cases = np.load(out / "cases.npz")
    with open(out / "info.json") as f:
        return {k: cases[k] for k in cases.files}, json.load(f)


def _run(cases, backend, layout):
    prefix = f"{backend}/{layout}/"
    return {k[len(prefix):]: v for k, v in cases.items() if k.startswith(prefix)}


def test_workers_train_on_tiny_data(tiny_data):
    data = _tiny_data()
    assert (data.user_num, data.item_num) == (tiny_data.user_num, tiny_data.item_num)
    assert np.array_equal(data.edge_users, tiny_data.edge_users)
    assert np.array_equal(data.edge_items, tiny_data.edge_items)


@pytest.mark.parametrize("backend", BACKENDS + ("buir",))
def test_model_axis_is_the_single_run_bit_for_bit(world, backend):
    cases, _ = world
    single, sharded = _run(cases, backend, "single"), _run(cases, backend, "1x2")
    keys = [k for k in single if not k.startswith(("shard_rows/", "step/"))]
    assert {"user_emb", "item_emb", "loss", "exp_avg/user_emb", "exp_avg_sq/item_emb"} <= set(keys)
    if backend == "buir":  # the predictor replicated, the EMA targets in the state
        assert {"predictor.w", "state/t_user_emb", "state/t_item_emb"} <= set(keys)
    for k in keys:
        assert np.array_equal(single[k], sharded[k]), (backend, k)
    assert np.all(np.isfinite(single["loss"])) and len(single["loss"]) == CONF["max.epoch"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_data_axis_is_the_single_run_within_bound(world, backend):
    cases, _ = world
    single, sharded = _run(cases, backend, "single"), _run(cases, backend, "2x1")
    parts = {}
    for k in single:
        if k.startswith("shard_rows/"):
            continue
        np.testing.assert_allclose(sharded[k], single[k], **DATA_TOL, err_msg=f"{backend} {k}")
        part = k.split("/")[0] if "/" in k else "loss" if k == "loss" else "params"
        diff, scale = parts.get(part, (0.0, 0.0))
        parts[part] = (max(diff, float(np.abs(sharded[k] - single[k]).max())),
                       max(scale, float(np.abs(single[k]).max())))
    assert {"params", "exp_avg", "exp_avg_sq", "loss"} <= set(parts)
    for part, (diff, scale) in parts.items():
        assert scale > 0 and diff <= DATA_REL_TOL * scale, (backend, part, diff, scale)


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_rank_draws_the_single_runs_words(world, backend):
    """Every rank at (1, 2) and (2, 1) draws the epoch's words from its
    device generator, seeded alike: the first epoch's words, and the
    generator's state after the run, are the same on both ranks and the
    single trainer's."""
    info = world[1]
    single, after = info[f"words/{backend}/single"], info[f"draws_after/{backend}/single"]
    assert len(set(single)) == 1 and len(set(after)) == 1
    for layout in LAYOUTS:
        assert info[f"words/{backend}/{layout}"] == single, layout
        assert info[f"draws_after/{backend}/{layout}"] == after, layout


def test_tables_and_moments_are_shards(world):
    cases, info = world
    assert info["sharded_1x2"] == ["item_emb", "user_emb"]
    assert info["sharded_2x1"] == ["item_emb", "user_emb"]  # one shard: the whole table
    for layout, n_model in (("1x2", 2), ("2x1", 1)):
        rows = _run(cases, "segment", layout)
        assert list(rows["shard_rows/user_emb"]) == [60 // n_model] * 2
        assert list(rows["shard_rows/item_emb"]) == [100 // n_model] * 2
        assert rows["exp_avg/user_emb"].shape == (60, 16)  # gathered back whole


def test_odd_row_count_is_replicated_not_padded(world):
    _, info = world
    assert info["odd_rows"] == {"user_emb": [63, 16], "item_emb": [99, 16]}
    assert info["odd_sharded"] == []


def test_the_sharded_trainer_is_eager_and_refuses_fused_epochs(world):
    """Over gloo, whose collectives run on the host and cannot be captured,
    the sharded trainer keeps the eager loop, says so, and refuses
    ``train.fuse_epochs: true`` naming gloo."""
    info = world[1]
    assert info["sharded_graphed"] is False
    assert info["epoch_report"] == {"epochs": "eager", "backend": "gloo",
                                    "why": "gloo's collectives run on the host"}
    refused = info["fuse_true_refused"]
    assert refused is not None and "fuse_epochs" in refused and "gloo" in refused


def test_the_sharded_trainer_captures_under_nccl_on_a_card():
    """The capture decision: NCCL's groups on a card are captured, gloo's
    never (on a card or the CPU); a ``GraphedEpoch`` given a gloo placement
    on a card refuses it rather than run eagerly."""
    from types import SimpleNamespace

    from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender
    from recommendation_tpu_torch.train.graphed import GraphedEpoch

    def rec(device, backend):
        r = object.__new__(ShardedGraphRecommender)
        r.graph = SimpleNamespace(device=torch.device(device))
        r._placement = SimpleNamespace(backend=backend, capturable=backend == "nccl")
        return r

    assert rec("cuda", "nccl")._captures()
    assert rec("cuda", "nccl").epoch_report() == {
        "epochs": "captured", "backend": "nccl",
        "why": "nccl's collectives are captured in the epoch's CUDA graphs"}
    for device in ("cuda", "cpu"):
        assert not rec(device, "gloo")._captures()
        assert rec(device, "gloo").epoch_report()["epochs"] == "eager"
    card = SimpleNamespace(device=torch.device("cuda"), n_edges=10)
    with pytest.raises(ValueError, match="gloo"):
        GraphedEpoch(None, SimpleNamespace(param_groups=[]), card, {}, 4,
                     placement=SimpleNamespace(backend="gloo", capturable=False))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("chunk", GRAPHED_CHUNKS)
def test_graphed_epoch_with_a_placement_is_the_eager_epoch(world, layout, chunk):
    """``GraphedEpoch`` with the layout's placement (its bodies on the CPU)
    gives ``train_epoch``'s bits over two consecutive epochs: tables,
    moments, losses and the device generator's state; every rank ran the
    same graph keys in the same order (the lockstep a capture needs)."""
    cases, info = world
    name = f"graphed/{layout}/{chunk}"
    graphed, eager = _run(cases, name, "graphed"), _run(cases, name, "eager")
    assert set(graphed) == set(eager) and {"user_emb", "exp_avg/item_emb", "loss",
                                           "draws"} <= set(graphed)
    for k in graphed:
        assert np.array_equal(graphed[k], eager[k]), (name, k)
    assert len(graphed["loss"]) == 2 and not np.array_equal(*graphed["loss"])
    keys = info[f"{name}/graphed/keys"]
    assert keys[0] == keys[1]
    if chunk is None:
        assert keys[0] == [["epoch"]] and info[f"{name}/graphed/chunks"] is None
    else:
        assert info[f"{name}/graphed/chunks"] == [[0, 2], [2, 2]]
        assert keys[0] == [["sample"], ["chunk", 2]]


def test_sharded_evaluator_equals_single_evaluator(world):
    _, info = world
    assert info["metrics_sharded"] == info["metrics_single"]
    assert set(info["metrics_single"]) >= {"Recall@10", "NDCG@10"}


def test_no_registered_model_is_refused_at_data_two(world):
    _, info = world
    assert info["registered"] and set(info["registered"]) <= set(info["zoo_trained_2x1"])


def _part(k):
    return k.split("/")[0] if "/" in k else "loss" if k == "loss" else "params"


def _parts_within(single, sharded, rel_tol, what):
    """Each part (the key's first component) by its largest difference over
    its largest magnitude, within ``rel_tol``; and every entry within
    DATA_TOL, whose atol is for values of unit scale: a part of larger
    magnitude (a summed loss's gradients and moments) scales it by that
    magnitude, and a part held to a wider ``rel_tol`` than DATA_REL_TOL
    takes ``rel_tol`` of it."""
    parts = {}
    for k in single:
        if not k.startswith("shard_rows/"):
            diff, scale = parts.get(_part(k), (0.0, 0.0))
            parts[_part(k)] = (max(diff, float(np.abs(sharded[k] - single[k]).max())),
                               max(scale, float(np.abs(single[k]).max())))
    for k in single:
        if not k.startswith("shard_rows/"):
            scale = parts[_part(k)][1]
            atol = max(DATA_TOL["atol"] * max(1.0, scale),
                       rel_tol * scale if rel_tol > DATA_REL_TOL else 0.0)
            np.testing.assert_allclose(sharded[k], single[k], rtol=DATA_TOL["rtol"], atol=atol,
                                       err_msg=f"{what} {k}")
    for part, (diff, scale) in parts.items():
        assert scale > 0 and diff <= rel_tol * scale, (what, part, diff, scale)
    return parts


@pytest.mark.parametrize("case", ZOO)
def test_data_axis_step_is_the_single_step(world, case):
    """Each rank's loss is the single step's; the data group's sum of the
    ranks' gradients is the single gradient."""
    cases, _ = world
    single = _run(cases, f"zoo/{case}", "single")
    sharded = _run(cases, f"zoo/{case}", "2x1")
    want = float(single["first/loss"][0])
    np.testing.assert_allclose(sharded["first/loss"], [want, want], **DATA_TOL)
    grads = {k[len("first/"):]: v for k, v in single.items() if k.startswith("first/grad/")}
    assert grads
    _parts_within(grads, {k: sharded[f"first/{k}"] for k in grads}, DATA_REL_TOL,
                  f"{case} step")


@pytest.mark.parametrize("case", ZOO)
def test_data_axis_epoch_is_the_single_run(world, case):
    cases, _ = world
    single = _run(cases, f"zoo/{case}", "single")
    sharded = _run(cases, f"zoo/{case}", "2x1")
    epoch = {k: v for k, v in single.items() if not k.startswith("first/")}
    parts = _parts_within(epoch, sharded, EPOCH_REL_TOL.get(case, DATA_REL_TOL), f"{case} epoch")
    assert {"params", "exp_avg", "exp_avg_sq", "loss"} <= set(parts)
    assert len(single["loss"]) == 1 and np.isfinite(single["loss"]).all()


@pytest.mark.parametrize("case", ["ncl", "ncl_batch"])
def test_ncl_cluster_state_is_the_same_on_every_rank(world, case):
    _, info = world
    assert info[f"{case}_2x1_state_equal"] and info[f"{case}_single_state_equal"]


@pytest.mark.parametrize("case", JAX_CHECKED)
def test_data_axis_gradient_is_the_jax_gradient(world, tiny_data, tiny_graph, case):
    """The (2, 1) summed gradient against the JAX package's gradient of the
    same loss on the same parameters, state and global batch (converted
    through ``weights.py``)."""
    import jax
    import jax.numpy as jnp

    import recommendation_tpu.sampling as js
    from recommendation_tpu.config import default_config as jax_default_config
    from recommendation_tpu.models import get_model
    from recommendation_tpu_torch.weights import params_from_jax

    cases, _ = world
    run = _run(cases, f"zoo/{case}", "jax")
    params = {k[len("params/"):]: v for k, v in run.items() if k.startswith("params/")}
    state = {k[len("state/"):]: jnp.asarray(v) for k, v in run.items() if k.startswith("state/")}
    converted = params_from_jax(case, params, device="cpu")
    assert all(np.array_equal(converted[k].numpy(), v) for k, v in params.items())
    jbatch = js.PairwiseBatch(*(jnp.asarray(run[f"batch/{k}"])
                                for k in ("users", "pos_items", "neg_items", "weight")))
    jm = get_model(case, jax_default_config(**{**ZOO_CONF, **ZOO_EXTRA.get(case, {})}))
    want = jax.jit(jax.grad(lambda p: jm.loss(p, state, jbatch, tiny_graph,
                                              jax.random.PRNGKey(0))[0]))(
        {k: jnp.asarray(v) for k, v in params.items()})
    sharded = _run(cases, f"zoo/{case}", "2x1")
    for k, w in want.items():
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(sharded[f"first/grad/{k}"], w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=f"{case} {k}")


def test_edge_parallel_path_is_taken_where_it_should_be(world):
    """The segment (2, 1) run is edge-parallel, every other run replicated
    (the bucketed and dense backends, as the JAX package's rule has it);
    the ranks' row ranges cover the rows in order and every slot once."""
    _, info = world
    for backend in BACKENDS:
        for name in ("single", "1x2", "2x1"):
            want = ("edge-parallel" if (backend, name) == ("segment", "2x1")
                    else None if name == "single" else "replicated")
            assert info[f"propagation/{backend}/{name}"] == want, (backend, name)
    reports = info["edge_reports"]
    assert [r["part"] for r in reports] == [0, 1]
    ranges = reports[0]["ranges"]
    assert all(r["ranges"] == ranges and r["propagation"] == "edge-parallel" for r in reports)
    assert ranges[0][0] == 0 and ranges[0][1] == ranges[1][0] and ranges[1][1] == info[
        "edge_n_rows"]
    assert [r["rows"] for r in reports] == ranges
    assert [r["slots"] for r in reports] == reports[0]["slots_by_rank"]
    assert sum(r["slots"] for r in reports) == info["edge_e_pad"]
    assert sum(r["transpose_slots"] for r in reports) == info["edge_e_pad"]
    assert all(r["slots"] > 0 for r in reports)


def test_edge_parallel_forward_is_the_replicated_forward(world):
    """``eval_embeddings`` over the (2, 1) run's edge-sharded graph is the
    replicated graph's on the same tables, bit for bit (the plain P1 sums
    each row's slots in the same order in a rank's block), through
    L = 3 edge-parallel products."""
    cases, info = world
    assert info["edge_forward_calls"] == 3
    for name in ("user", "item"):
        sharded = cases[f"edge/forward/sharded/{name}"]
        assert np.array_equal(sharded, cases[f"edge/forward/replicated/{name}"]), name
        assert np.abs(sharded).max() > 0


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_parallel_step_is_the_single_step(world, case):
    """The models over ``norm_adj`` and its ``with_vals`` copies at (2, 1)
    on the segment graph: edge-parallel in the step, the summed gradient
    the single step's within DATA_REL_TOL, the loss within DATA_TOL."""
    cases, info = world
    assert info[f"edge/{case}/2x1/propagation"] == "edge-parallel"
    assert info[f"edge/{case}/2x1/calls"] > 0 and info[f"edge/{case}/single/calls"] == 0
    assert info[f"edge/{case}/single/collectives"] == 0
    single = _run(cases, f"edge/{case}", "single")
    sharded = _run(cases, f"edge/{case}", "2x1")
    np.testing.assert_allclose(sharded["loss"], single["loss"], **DATA_TOL)
    grads = {k: v for k, v in single.items() if k.startswith("grad/")}
    assert grads
    _parts_within(grads, {k: sharded[k] for k in grads}, DATA_REL_TOL, f"{case} edge step")


def test_shared_graph_keeps_the_replicated_path(world):
    """The sharded trainers keep their shard on their own copy of the
    graph: a single trainer built on the same graph object afterwards
    steps and evaluates without a collective."""
    _, info = world
    assert info["edge_shared_graph_unsharded"]
    assert info["edge_shared_graph_collectives"] == 0
    assert info["edge/lightgcn/2x1/collectives"] > 0  # the counter sees the sharded step's


@pytest.fixture(scope="module")
def jax_edge_grads(world, tiny_data):
    """EDGE_JAX_CHECKED's gradients from the JAX package on a segment
    graph placed by its own ``ShardedGraphRecommender`` over a (2, 1) CPU
    mesh (its COO sharded over ``data``), at the inputs of the port's
    (2, 1) step; with the placed adjacency's shardings."""
    import jax
    import jax.numpy as jnp

    import recommendation_tpu.sampling as js
    from recommendation_tpu.config import default_config as jax_default_config
    from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
    from recommendation_tpu.models import get_model
    from recommendation_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from recommendation_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from recommendation_tpu.parallel.trainer import ShardedGraphRecommender as JaxSharded
    from recommendation_tpu.utils.logging import Log as JaxLog

    cases, _ = world
    mesh = jax_make_mesh(JaxMeshSpec(data=2, model=1))
    out = {}
    for case in EDGE_JAX_CHECKED:
        config = jax_default_config(**EDGE_CONF)
        graph = JaxDeviceGraph(tiny_data, backend="segment")
        jm = get_model(case, config)
        JaxSharded(jm, tiny_data, config, graph=graph, mesh=mesh, log=JaxLog(echo=False)).build()
        run = _run(cases, f"edge/{case}", "jax")
        params = {k[len("params/"):]: jnp.asarray(v) for k, v in run.items()
                  if k.startswith("params/")}
        state = {k[len("state/"):]: jnp.asarray(v) for k, v in run.items()
                 if k.startswith("state/")}
        batch = js.PairwiseBatch(*(jnp.asarray(run[f"batch/{k}"])
                                   for k in ("users", "pos_items", "neg_items", "weight")))
        grad = jax.jit(jax.grad(lambda p, g: jm.loss(p, state, batch, g,
                                                     jax.random.PRNGKey(0))[0]))(params, graph)
        adj = graph.norm_adj
        out[case] = ({k: np.asarray(jax.block_until_ready(v)) for k, v in grad.items()},
                     {f: tuple(getattr(adj, f).sharding.spec) for f in ("rows", "cols", "vals")})
    return out


@pytest.mark.parametrize("case", EDGE_JAX_CHECKED)
def test_edge_parallel_gradient_is_the_jax_edge_sharded_gradient(world, jax_edge_grads, case):
    """The (2, 1) segment step's summed gradient against the JAX package's
    gradient of the same loss on the same inputs, its adjacency's COO
    sharded over ``data`` by its own trainer (``trainer.py:93-97``)."""
    cases, _ = world
    want, specs = jax_edge_grads[case]
    assert specs == {f: ("data",) for f in ("rows", "cols", "vals")}, specs
    sharded = _run(cases, f"edge/{case}", "2x1")
    for k, w in want.items():
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(sharded[f"grad/{k}"], w, rtol=DATA_TOL["rtol"],
                                   atol=DATA_TOL["atol"] * np.abs(w).max(),
                                   err_msg=f"{case} {k}")


def test_per_rank_checkpoint_round_trip_and_resume(world):
    _, info = world
    assert info["ckpt_roundtrip"]
    assert info["resumed_start_epoch"] == 1
    assert info["resume_equal"]


def test_restore_refuses_another_layout(world):
    _, info = world
    assert info["layout_mismatch"] is not None and "layout" in info["layout_mismatch"]


def test_mesh_service_padded_wave_is_the_unpadded_wave(world):
    """The mesh service pads a wave's users to a power of two with user 0
    and rounds its candidate count up to a multiple of 64 (the JAX
    service's rule, capped at the padded table's rows): its answers are the
    unpadded wave's, scores and ids bit for bit."""
    cases, info = world
    for w, b in enumerate(PAD_WAVES):
        for exclude in (True, False):
            key = f"serve_pad/{w}/{exclude}"
            for part in ("scores", "ids"):
                got, want = cases[f"{key}/padded/{part}"], cases[f"{key}/unpadded/{part}"]
                assert got.shape == (b, 10) and np.array_equal(got, want), (key, part)
            fetch = info[f"{key}/fetch"]
            assert fetch % 64 == 0 or fetch == 100, fetch  # 100 items: the padded table
    assert any(k.startswith("merged_ids/16/") for k in info["serve_pad_keys"])
    assert any(k.startswith("merged_ids/8/") for k in info["serve_pad_keys"])


def test_mesh_service_agrees_with_single_service(world):
    from recommendation_tpu_torch.ops.topk import topk_agree

    cases, _ = world
    n = 0
    for w in range(3):
        for exclude in (True, False):
            key = f"serve/{w}/{exclude}"
            a = cases[f"{key}/single/scores"], cases[f"{key}/single/ids"]
            b = cases[f"{key}/mesh/scores"], cases[f"{key}/mesh/ids"]
            assert a[1].shape == (16, 10) and np.all(b[1] < 100), key
            assert topk_agree(*a, *b, SERVE_TOL), key
            n += 1
    assert n == 6


def test_no_backend_or_device_fallback(monkeypatch):
    """The caller's backend and device hold: nccl on the CPU, nccl with
    fewer cards than local ranks and CUDA without a card raise; gloo puts
    local ranks on the cards in turn (several may share one)."""
    from recommendation_tpu_torch.parallel.distributed import initialize, rank_device

    with pytest.raises(ValueError, match="nccl"):
        rank_device("cpu", "nccl", 0, 1)
    with pytest.raises(ValueError, match="backend"):
        initialize("mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device("cuda", "gloo", 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a card for each local rank"):
        rank_device("cuda", "nccl", 0, 2)
    assert rank_device("cuda", "nccl", 0, 1) == torch.device("cuda", 0)
    assert rank_device("cuda", "gloo", 1, 2) == torch.device("cuda", 0)


def test_distributed_entry_point_runs_on_gloo(tmp_path):
    """The module's dryrun: two ranks against one process, train and serve."""
    r = subprocess.run([sys.executable, "-m", "recommendation_tpu_torch.parallel.distributed",
                        "--device", "cpu", "--backend", "gloo", "--timeout", "200"],
                       cwd=ROOT, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "dryrun_multihost ok" in r.stdout and "dryrun_serve_multihost ok" in r.stdout


if __name__ == "__main__":
    _worker(sys.argv[1])
