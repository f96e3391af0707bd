"""Sharded trainer (counterpart of ``recommendation_tpu/parallel/trainer.py``).

``ShardedGraphRecommender`` runs ``GraphRecommender``'s lifecycle in every
rank of a ``(data, model)`` mesh (``parallel/mesh.py``):

  * **batches**: every rank draws the epoch's words on its device from the
    trainer's device generator, which every rank seeds alike, so the draw
    is identical everywhere; each data rank takes its
    ``B / data`` rows of each batch (B must divide by ``data``), and at
    data > 1 the batch also carries the data group and the global batch
    (``PairwiseBatch.group``, ``.whole``);
  * **tables**: ``user_emb``, ``item_emb`` and the other ``TABLE_KEYS`` are
    leaf tensors of ``rows / model`` rows where the rows divide by
    ``model`` (else whole on every rank, as JAX ``trainer.py:71-77``), and
    the Adam moments live on them. The forward all-gathers the shards over
    the model group into the full tables (``collectives.gather_rows``); its
    backward keeps the rank's own rows of the full table's gradient, which
    every model rank computed alike;
  * **propagation** over ``norm_adj`` is edge-parallel where the JAX
    package shards its COO over the data axis (``trainer.py:93-97``): the
    data axis larger than 1, ``norm_adj`` on the segment backend, and its
    padded edge count dividing by the world size. Each data rank then owns
    a contiguous row range of the row-sorted view, cut at row boundaries
    into about E_pad / data slots each (``ops.segment.row_cut``, the same
    cut on every rank and for every model rank of a data index), runs P1
    over those rows and all-gathers the rows over the data group
    (``ops/spmm.py``); the backward pulls the summed gradient of its rows
    through the transpose view's slots of those rows, the rank's share of
    ``Aᵀ g``. The shard rides every ``with_vals`` copy of ``norm_adj``
    (DirectAU's and BGRL's binarized one, BUIR's dropped edges); the other
    adjacencies (``transpose()``, ``normalized_bipartite``,
    ``norm_adj_selfloops``, GAT's and GraphSAGE's views) stay whole, as in
    the JAX package, which builds them from arrays it does not shard. The
    sharded ``norm_adj`` lives on the trainer's own shallow copy of the
    graph (``DeviceGraph.with_norm_adj``): a trainer or service built on
    the caller's graph stays replicated. ``edge_report()`` says which
    path the trainer took, and each rank's rows and slots.
    Elsewhere propagation runs whole on every rank over the replicated
    graph, with the port's kernels (K7 and P1 on the bucketed backend, K1
    and K2 on the dense one, S1 and S2 for GAT, K5 and K6 for NCL's
    contrast), as ``trainer.py:81-97`` does for the bucketed backend;
  * **losses**: at data > 1 every model's ``loss`` returns the global
    batch's value on every rank, and its backward is the rank's share of
    the global gradient (``ops/group.py``). A term over the batch's rows
    (a mean, a sum, an L2 norm) is the group's sum of the rank's rows; a
    term that reads no batch row (a loss over all nodes, an L2 over whole
    tables) is computed whole and its backward scaled by 1 / data; a term
    whose partners or denominators run over the whole batch (DirectAU's
    uniformity, SSL4Rec's in-batch softmax and InfoNCE, NCL's ProtoNCE,
    SEPT's pseudo-labels) takes the rank's rows as queries against the
    global batch's rows, which the rank reads from its own whole tables by
    the global batch's ids. The losses' masks come from the same device
    generator after the epoch's words, so they are replicated too; draws
    shaped by the batch are made at the global shape and sliced; state
    written at the batch's ids (SelfCF's histories, BUIR's EMA targets) is
    written at the global batch's;
  * **gradients**: each data rank's shares are summed over the data group
    (one all-reduce a step), replicated parameters' too.

At ``data = 1`` a step is the single-device step bit for bit: the same
tables, draws and kernels, the gradient only sliced. At ``data > 1`` it
differs by the order of the data group's sums; every registered model
takes the data axis. NCL's E-step clusters the same tables alike on every
rank (``ops/kmeans.py`` sums without atomics), so every rank holds the
same centroids and assignments. Edge-parallel propagation keeps each
row's sum order, so its forward is the replicated one bit for bit on the
card, and its backward differs by the data group's sum.

``test()`` is the sharded evaluator where the mesh has a model axis: the
padded item table row-sharded, ``sharded_topk`` over blocks of test users
(the tail block padded to a power of two), train positives masked after
the merge on the host, then ``ranking_metrics``; under NCCL each padded
block is a CUDA graph of the trainer's ``ScoreBlock`` (``ops/topk.py``),
the merge's all-gathers inside it. Checkpoints are one file a rank
(``train/checkpoint.py``) holding its shards, their Adam moments, both
generators' states and the layout; a restore refuses another layout.

The epochs run as the JAX package's sharded epoch does, one compiled
program with its collectives inside, where the mesh's collectives are
NCCL's on a card: ``GraphedEpoch`` with the placement captures each
epoch (its chunks, fused blocks) with the gathers and the all-reduce in
its graphs. Over gloo, whose collectives run on the host and cannot be
captured, the epochs stay eager (``train.loop.train_epoch``) and
``train.fuse_epochs: true`` is refused. ``epoch_report()`` says which
path the trainer took and why; nothing falls back from one to the other.

Every rank runs the same calls in the same order: evaluation is
replicated (every rank ranks the full tables), and the collectives are
synchronous. So ``test()``, ``predict()``, the epoch's evaluation and
``RecommenderService.from_recommender`` on a sharded trainer are
collective, every rank makes them: ``model_params()`` gathers the tables
over the model group, and an edge-sharded product gathers its rows over
the data group.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from recommendation_tpu_torch.config import Config
from recommendation_tpu_torch.evalx.metrics import ranking_metrics
from recommendation_tpu_torch.evalx.ranking import RankingResult
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.ops.topk import (
    ScoreBlock,
    mask_seen_post_merge,
    pow2_bucket,
    train_edge_keys,
)
from recommendation_tpu_torch.parallel.collectives import (
    captures,
    gather_rows,
    group_backend,
    sharded_topk,
)
from recommendation_tpu_torch.parallel.embedding import pad_rows_to
from recommendation_tpu_torch.graph.device import shard_rows
from recommendation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_size,
    batch_rows,
    make_mesh,
    mesh_spec,
    shard_params,
    table_rows,
)
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.train.recommender import GraphRecommender
from recommendation_tpu_torch.utils.logging import Log

class _Placement:
    """What the step loop does for a rank (``train/loop.py``): gather the
    sharded tables, sum the gradients over the data group, and cut each
    global batch to the rank's rows, naming the group its rows are a slice
    over and the global batch (``loss_group``: None where the data axis is
    1, so a loss runs its single-device code)."""

    def __init__(self, mesh, sharded: set, rows: tuple[int, int]):
        self.model_group = axis_group(mesh, MODEL_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.loss_group = self.data_group if axis_size(mesh, DATA_AXIS) > 1 else None
        self.sharded = sharded
        self.rows = rows
        self.backend = group_backend(self.model_group, self.data_group)
        # whether a captured step can hold the groups' collectives (NCCL's)
        self.capturable = captures(self.model_group, self.data_group)

    def gather(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: gather_rows(v, self.model_group) if k in self.sharded else v
                for k, v in params.items()}

    def reduce_grads(self, grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out

    def batch(self, whole: PairwiseBatch) -> PairwiseBatch:
        """This rank's rows of the global batch ``whole``; at data > 1 with
        the data group and ``whole`` (``ops.group.global_batch``)."""
        lo, hi = self.rows
        rows = (a[lo:hi] for a in whole[:4])
        if self.loss_group is None:
            return PairwiseBatch(*rows)
        return PairwiseBatch(*rows, self.loss_group, whole)


class ShardedGraphRecommender(GraphRecommender):
    """``GraphRecommender`` in one rank of ``mesh`` (default: ``make_mesh()``
    over the world, on the graph's device type)."""

    def __init__(
        self,
        model: Model,
        data,
        config: Optional[Config] = None,
        graph=None,
        mesh=None,
        log: Optional[Log] = None,
        device="cuda",
    ):
        super().__init__(model, data, config, graph=graph, log=log, device=device)
        self.mesh = mesh if mesh is not None else make_mesh(device_type=self.graph.device.type)
        self.spec = mesh_spec(self.mesh)
        self._n_model = self.spec.model
        self.replicated_graph = self.graph  # the caller's: never given the shard
        self._scorer = None  # the sharded evaluator's block (``_eval_block``)

    # -- placement ------------------------------------------------------------

    def build(self):
        rows = batch_rows(self.batch_size, self.mesh)  # raises where B does not divide
        self._rows = rows
        self.graph = self._place_graph(self.replicated_graph)
        report = self.edge_report()
        if report["propagation"] == "edge-parallel":
            self.log.add(f"edge-parallel propagation: data rank {report['part']} of "
                         f"{self.spec.data} pulls rows {report['rows']} "
                         f"({report['slots']} of {sum(report['slots_by_rank'])} slots)")
        super().build()

    def _place_graph(self, graph):
        """The graph this rank trains on: ``graph`` itself, or where the JAX
        package shards the main adjacency's COO over the data axis
        (``trainer.py:93-97``: data > 1, ``norm_adj`` on the segment backend,
        its padded edge count dividing by the world size) a shallow copy
        whose ``norm_adj`` carries this data rank's edge shard."""
        if self.spec.data <= 1 or graph.backend != "segment":
            return graph
        adj = graph.norm_adj
        if adj.backend != "segment" or adj.vals.shape[0] % (self.spec.data * self.spec.model):
            return graph
        group = axis_group(self.mesh, DATA_AXIS)
        return graph.with_norm_adj(shard_rows(adj, self.spec.data, dist.get_rank(group), group))

    def edge_report(self) -> Dict[str, Any]:
        """The propagation path ('edge-parallel' where ``norm_adj`` carries
        an edge shard, after ``build``; else 'replicated') and, where it is
        edge-parallel, this rank's part, its row range and slot count, and
        every rank's ranges and slots (from the host's row pointers: no
        collective)."""
        adj = getattr(self.graph, "_norm_adj", None)  # the dense backend uploads it at first use
        sh = None if adj is None else adj.shard
        if sh is None:
            return {"propagation": "replicated"}
        ptr = adj.seg.row_ptr.cpu()
        return {"propagation": "edge-parallel", "part": sh.part, "rows": list(sh.rows),
                "slots": sh.n_slots, "ranges": [list(r) for r in sh.ranges],
                "slots_by_rank": [int(ptr[hi] - ptr[lo]) for lo, hi in sh.ranges],
                "transpose_slots": sh.bwd.n_slots}

    def _place(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out, sharded = shard_params(params, self.mesh)
        self._placement = _Placement(self.mesh, sharded, self._rows)
        return out

    def _captures(self) -> bool:
        """The epochs are captured where the mesh's groups are NCCL's on a
        card; over gloo they stay eager."""
        return self.graph.device.type == "cuda" and self._placement.capturable

    def epoch_report(self) -> Dict[str, str]:
        """How the epochs run ('captured' or 'eager'), why, and the mesh's
        backend (after ``build``)."""
        backend, captured = self._placement.backend, self._captures()
        why = (f"{backend}'s collectives are captured in the epoch's CUDA graphs" if captured
               else f"{backend}'s collectives run on the host")
        return {"epochs": "captured" if captured else "eager", "why": why, "backend": backend}

    @property
    def sharded_params(self) -> set:
        """The names of the parameters held as row shards."""
        return self._placement.sharded

    def model_params(self) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self._placement.gather(self.params)

    # -- checkpoints: one file a rank, with the layout --------------------------

    def layout(self) -> Dict[str, int]:
        return {"data": self.spec.data, "model": self.spec.model, "rank": dist.get_rank()}

    def _checkpoint_manager(self, directory: str, keep: int):
        from recommendation_tpu_torch.train.checkpoint import CheckpointManager

        return CheckpointManager(directory, keep=keep, rank=dist.get_rank())

    def _payload(self, epoch: int) -> Dict[str, Any]:
        return {**super()._payload(epoch), "layout": self.layout(),
                "sharded": sorted(self.sharded_params)}

    def _latest_checkpoint(self) -> Optional[Dict[str, Any]]:
        """The newest step every rank holds, after checking that every rank
        holds one and that its layout is this run's."""
        local = self._ckpt.latest_step()
        local = -1 if local is None else local
        ends = torch.tensor([local, -local], dtype=torch.int64, device=self.graph.device)
        dist.all_reduce(ends, op=dist.ReduceOp.MAX)
        newest, oldest = int(ends[0]), -int(ends[1])
        if newest < 0:
            return None
        if oldest < 0:
            raise ValueError(f"checkpoint in {self._ckpt.directory} has no file for some ranks "
                             f"of the layout {self.layout()}: written by another layout")
        restored = self._ckpt.restore(oldest)
        if restored.get("layout") != self.layout():
            raise ValueError(f"checkpoint layout {restored.get('layout')} does not match this "
                             f"run's {self.layout()}")
        return restored

    # -- sharded evaluation ---------------------------------------------------

    def _eval_block(self, local: torch.Tensor) -> ScoreBlock:
        """The sharded evaluator's block over the rank's rows of the item
        table: CUDA graphs where the model group is NCCL's, eager over
        gloo; made at the first evaluation, its table copied in at each."""
        if self._scorer is None:
            self._scorer = ScoreBlock(local, graphs=self._placement.capturable)
        return self._scorer

    def test(self) -> RankingResult:
        """Ranking evaluation through the sharded top-k where the mesh has a
        model axis (else the single-device evaluator): the padded item
        table row-sharded over the model group, each block of test users
        scored against the rank's rows and merged (``sharded_topk``),
        over-fetched by the heaviest user's degree plus the padding rows,
        which score 0 and can displace real candidates; train positives and
        padding masked after the merge (``mask_seen_post_merge``)."""
        if self._n_model <= 1:
            return super().test()
        return self.sharded_test()

    def sharded_test(self) -> RankingResult:
        """``test()``'s sharded evaluator, on any mesh (at model = 1 the
        rank holds the whole padded table): a collective."""
        user_emb, item_emb = self.model.eval_embeddings(self.model_params(), self.state,
                                                        self.graph)
        test_uids = self.data.test_user_ids()
        max_n = max(self.topN)
        n_items = self.graph.n_items
        padded = pad_rows_to(item_emb.float().contiguous(), self._n_model)
        lo, hi = table_rows(padded.shape[0], self.mesh)
        local = padded[lo:hi]
        n_pad = padded.shape[0] - n_items
        k = min(int(self.graph.max_degree) + max_n + n_pad, padded.shape[0])
        keys = np.sort(train_edge_keys(self.data.interaction_mat, n_items))
        block = int(self.config.get("eval.batch.size", 1024))
        scorer = self._eval_block(local)
        ids_out, scores_out = [], []
        for start in range(0, len(test_uids), block):
            uids = test_uids[start:start + block]
            rows = torch.from_numpy(uids.astype(np.int64)).to(user_emb.device)
            s, i = scorer.merged_topk(user_emb[rows].float(), local, k,
                                      functools.partial(sharded_topk, mesh=self.mesh),
                                      pow2_bucket(len(uids), block))
            ids = i.cpu().numpy()
            s = mask_seen_post_merge(s.cpu().numpy(), ids, uids, keys, n_items)
            order = np.argsort(-s, axis=1, kind="stable")[:, :max_n]
            ids_out.append(np.take_along_axis(ids, order, axis=1).astype(np.int32))
            scores_out.append(np.take_along_axis(s, order, axis=1))
        top_ids = np.concatenate(ids_out) if ids_out else np.zeros((0, max_n), np.int32)
        top_scores = np.concatenate(scores_out) if scores_out else np.zeros((0, max_n), np.float32)
        metrics = ranking_metrics(top_ids, self.data.test_items_by_user(), self.topN)
        return RankingResult(metrics=metrics, top_ids=top_ids, top_scores=top_scores,
                             test_user_ids=test_uids)
