"""Recommender lifecycle (counterpart of ``recommendation_tpu/train/recommender.py``).

``GraphRecommender`` keeps the reference's ``build / train / test /
evaluate / predict / execute / fast_evaluation`` contract
(`selfcf.py:331-453`, `ncl.py:234-277`) over the port's step loop
(``train/loop.py``), with the JAX package's quality controls:
  * per-epoch ``fast_evaluation`` with best-model tracking by Recall@maxN
    or a metric majority vote (``model.selection``), an in-memory best
    snapshot, restored when training ends;
  * early stopping after ``early.stopping.patience`` evaluations without
    improvement, and a stop once |Δloss| < ``convergence.eps``;
  * an abort when an epoch's mean loss is NaN (the per-step guard already
    kept non-finite updates out of the tables);
  * the bold-driver learning rate (``adaptive.lr``);
  * disk checkpoints (``checkpoint.dir``, ``checkpoint.keep``,
    ``checkpoint.resume``) that hold both generators' states too, so a
    resumed run trains on the batches and masks a straight run would.

Its epochs run as the JAX package's do, each one device execution:
``train/graphed.py`` captures the epoch's steps as CUDA graphs on the card
and replays them (on the CPU the same object runs them eagerly), for every
registered model at every configuration the port accepts, the bold
driver's moving rate included (a device tensor). Evaluation (``fast_evaluation``, ``test``) replays the
score block's graphs (``evalx/ranking.py``). The five ``train.*`` keys
of the JAX trainer mean what they mean there: ``train.steps_per_call`` and
``train.max_steps_per_call`` chunk a long epoch (``graphed.steps_per_call``),
and ``train.fuse_epochs``, ``train.fuse_below_steps`` and
``train.max_fused_steps`` gate fused blocks (``_can_fuse_epochs``): the
``eval.interval`` epochs up to the next evaluation replayed back to back,
their losses read once, a NaN aborting at the block's end. A sharded
trainer captures its epochs, chunks and fused blocks too where its mesh's
collectives are NCCL's on a card (the graphs hold them); over gloo, whose
collectives run on the host, it trains with the eager loop
(``train.loop.train_epoch``) and refuses ``train.fuse_epochs: true``.
The trainer holds two generators. The host one (``_gen``)
seeds the second once and gives each epoch a seed for ``epoch_begin``
(the fused block draws it too, for the no-op). The second
(``_draws``, on the graph's device, ``graph.augment.device_generator``)
draws each epoch's words and then the losses' masks on the device, as
the JAX epoch splits its key inside its jitted program: the captured
epochs register it and draw inside their graphs, so every replay draws
what the eager epoch would, and no word is copied in from the host. Both
draw in the same sequence whatever ``eval.interval`` is and whether an
epoch is fused or not, so the paths give the same bits.

A sharded trainer (``parallel/trainer.py``) keeps this lifecycle and
overrides its placement hooks: ``_place`` (the parameters this process
holds), ``model_params`` (the dict the model reads), ``_placement`` (what
the step loop gathers, reduces and slices) and the checkpoint hooks.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from recommendation_tpu_torch.config import Config, apply_legacy_options, default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.ranking import RankingResult, evaluate_ranking
from recommendation_tpu_torch.graph.augment import device_generator
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.train.graphed import GraphedEpoch, steps_per_call
from recommendation_tpu_torch.train.loop import (
    load_optimizer_state,
    make_bold_driver_optimizer,
    make_optimizer,
    set_learning_rate,
    train_epoch,
)
from recommendation_tpu_torch.utils.logging import Log


def _fuse_mode(config):
    """``train.fuse_epochs``: False, True or "auto" (the default)."""
    mode = config.get("train.fuse_epochs", "auto")
    if isinstance(mode, str) and mode.lower() in ("true", "false"):
        return mode.lower() == "true"
    return mode


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class GraphRecommender:
    _placement = None  # the step loop's gather, reduce and slice (``train.loop``)

    def __init__(
        self,
        model: Model,
        data: Interaction,
        config: Optional[Config] = None,
        graph: Optional[DeviceGraph] = None,
        log: Optional[Log] = None,
        device="cuda",
    ):
        self.model = model
        self.data = data
        self.config = apply_legacy_options(config if config is not None else default_config())
        self.graph = graph if graph is not None else DeviceGraph(
            data,
            backend=self.config.get("graph.backend", "auto"),
            compute_dtype=self.config.get("graph.compute_dtype", "float32"),
            device=device,
        )
        self.log = log or Log(name=model.name)
        self.topN = list(self.config.get("item.ranking.topN", [10, 20, 30, 50]))
        self.max_N = max(self.topN)
        self.batch_size = int(self.config.get("batch.size", 2048))
        self.max_epoch = int(self.config.get("max.epoch", 30))
        self.eval_interval = int(self.config.get("eval.interval", 1))
        self.patience = self.config.get("early.stopping.patience", None)
        self.selection = str(self.config.get("model.selection", "recall"))

        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.state = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.best_params = None
        self.best_state = None
        self.best_metrics: Dict[str, float] = {}
        self.best_epoch = -1
        self.history: list[dict] = []  # one entry per evaluation
        self.epoch_stats: list[dict] = []  # epoch, loss, seconds, examples/s

    # -- lifecycle ------------------------------------------------------------

    def print_model_info(self):
        u, i, e = self.data.training_size()
        backend = self.graph.backend
        if backend == "pallas":  # no kernel of its own: the segment path runs
            backend = "pallas(->segment fallback)"
        self.log.add(
            f"model={self.model.name} users={u} items={i} interactions={e} "
            f"backend={backend} emb={self.model.emb_size} device={self.graph.device}"
        )

    def build(self):
        seed = int(self.config.get("seed", 0))
        params, self.state = self.model.init(torch.Generator().manual_seed(seed), self.graph)
        self.params = {k: v.detach().requires_grad_(k not in self.model.frozen)
                       for k, v in self._place(params).items()}
        self._bold = None
        if self.config.get("adaptive.lr", False):
            # legacy bold-driver schedule (`univariate/diffnet.py:756-763`)
            self.optimizer, self._bold = make_bold_driver_optimizer(self.config, self.params)
        else:
            self.optimizer = (self.model.make_optimizer(self.config, self.params)
                              or make_optimizer(self.config, self.params))
        self._gen = torch.Generator().manual_seed(seed + 1)
        # the epochs' words and the losses' masks: on the graph's device,
        # seeded alike on every rank of a sharded trainer (its batches and
        # masks stay replicated)
        self._draws = device_generator(self._gen, self.graph.device)
        self.start_epoch = 0
        self._graphed = None
        self._ckpt = None
        ckpt_dir = self.config.get("checkpoint.dir")
        if ckpt_dir:
            self._ckpt = self._checkpoint_manager(ckpt_dir,
                                                  int(self.config.get("checkpoint.keep", 3)))
            if self.config.get("checkpoint.resume", True):
                restored = self._latest_checkpoint()
                if restored is not None:
                    self._restore(restored)
                    self.log.add(f"resumed from checkpoint at epoch {restored['epoch']}")
        self.steps_per_call = steps_per_call(self.graph.n_edges, self.batch_size, self.config)
        if self._captures():
            self._graphed = GraphedEpoch(self.model, self.optimizer, self.graph, self.params,
                                         self.batch_size, steps_per_call=self.steps_per_call,
                                         placement=self._placement)
        elif _fuse_mode(self.config) is True:
            raise ValueError(f"train.fuse_epochs: true needs epochs that run as CUDA graphs; "
                             f"{self.model.name} on this trainer runs its epochs eagerly: "
                             f"{self.epoch_report()['why']}")

    def _captures(self) -> bool:
        """Whether the epochs run as ``GraphedEpoch``: every model on the
        single-device trainer (a sharded one decides by its collectives)."""
        return True

    def epoch_report(self) -> Dict[str, str]:
        """How the epochs run: 'captured' (``GraphedEpoch``: CUDA graphs on
        a card, the same bodies eagerly on the CPU) or 'eager'
        (``train.loop.train_epoch``), and why."""
        return {"epochs": "captured", "why": f"GraphedEpoch on {self.graph.device.type}"}

    # -- placement hooks (a sharded trainer overrides them) -------------------

    def _place(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The parameters this trainer holds, from the model's full ones."""
        return params

    def model_params(self) -> Dict[str, torch.Tensor]:
        """The parameter dict the model reads (evaluation, epoch hooks)."""
        return self.params

    def _checkpoint_manager(self, directory: str, keep: int):
        from recommendation_tpu_torch.train.checkpoint import CheckpointManager

        return CheckpointManager(directory, keep=keep)

    def _latest_checkpoint(self) -> Optional[Dict[str, Any]]:
        return self._ckpt.restore_latest()

    def _payload(self, epoch: int) -> Dict[str, Any]:
        return {
            "params": {k: v.detach() for k, v in self.params.items()},
            "optimizer": self.optimizer.state_dict(),
            "state": self.state,
            "generator": self._gen.get_state(),
            "draws": self._draws.get_state(),
            "epoch": epoch,
        }

    def _restore(self, restored: Dict[str, Any]) -> None:
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(restored["params"][k])
        # moves the state to the params' device, in new tensors: a captured
        # epoch reads the old ones, so its graphs are captured again
        load_optimizer_state(self.optimizer, restored["optimizer"])
        if self._graphed is not None:
            self._graphed.reset()
        self.state = _map_tensors(lambda t: t.to(self.graph.device), restored["state"])
        self._gen.set_state(restored["generator"])
        self._draws.set_state(restored["draws"])
        self.start_epoch = int(restored["epoch"]) + 1

    def _can_fuse_epochs(self) -> bool:
        """The JAX trainer's gate (``recommendation_tpu/train/recommender.py``):
        a block of ``eval.interval`` epochs runs as one device execution when
        no per-epoch host work is active (``epoch_begin`` the base no-op, no
        bold driver, no convergence check, which must read each epoch's loss
        before the next runs), one epoch has at most
        ``train.fuse_below_steps`` batches and the block at most
        ``train.max_fused_steps`` steps weighted by its millions of edges.
        The trainer fuses only epochs that run as CUDA graphs."""
        if _fuse_mode(self.config) is False:
            return False
        n_batches = -(-self.graph.n_edges // self.batch_size)
        fuse_below = int(self.config.get("train.fuse_below_steps", 64))
        max_steps = int(self.config.get("train.max_fused_steps", 1024))
        cost_weight = max(1, -(-self.graph.n_edges // 1_000_000))
        return (
            self.eval_interval > 1
            and type(self.model).epoch_begin is Model.epoch_begin
            and self._bold is None
            and self.config.get("convergence.eps", None) is None
            and n_batches <= fuse_below
            and n_batches * self.eval_interval * cost_weight <= max_steps
        )

    def _epoch(self):
        """One epoch's (state, mean loss as a device scalar)."""
        if self._graphed is not None:
            return self._graphed.run(self.state, self._draws)
        return train_epoch(self.model, self.optimizer, self.graph, self.params, self.state,
                           self._draws, self.batch_size, placement=self._placement)

    def _begin_seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self._gen))

    def train(self):
        bad_epochs = 0
        last_loss = None
        conv_eps = self.config.get("convergence.eps", None)
        fuse = self._graphed is not None and self._can_fuse_epochs()
        examples = -(-self.graph.n_edges // self.batch_size) * self.batch_size
        epoch = self.start_epoch
        aborted = False
        while epoch < self.max_epoch and not aborted:
            # the epochs up to and including the next evaluation
            iv = self.eval_interval
            next_eval = min((epoch // iv) * iv + iv - 1, self.max_epoch - 1)
            block = next_eval - epoch + 1
            if fuse and block > 1:
                t0 = time.perf_counter()
                losses = []
                for _ in range(block):
                    self._begin_seed()  # the unfused loop's draw; epoch_begin is the no-op
                    self.state, loss_t = self._epoch()
                    losses.append(loss_t)
                losses = torch.stack(losses).tolist()  # the block's one host read
                dt = (time.perf_counter() - t0) / block
                for k, loss in enumerate(losses):
                    if math.isnan(loss):
                        # a block-granular abort: the per-step guard already
                        # kept non-finite updates out of the tables
                        self.log.add(f"epoch {epoch + k}: loss is NaN — aborting "
                                     f"(diffnet.py:782-786 guard)")
                        aborted = True
                        break
                    self.epoch_stats.append({"epoch": epoch + k, "loss": loss, "seconds": dt,
                                             "examples_per_s": examples / dt})
                    self.log.add(f"epoch {epoch + k}: loss={loss:.5f} ({dt:.2f}s, "
                                 f"{examples / dt:,.0f} examples/s, fused x{block})")
                if aborted:
                    break
                last_loss = losses[-1]
                epoch = next_eval
            else:
                t0 = time.perf_counter()
                self.state = self.model.epoch_begin(
                    self.model_params(), self.state, self.graph,
                    torch.Generator().manual_seed(self._begin_seed()), epoch
                )
                self.state, loss_t = self._epoch()
                loss = float(loss_t)  # the epoch's one host read
                dt = time.perf_counter() - t0
                if math.isnan(loss):
                    self.log.add(f"epoch {epoch}: loss is NaN — aborting "
                                 f"(diffnet.py:782-786 guard)")
                    break
                self.epoch_stats.append({"epoch": epoch, "loss": loss, "seconds": dt,
                                         "examples_per_s": examples / dt})
                self.log.add(f"epoch {epoch}: loss={loss:.5f} ({dt:.2f}s, "
                             f"{examples / dt:,.0f} examples/s)")
                # convergence check (`univariate/diffnet.py:782-802`)
                if last_loss is not None and conv_eps is not None:
                    if abs(last_loss - loss) < float(conv_eps):
                        self.log.add(f"converged at epoch {epoch} (|Δloss| < {conv_eps})")
                        self.fast_evaluation(epoch)
                        break
                if self._bold is not None:
                    new_lr = self._bold.update(epoch, loss)
                    set_learning_rate(self.optimizer, new_lr)
                    self.log.add(f"  bold-driver lr -> {new_lr:.6f}")
                last_loss = loss
            if (epoch + 1) % self.eval_interval == 0 or epoch == self.max_epoch - 1:
                improved = self.fast_evaluation(epoch)
                bad_epochs = 0 if improved else bad_epochs + 1
                if self._ckpt is not None:
                    self._ckpt.save(epoch, self._payload(epoch))
                if self.patience is not None and bad_epochs > int(self.patience):
                    self.log.add(f"early stop at epoch {epoch} (patience {self.patience})")
                    break
            epoch += 1
        if self.best_params is not None:
            with torch.no_grad():
                for k, v in self.params.items():
                    v.copy_(self.best_params[k])
            self.state = self.best_state

    def test(self) -> RankingResult:
        user_emb, item_emb = self.model.eval_embeddings(self.model_params(), self.state,
                                                        self.graph)
        return evaluate_ranking(
            user_emb, item_emb, self.data, self.graph, Ns=self.topN,
            batch_size=int(self.config.get("eval.batch.size", 1024)),
        )

    def evaluate(self) -> Dict[str, float]:
        result = self.test()
        for line in result.report(self.data, self.topN):
            self.log.add(line.rstrip("\n"))
        return result.metrics

    def predict(self, user) -> np.ndarray:
        """Scores over all items for an external user id (`selfcf.py:581`)."""
        uid = self.data.get_user_id(user)
        user_emb, item_emb = self.model.eval_embeddings(self.model_params(), self.state,
                                                        self.graph)
        return (user_emb[uid] @ item_emb.T).cpu().numpy()

    def execute(self) -> Dict[str, float]:
        """print info → build → train → test → evaluate (`selfcf.py:378-387`)."""
        self.print_model_info()
        self.build()
        self.train()
        return self.evaluate()

    # -- model selection ------------------------------------------------------

    def _is_better(self, metrics: Dict[str, float]) -> bool:
        if not self.best_metrics:
            return True
        if self.selection == "majority":
            # count improved metrics at max-N (`selfcf.py:437-444`)
            keys = [f"{m}@{self.max_N}" for m in ("HitRatio", "Precision", "Recall", "NDCG")]
            better = sum(metrics[k] > self.best_metrics[k] for k in keys)
            return better > len(keys) / 2
        return metrics[f"Recall@{self.max_N}"] > self.best_metrics.get(
            f"Recall@{self.max_N}", -1.0
        )

    def fast_evaluation(self, epoch: int) -> bool:
        user_emb, item_emb = self.model.eval_embeddings(self.model_params(), self.state,
                                                        self.graph)
        result = evaluate_ranking(
            user_emb, item_emb, self.data, self.graph, Ns=[self.max_N],
            batch_size=int(self.config.get("eval.batch.size", 1024)),
        )
        metrics = result.metrics
        self.history.append({"epoch": epoch, **metrics})
        improved = self._is_better(metrics)
        if improved:
            self.best_metrics = dict(metrics)
            self.best_epoch = epoch
            self.best_params = {k: v.detach().clone() for k, v in self.params.items()}
            self.best_state = _map_tensors(torch.clone, self.state)
        self.log.add(
            f"  eval@{epoch}: "
            + " ".join(f"{k}={v:.5f}" for k, v in metrics.items())
            + (" *best*" if improved else "")
        )
        return improved
