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
    ``checkpoint.resume``) that hold the generator too, so a resumed run
    trains on the batches a straight run would.

It runs one epoch per loop turn: no fused or chunked epochs (TPU dispatch
and watchdog workarounds in the JAX package). Each epoch draws a seed for
``epoch_begin`` from the trainer's generator, then its batches, in that
order whatever ``eval.interval`` is.
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
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.train.loop import (
    make_bold_driver_optimizer,
    make_optimizer,
    set_learning_rate,
    train_epoch,
)
from recommendation_tpu_torch.utils.logging import Log


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class GraphRecommender:
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
                       for k, v in params.items()}
        self._bold = None
        if self.config.get("adaptive.lr", False):
            # legacy bold-driver schedule (`univariate/diffnet.py:756-763`)
            self.optimizer, self._bold = make_bold_driver_optimizer(self.config, self.params)
        else:
            self.optimizer = (self.model.make_optimizer(self.config, self.params)
                              or make_optimizer(self.config, self.params))
        self._gen = torch.Generator().manual_seed(seed + 1)
        self.start_epoch = 0
        self._ckpt = None
        ckpt_dir = self.config.get("checkpoint.dir")
        if ckpt_dir:
            from recommendation_tpu_torch.train.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(ckpt_dir, keep=int(self.config.get("checkpoint.keep", 3)))
            if self.config.get("checkpoint.resume", True):
                restored = self._ckpt.restore_latest()
                if restored is not None:
                    self._restore(restored)
                    self.log.add(f"resumed from checkpoint at epoch {restored['epoch']}")

    def _payload(self, epoch: int) -> Dict[str, Any]:
        return {
            "params": {k: v.detach() for k, v in self.params.items()},
            "optimizer": self.optimizer.state_dict(),
            "state": self.state,
            "generator": self._gen.get_state(),
            "epoch": epoch,
        }

    def _restore(self, restored: Dict[str, Any]) -> None:
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(restored["params"][k])
        self.optimizer.load_state_dict(restored["optimizer"])  # moves state to the params' device
        self.state = _map_tensors(lambda t: t.to(self.graph.device), restored["state"])
        self._gen.set_state(restored["generator"])
        self.start_epoch = int(restored["epoch"]) + 1

    def train(self):
        bad_epochs = 0
        last_loss = None
        conv_eps = self.config.get("convergence.eps", None)
        examples = -(-self.graph.n_edges // self.batch_size) * self.batch_size
        epoch = self.start_epoch
        while epoch < self.max_epoch:
            t0 = time.perf_counter()
            begin_seed = int(torch.randint(0, 2**62, (1,), generator=self._gen))
            self.state = self.model.epoch_begin(
                self.params, self.state, self.graph, torch.Generator().manual_seed(begin_seed), epoch
            )
            self.state, loss_t = train_epoch(self.model, self.optimizer, self.graph, self.params,
                                             self.state, self._gen, self.batch_size)
            loss = float(loss_t)  # the epoch's one host read
            dt = time.perf_counter() - t0
            if math.isnan(loss):
                self.log.add(f"epoch {epoch}: loss is NaN — aborting (diffnet.py:782-786 guard)")
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
        user_emb, item_emb = self.model.eval_embeddings(self.params, self.state, self.graph)
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
        user_emb, item_emb = self.model.eval_embeddings(self.params, self.state, self.graph)
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
        user_emb, item_emb = self.model.eval_embeddings(self.params, self.state, self.graph)
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
