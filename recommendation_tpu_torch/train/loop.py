"""The training step loop (counterpart of ``recommendation_tpu/train/loop.py``).

One epoch: the epoch's words are drawn from the trainer's generator
(``sampling.epoch_words``), ``sampling.epoch_batches`` turns them into
[n_batches, B] arrays on the graph's device, and the steps run over them:
loss → autograd (K1 forward, K2 backward on the card) → NaN guard →
optimizer step → ``post_step``. The mean of the finite step losses comes
back as a device scalar; nothing is read on the host inside the loop.

The NaN guard behaves as the JAX package's under optax: ``ok =
isfinite(loss)`` stays on the device, every gradient becomes
``where(ok, g, 0)``, and the optimizer still steps, so Adam's moments and
step count advance exactly as optax's do under zeroed gradients.

The JAX package's ``make_multi_epoch_fn``, ``steps_per_call`` and the
hoisting gates work around TPU dispatch time and the TPU watchdog; the port
has one loop instead. The trainer draws each epoch's words from its
generator in the same sequence whatever ``eval.interval`` is, so runs that
evaluate at different intervals train on the same batches by construction.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words


def make_optimizer(config, params: Dict[str, torch.Tensor]) -> torch.optim.Optimizer:
    """torch counterpart of the JAX package's optax choice over ``params``
    (in their dict order): ``adam`` is optax.adam (eps 1e-8, eps_root 0);
    ``adamw`` decays decoupled by lr × ``weight.decay``; ``sgd`` keeps
    optax.sgd's momentum trace (``momentum``, dampening 0)."""
    lr = float(config.get("learning.rate", 1e-3))
    name = str(config.get("optimizer", "adam")).lower()
    tensors = list(params.values())
    if name == "adam":
        return torch.optim.Adam(tensors, lr=lr, eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(tensors, lr=lr, eps=1e-8,
                                 weight_decay=float(config.get("weight.decay", 0.01)))
    if name == "sgd":
        return torch.optim.SGD(tensors, lr=lr, momentum=float(config.get("momentum", 0.9)))
    raise ValueError(f"unknown optimizer {name!r}")


def cosine_decay(lr: float, count: int, decay_steps: int) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps)`` (alpha 0, exponent
    1) at update ``count``: lr·½(1 + cos(π·min(count, T)/T))."""
    t = min(count, decay_steps) / decay_steps
    return lr * 0.5 * (1.0 + math.cos(math.pi * t))


class CosineDecayAdam(torch.optim.Adam):
    """``optax.adam(optax.cosine_decay_schedule(lr, decay_steps))``: Adam
    whose update ``t`` (counted from 0, the updates before it) takes the
    rate ``cosine_decay(lr, t, decay_steps)``. Every ``step`` counts, the
    NaN guard's zeroed ones too, as optax's count does. The count lives in
    each param group (``schedule_count``), so the optimizer's
    ``state_dict``, and with it a checkpoint, carries the schedule's
    position."""

    def __init__(self, params, lr: float, decay_steps: int):
        super().__init__(params, lr=lr, eps=1e-8)
        for group in self.param_groups:
            group.update(base_lr=lr, decay_steps=int(decay_steps), schedule_count=0)

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = cosine_decay(group["base_lr"], group["schedule_count"],
                                       group["decay_steps"])
            group["schedule_count"] += 1
        return super().step(closure)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class BoldDriver:
    """The legacy stack's adaptive learning rate
    (`univariate/diffnet.py:756-763`): ×1.05 when |loss| improved over the
    previous epoch, ×0.5 otherwise, capped at ``max_lrate``."""

    def __init__(self, lrate: float, max_lrate: float = 0.0):
        self.lrate = lrate
        self.max_lrate = max_lrate
        self.last_loss: float | None = None

    def update(self, epoch: int, loss: float) -> float:
        if epoch > 1 and self.last_loss is not None:
            if abs(self.last_loss) > abs(loss):
                self.lrate *= 1.05
            else:
                self.lrate *= 0.5
        if self.max_lrate > 0 and self.lrate > self.max_lrate:
            self.lrate = self.max_lrate
        self.last_loss = loss
        return self.lrate


def make_bold_driver_optimizer(config, params):
    """SGD (``optimizer: sgd``) or Adam, with a ``BoldDriver`` that sets the
    rate through ``param_groups`` between epochs."""
    name = "sgd" if str(config.get("optimizer", "adam")).lower() == "sgd" else "adam"
    opt = make_optimizer(config.with_overrides(optimizer=name), params)
    lr = float(config.get("learning.rate", 1e-3))
    return opt, BoldDriver(lr, float(config.get("max.learning.rate", 0.0)))


def _where_state(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """Keep ``new`` where the step was finite, else ``old``, leaf by leaf."""
    if isinstance(new, dict):
        return {k: _where_state(ok, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return new


def run_steps(model, optimizer: torch.optim.Optimizer, graph, params: Dict[str, torch.Tensor],
              state: Any, batches, generator: torch.Generator | None = None):
    """The step loop over one epoch's arrays ``batches`` = (users, items,
    negs, weights, n_batches). Differentiates the parameters that require
    a gradient (every one the loss reaches; a model's ``frozen`` ones do
    not) and updates them in place through ``optimizer``; returns (state, mean loss as a device scalar: the mean
    of the finite step losses, NaN when no step was finite)."""
    users, items, negs, weights, n_batches = batches
    tensors = [p for p in params.values() if p.requires_grad]
    losses = torch.empty(n_batches, dtype=torch.float32, device=graph.device)
    for b in range(n_batches):
        batch = PairwiseBatch(users[b], items[b], negs[b], weights[b])
        loss, new_state = model.loss(params, state, batch, graph, generator)
        grads = torch.autograd.grad(loss, tensors)
        ok = torch.isfinite(loss)
        with torch.no_grad():
            for p, g in zip(tensors, grads):
                p.grad = torch.where(ok, g, torch.zeros_like(g))
        optimizer.step()
        state = model.post_step(params, _where_state(ok, new_state, state), batch)
        losses[b] = loss.detach()
    finite = torch.isfinite(losses)
    mean = torch.where(finite, losses, torch.zeros_like(losses)).sum() / torch.clamp(
        finite.sum(), min=1)
    return state, torch.where(finite.any(), mean, torch.full_like(mean, float("nan")))


def train_epoch(model, optimizer, graph, params, state, generator: torch.Generator,
                batch_size: int, n_redraws: int = 4):
    """One epoch: draw its words from ``generator``, build its arrays, run
    the steps (the loss draws any extra negatives from ``generator`` too).
    Returns (state, mean loss as a device scalar)."""
    batches = epoch_batches(epoch_words(generator, graph, batch_size, n_redraws), graph,
                            batch_size, n_redraws)
    return run_steps(model, optimizer, graph, params, state, batches, generator)
