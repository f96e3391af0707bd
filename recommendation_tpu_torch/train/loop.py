"""The training step loop (counterpart of ``recommendation_tpu/train/loop.py``).

One epoch: the epoch's words are drawn from the trainer's generator on the
graph's device (``sampling.epoch_words``), ``sampling.epoch_batches`` turns
them into [n_batches, B] arrays there, and the steps run over them:
loss → autograd (K1 forward, K2 backward on the card) → NaN guard →
optimizer step → ``post_step``. The mean of the finite step losses comes
back as a device scalar; nothing is read on the host inside the loop.

The NaN guard behaves as the JAX package's under optax: ``ok =
isfinite(loss)`` stays on the device, every gradient becomes
``where(ok, g, 0)``, and the optimizer still steps, so Adam's moments and
step count advance exactly as optax's do under zeroed gradients.

The JAX package jits each epoch (``make_epoch_fn``: one ``lax.scan`` over
its steps, sampling included), cuts long epochs into ``steps_per_call``
chunks and fuses ``eval.interval`` epochs into one execution
(``make_multi_epoch_fn``). The port's counterpart is a CUDA graph:
``train/graphed.py`` captures this loop's step (``train_step``) for a
whole epoch or a chunk of one and replays it, and the trainer runs its
epochs that way on the card (every registered model at every
configuration). ``run_steps`` stays the eager loop: the CPU's, the sharded trainer's and
the reference a captured epoch is held to bit for bit. On the card the
optimizers are made ``capturable`` (Adam's step count and bias correction
on the device), for the eager and the captured loop alike, and a rate that
moves is a device tensor: the bold driver's, Adam's or SGD's (torch's
fused SGD; ``set_learning_rate`` fills it), ESRF's two
(``tensor_rates``) and G-BT's cosine schedule (``CosineDecayAdam``
computes it on the device), so a replayed graph reads
the new rate. An epoch draws from one generator on the graph's device
(``train_epoch``'s ``generator``, the trainer's): its words first, then
the steps' masks, as the JAX epoch splits its key inside its jitted
program. The trainer draws in the same sequence whatever
``eval.interval`` is, so runs that evaluate at different intervals, fused
or not, train on the same batches and masks by construction.

A sharded trainer passes a ``placement`` (``parallel/trainer.py``): each
global batch is cut to the rank's rows (``placement.batch``), which at
data > 1 carry the data group and the global batch, the loss reads the
parameters the placement gathers from the rank's shards
(``placement.gather``), and the gradients are summed over the data group
before the NaN guard (``placement.reduce_grads``). ``step_grads`` is that
part of a step, without the update.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict

import torch

from recommendation_tpu_torch.models.base import Model
from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words


def make_optimizer(config, params: Dict[str, torch.Tensor]) -> torch.optim.Optimizer:
    """torch counterpart of the JAX package's optax choice over ``params``
    (in their dict order): ``adam`` is optax.adam (eps 1e-8, eps_root 0);
    ``adamw`` decays decoupled by lr × ``weight.decay``; ``sgd`` keeps
    optax.sgd's momentum trace (``momentum``, dampening 0), fused: one
    kernel a step, and a tensor rate read on its device (the bold
    driver's)."""
    lr = float(config.get("learning.rate", 1e-3))
    name = str(config.get("optimizer", "adam")).lower()
    tensors = list(params.values())
    # on the card Adam keeps its step count on the device, so that a CUDA
    # graph can capture its update (train/graphed.py); eager steps use the
    # same arithmetic, so both give the same bits
    cuda = tensors[0].is_cuda
    if name == "adam":
        return torch.optim.Adam(tensors, lr=lr, eps=1e-8, capturable=cuda)
    if name == "adamw":
        return torch.optim.AdamW(tensors, lr=lr, eps=1e-8, capturable=cuda,
                                 weight_decay=float(config.get("weight.decay", 0.01)))
    if name == "sgd":
        return torch.optim.SGD(tensors, lr=lr, momentum=float(config.get("momentum", 0.9)),
                               fused=True)
    raise ValueError(f"unknown optimizer {name!r}")


def adam_plain(param: torch.Tensor, grads, lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """``optax.adam(lr)``'s arithmetic in float32 over the gradients
    ``grads`` in turn (``scale_by_adam``: the moments, their bias
    corrections computed in f32 on the tensors' device, then ``-lr`` times
    the update): (the parameter, its first moment, its second). The
    reference that the card's ``capturable`` Adam is held to."""
    p = param.detach().float().clone()
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    for t, g in enumerate(grads, start=1):
        g = g.float()
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        mu_hat = mu / (one - (one * b1) ** t)
        nu_hat = nu / (one - (one * b2) ** t)
        p = p + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return p, mu, nu


# glibc's single-precision sine/cosine constants (``s_sincosf_data.c``):
# 2^24·2/π, π/2, the cosine's polynomial c0..c4 and the sine's s1..s3
_SINCOSF = {"hpi_inv": float.fromhex("0x1.45F306DC9C883p+23"),
            "hpi": float.fromhex("0x1.921FB54442D18p0")}
_COS_C = [float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SIN_S = [float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                     "-0x1.994eb3774cf24p-13")]


def _top12(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) >> 20) & 0x7FF


def _top12_of(value: float) -> int:
    return (struct.unpack("<i", struct.pack("<f", value))[0] >> 20) & 0x7FF


def cosf(y: torch.Tensor) -> torch.Tensor:
    """The f32 cosine that XLA's CPU backend computes (glibc's ``cosf``: a
    reduction by π/2 and a polynomial in f64, rounded to f32) for f32 ``y``
    in [0, π], the schedule's range, in f64 tensor ops one at a time, so
    every device gives its bits; torch's own f32 cosine differs from it in
    the last place."""
    x = y.to(torch.float64)
    c, s = _COS_C, _SIN_S

    def cos_poly(x2, sign):
        x4 = x2 * x2
        c2 = sign * c[3] + x2 * (sign * c[4])
        c1 = sign * c[0] + x2 * (sign * c[1])
        return c1 + x4 * (sign * c[2]) + (x4 * x2) * c2

    def sin_poly(x, x2):
        x3 = x * x2
        s1 = s[1] + x2 * s[2]
        return x + x3 * s[0] + (x3 * x2) * s1

    # the quadrant n = round(y·2/π) and the remainder r = y - n·π/2: the
    # cosine's polynomial for even n (negated in quadrant 2), the sine's at
    # ±r for odd n (at -r in quadrant 1)
    n = ((x * _SINCOSF["hpi_inv"]).to(torch.int32) + 0x800000) >> 24
    r = x - n.to(torch.float64) * _SINCOSF["hpi"]
    q = n & 3
    r = torch.where((q == 1) | (q == 2), -r, r)
    sign = torch.where(q >= 2, -1.0, 1.0).to(torch.float64)
    far = torch.where((n & 1) == 1, sin_poly(r, r * r), cos_poly(r * r, sign))
    near = cos_poly(x * x, 1.0)  # below π/4 (by the top 12 bits): no reduction
    small = _top12(y) < _top12_of(float.fromhex("0x1.921FB6p-1"))
    tiny = _top12(y) < _top12_of(2.0 ** -12)
    out = torch.where(small, near, far).to(torch.float32)
    return torch.where(tiny, torch.ones_like(out), out)


def cosine_decay(lr: float, count: torch.Tensor, decay_steps: int) -> torch.Tensor:
    """optax's ``cosine_decay_schedule(lr, decay_steps)`` (alpha 0, exponent
    1) at update ``count`` (an integer tensor), in f32 on its device, in
    optax's order and with its cosine (``cosf``): lr·(½(1 + cos(π·min(count,
    T)/T)))."""
    t = torch.clamp(count, max=decay_steps).to(torch.float32)
    # a tensor divisor (filled on the device: a capture copies nothing from
    # the host): CUDA divides by a host scalar through its reciprocal, a bit
    # off optax's (and the CPU's) true division
    return lr * (0.5 * (1.0 + cosf(math.pi * t / torch.full_like(t, decay_steps))))


class CosineDecayAdam(torch.optim.Adam):
    """``optax.adam(optax.cosine_decay_schedule(lr, decay_steps))``: Adam
    whose update ``t`` (counted from 0, the updates before it) takes the
    rate ``cosine_decay(lr, t, decay_steps)``. Every ``step`` counts, the
    NaN guard's zeroed ones too, as optax's count does. The count is an
    int32 tensor in each param group (``schedule_count``), so the
    optimizer's ``state_dict``, and with it a checkpoint, carries the
    schedule's position. On the card the count and the rate are device
    tensors that ``step`` updates in place (Adam ``capturable``): a captured
    step computes the schedule and reads nothing on the host. On the CPU
    the rate is the same f32 value, set as a float."""

    def __init__(self, params, lr: float, decay_steps: int):
        params = list(params)
        cuda = params[0].is_cuda
        super().__init__(params, lr=lr, eps=1e-8, capturable=cuda)
        for group in self.param_groups:
            group.update(base_lr=lr, decay_steps=int(decay_steps),
                         schedule_count=torch.zeros((), dtype=torch.int32,
                                                    device=params[0].device))
        if cuda:
            tensor_rates(self)

    def step(self, closure=None):
        for group in self.param_groups:
            rate = cosine_decay(group["base_lr"], group["schedule_count"], group["decay_steps"])
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].copy_(rate)
            else:
                group["lr"] = float(rate)
            group["schedule_count"].add_(1)
        return super().step(closure)


def tensor_rates(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Each group's rate as an f32 tensor on its parameters' device: a
    captured update reads it at its address (``set_learning_rate`` and
    ``load_optimizer_state`` fill it in place). Returns ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                   device=group["params"][0].device)
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The rate of every group: filled into a tensor rate in place (a
    captured graph reads it at its address), else set."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
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
    rate through ``param_groups`` between epochs. The rate is a tensor on
    the parameters' device, which a captured epoch reads as the bold driver
    moves it: SGD's on both devices (torch's fused SGD reads a tensor rate
    where it lies, and gives the float rate's bits), Adam's where it is
    ``capturable`` (on the card)."""
    name = "sgd" if str(config.get("optimizer", "adam")).lower() == "sgd" else "adam"
    opt = make_optimizer(config.with_overrides(optimizer=name), params)
    lr = float(config.get("learning.rate", 1e-3))
    if name == "sgd" or opt.defaults["capturable"]:
        tensor_rates(opt)
    return opt, BoldDriver(lr, float(config.get("max.learning.rate", 0.0)))


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)``, each tensor of a param group (a
    tensor rate, G-BT's schedule count) kept at its address and on its
    device, filled with the loaded value."""
    kept = [{k: v for k, v in group.items() if isinstance(v, torch.Tensor)}
            for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, tensors in zip(optimizer.param_groups, kept):
        for key, t in tensors.items():
            t.copy_(torch.as_tensor(group[key]))
            group[key] = t


def _where_state(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """Keep ``new`` where the step was finite, else ``old``, leaf by leaf."""
    if isinstance(new, dict):
        return {k: _where_state(ok, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return new


def _post_step_params(model, params, placement):
    """The parameters ``post_step`` reads: the updated full ones where a
    model has a ``post_step`` and the parameters are sharded."""
    if placement is None or type(model).post_step is Model.post_step:
        return params
    with torch.no_grad():
        return placement.gather(params)


def step_grads(model, graph, params: Dict[str, torch.Tensor], state: Any, batch,
               generator: torch.Generator | None = None, placement=None):
    """One step's (loss, gradients of the parameters that require one, in
    their dict order, new state), nothing updated. With a ``placement``,
    ``params`` are the rank's shards, ``batch`` the rank's rows
    (``placement.batch``) and the gradients the data group's sum."""
    tensors = [p for p in params.values() if p.requires_grad]
    full = params if placement is None else placement.gather(params)
    loss, new_state = model.loss(full, state, batch, graph, generator)
    grads = torch.autograd.grad(loss, tensors)
    if placement is not None:
        grads = placement.reduce_grads(grads)
    return loss, grads, new_state


def train_step(model, optimizer: torch.optim.Optimizer, graph, params: Dict[str, torch.Tensor],
               state: Any, batch, generator: torch.Generator | None = None, placement=None):
    """One step of the loop: the loss and its gradients, the NaN guard, the
    optimizer's update in place and ``post_step``. Returns (state, loss);
    nothing is read on the host, so a CUDA graph can capture it
    (``train/graphed.py``)."""
    if placement is not None:
        batch = placement.batch(batch)
    loss, grads, new_state = step_grads(model, graph, params, state, batch, generator, placement)
    ok = torch.isfinite(loss)
    with torch.no_grad():
        for p, g in zip([p for p in params.values() if p.requires_grad], grads):
            p.grad = torch.where(ok, g, torch.zeros_like(g))
    optimizer.step()
    state = model.post_step(_post_step_params(model, params, placement),
                            _where_state(ok, new_state, state), batch)
    return state, loss.detach()


def finite_mean(losses: torch.Tensor) -> torch.Tensor:
    """The mean of the finite entries of ``losses``, NaN when none is."""
    finite = torch.isfinite(losses)
    mean = torch.where(finite, losses, torch.zeros_like(losses)).sum() / torch.clamp(
        finite.sum(), min=1)
    return torch.where(finite.any(), mean, torch.full_like(mean, float("nan")))


def run_steps(model, optimizer: torch.optim.Optimizer, graph, params: Dict[str, torch.Tensor],
              state: Any, batches, generator: torch.Generator | None = None, placement=None):
    """The step loop over one epoch's arrays ``batches`` = (users, items,
    negs, weights, n_batches), the global batches. Differentiates the
    parameters that require a gradient (every one the loss reaches; a
    model's ``frozen`` ones do not) and updates them in place through
    ``optimizer``; returns (state, mean loss as a device scalar: the mean
    of the finite step losses, NaN when no step was finite). With a
    ``placement``, ``params`` are the rank's shards (see the module's
    docstring)."""
    users, items, negs, weights, n_batches = batches
    losses = torch.empty(n_batches, dtype=torch.float32, device=graph.device)
    for b in range(n_batches):
        state, losses[b] = train_step(model, optimizer, graph, params, state,
                                      PairwiseBatch(users[b], items[b], negs[b], weights[b]),
                                      generator, placement)
    return state, finite_mean(losses)


def train_epoch(model, optimizer, graph, params, state, generator: torch.Generator,
                batch_size: int, n_redraws: int = 4, placement=None):
    """One epoch: draw its words from ``generator`` (the trainer's, on the
    graph's device: no word crosses from the host), build its arrays, run
    the steps, whose losses draw their masks (and any extra negatives) from
    the same generator after the words. Returns (state, mean loss as a
    device scalar)."""
    batches = epoch_batches(epoch_words(generator, graph, batch_size, n_redraws), graph,
                            batch_size, n_redraws)
    return run_steps(model, optimizer, graph, params, state, batches, generator, placement)
