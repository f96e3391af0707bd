"""Embedding-probe evaluators (layer L7, contrastive-model branch), the
counterpart of ``recommendation_tpu/evalx/probe.py``.

The reference's GRACE/BGRL/G-BT scripts judge representations with sklearn
probes: logistic regression with micro/macro-F1 (`univariate/grace.py:327-378`
``LREvaluator``, train 10% / test 80% split) and an SVM probe
(`univariate/bgrl_g2l.py:348-373`). Here, as in the JAX package, they are
full-batch linear classifiers trained on the given device (default
``"cuda"``): AdamW with decoupled weight decay (``torch.optim.AdamW``, what
``optax.adamw`` computes), on softmax cross-entropy or the Crammer-Singer
multiclass hinge, from weights ``0.01 · N(0, 1)`` drawn from an explicit
``torch.Generator`` seeded with ``seed`` (``_normal``), biases zero. The
split and the F1 scores are numpy copies.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from recommendation_tpu_torch.device import resolve_device


def get_split(
    num_samples: int, train_ratio: float = 0.1, test_ratio: float = 0.8, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Random index split (`grace.py:381-404` semantics)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_samples)
    n_train = int(num_samples * train_ratio)
    n_test = int(num_samples * test_ratio)
    return {
        "train": perm[:n_train],
        "test": perm[n_train:n_train + n_test],
        "valid": perm[n_train + n_test:],
    }


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> Tuple[float, float]:
    """(micro_f1, macro_f1). Micro == accuracy for single-label problems."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    micro = float((y_true == y_pred).mean()) if len(y_true) else 0.0
    f1s = []
    for c in range(n_classes):
        tp = int(((y_pred == c) & (y_true == c)).sum())
        fp = int(((y_pred == c) & (y_true != c)).sum())
        fn = int(((y_pred != c) & (y_true == c)).sum())
        if tp == 0 and (fp or fn):
            f1s.append(0.0)
        elif tp:
            prec = tp / (tp + fp)
            rec = tp / (tp + fn)
            f1s.append(2 * prec * rec / (prec + rec))
    macro = float(np.mean(f1s)) if f1s else 0.0
    return micro, macro


def _normal(shape, seed: int) -> torch.Tensor:
    """N(0, 1) draws of the initial weights, from a generator seeded with
    ``seed`` (on the CPU, so a seed gives the same weights on any device)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _loss(logits: torch.Tensor, y: torch.Tensor, n_classes: int, loss_kind: str) -> torch.Tensor:
    if loss_kind == "hinge":
        # multiclass hinge (Crammer-Singer style), the SVM-probe analog
        onehot = F.one_hot(y, n_classes).to(logits.dtype)
        correct = torch.sum(logits * onehot, dim=1, keepdim=True)
        margins = torch.clamp(1.0 + logits - correct, min=0.0) * (1.0 - onehot)
        return torch.mean(torch.sum(margins, dim=1))
    return F.cross_entropy(logits, y)


def _train_linear(
    x: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    loss_kind: str,
    n_epochs: int,
    lr: float,
    weight_decay: float,
    seed: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    d = x.shape[1]
    w = (0.01 * _normal((d, n_classes), seed)).to(x.device).requires_grad_()
    b = torch.zeros(n_classes, device=x.device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, weight_decay=weight_decay)
    for _ in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        _loss(x @ w + b, y, n_classes, loss_kind).backward()
        opt.step()
    return w.detach(), b.detach()


def _evaluate(kind, z, y, split, n_epochs, lr, weight_decay, seed, device):
    dev = resolve_device(device)
    z = torch.as_tensor(np.asarray(z) if not isinstance(z, torch.Tensor) else z).to(dev).float()
    y = np.asarray(y)
    n_classes = int(y.max()) + 1
    train = torch.as_tensor(split["train"], dtype=torch.long, device=dev)
    w, b = _train_linear(
        z[train], torch.as_tensor(y[split["train"]], dtype=torch.long, device=dev), n_classes,
        kind, n_epochs, lr, weight_decay, seed,
    )
    pred = torch.argmax(z @ w + b, dim=1).cpu().numpy()
    micro, macro = f1_scores(y[split["test"]], pred[split["test"]], n_classes)
    return {"micro_f1": micro, "macro_f1": macro}


class LREvaluator:
    """Logistic-regression probe (`grace.py:327-378` contract)."""

    def __init__(self, num_epochs: int = 500, learning_rate: float = 0.01,
                 weight_decay: float = 0.0, device="cuda"):
        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.device = device

    def __call__(self, z, y, split, seed: int = 0) -> Dict[str, float]:
        return _evaluate("logreg", z, y, split, self.num_epochs, self.learning_rate,
                         self.weight_decay, seed, self.device)


class SVMEvaluator:
    """Linear hinge-loss probe (`bgrl_g2l.py:348-373` SVM analog)."""

    def __init__(self, num_epochs: int = 500, learning_rate: float = 0.01,
                 weight_decay: float = 1e-4, device="cuda"):
        self.num_epochs = num_epochs
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.device = device

    def __call__(self, z, y, split, seed: int = 0) -> Dict[str, float]:
        return _evaluate("hinge", z, y, split, self.num_epochs, self.learning_rate,
                         self.weight_decay, seed, self.device)
