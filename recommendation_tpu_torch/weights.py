"""Model parameters: import from the JAX package, and the port's checkpoint.

Parameters and model state are nested trees in the JAX package: dicts of
arrays, lists of dicts (GRACE's ``convs``), dicts of dicts (BGRL's
``online`` and ``target``) and 0-d arrays (BGRL's ``prelu``). The port
keeps each as ONE flat ``Dict[str, Tensor]`` whose keys are the dotted
paths of the tree's leaves, dict keys and list indices alike:
``convs.0.w``, ``online.convs.1.mlp2.b``, ``layers.0.neigh.w`` (the port's models build their
trees in the order the JAX model's init writes them; loaded parameters
come in ``PARAM_NAMES``' order). ``flatten_tree`` makes those names and
``subtree`` reads a branch back out of them, so the optimizer, the
``.npz`` checkpoint and ``opt_state_from_jax`` see one flat dict, and the
models unflatten what they need.

``PARAM_NAMES`` and ``STATE_DTYPES`` give each ported model's layout as
name patterns, where ``*`` stands for a list index (the layer count is a
setting): every name must match a pattern and every pattern a name.

``params_from_jax`` takes a JAX parameter pytree given as numpy arrays
(``jax.device_get(params)``) and returns the port's tensors, name for name.
``save_params``/``load_params`` keep the same names in one ``.npz`` file:
the port's checkpoint for ``serve`` (the JAX package's orbax checkpoints
cannot be read without JAX). ``opt_state_from_jax`` carries an optax Adam
state over into a ``torch.optim.Adam`` ``state_dict``, and ``state_from_jax``
a model's non-gradient state (NCL's clusters, SelfCF's histories, BUIR's
and BGRL's targets), integer tables as int32.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from recommendation_tpu_torch.device import resolve_device


def _linear(prefix):
    return (f"{prefix}.w", f"{prefix}.b")


def _gin_encoder(prefix):
    return (f"{prefix}.convs.*.mlp1.w", f"{prefix}.convs.*.mlp1.b",
            f"{prefix}.convs.*.mlp2.w", f"{prefix}.convs.*.mlp2.b",
            *_linear(f"{prefix}.proj"), f"{prefix}.prelu")


_TABLES = ("user_emb", "item_emb")
# parameter names of each ported model, as its JAX counterpart's init writes them
PARAM_NAMES = {
    "lightgcn": _TABLES, "ncl": _TABLES, "directau": _TABLES,
    "selfcf": _TABLES + _linear("predictor"),
    "buir": _TABLES + _linear("predictor"),
    "ssl4rec": _TABLES + _linear("user_net.*") + _linear("item_net.*"),
    "gcl": _TABLES + _linear("proj1") + _linear("proj2") + _linear("convs.*"),
    "grace": ("features",) + _linear("convs.*") + _linear("fc1") + _linear("fc2"),
    "gbt": ("features",) + _linear("conv1") + _linear("conv2"),
    "bgrl": ("features",) + _gin_encoder("online") + _linear("predictor"),
    "graphsage": ("features",) + _linear("layers.*.self") + _linear("layers.*.neigh"),
    "gat": _TABLES + tuple(f"gat{i}.{k}" for i in (1, 2) for k in ("w", "a_src", "a_dst")),
}
# the model state each ported model carries, name pattern -> dtype
STATE_DTYPES = {
    "lightgcn": {},
    "directau": {},
    "ncl": {"user_centroids": np.float32, "user_2cluster": np.int32,
            "item_centroids": np.float32, "item_2cluster": np.int32},
    "selfcf": {"u_his": np.float32, "i_his": np.float32},
    "buir": {"t_user_emb": np.float32, "t_item_emb": np.float32},
    "ssl4rec": {}, "gcl": {}, "grace": {}, "gbt": {}, "graphsage": {}, "gat": {},
    "bgrl": {n: np.float32 for n in _gin_encoder("target")},
}
# GCL's ``convs`` exist only with GCL.encoder='linear'
OPTIONAL = {"gcl": ("convs.*.w", "convs.*.b")}
ALIASES = {"grace_rec": "gcl", "bgrl_g2l": "bgrl"}


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a nested tree of dicts and lists under their dotted
    paths, in the tree's own order (dict insertion order, list index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def subtree(flat: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The branch ``prefix`` of a flat dict, its names relative to it
    (``subtree(p, "online")["proj.w"]`` is ``p["online.proj.w"]``)."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def layer_count(flat: Dict[str, Any], prefix: str) -> int:
    """How many list entries ``prefix.<i>.*`` the flat dict holds."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    return len({m.group(1) for k in flat if (m := pat.match(k))})


def _pattern(p: str) -> re.Pattern:
    return re.compile("".join(r"\d+" if part == "*" else re.escape(part)
                              for part in re.split(r"(\*)", p)) + "$")


def check_layout(kind: str, model_name: str, names, layouts) -> tuple:
    """The patterns of ``model_name`` in ``layouts``; raises KeyError for a
    model the port lacks and ValueError unless every name matches a pattern
    and every required pattern a name."""
    key = ALIASES.get(model_name.lower(), model_name.lower())
    if key not in layouts:
        raise KeyError(f"no {kind} layout for model {model_name!r}; have {sorted(layouts)}")
    patterns = tuple(layouts[key])
    optional = OPTIONAL.get(key, ()) if kind == "parameter" else ()
    regs = [_pattern(p) for p in patterns]
    stray = [n for n in names if not any(r.match(n) for r in regs)]
    missing = [p for p, r in zip(patterns, regs)
               if p not in optional and not any(r.match(n) for n in names)]
    if stray or missing:
        raise ValueError(f"{model_name} {kind}s are {list(patterns)}; got {sorted(names)} "
                         f"(unexpected {stray}, missing {missing})")
    return patterns


def _to_tensors(model_name: str, arrays, device) -> Dict[str, torch.Tensor]:
    arrays = flatten_tree(dict(arrays))
    patterns = check_layout("parameter", model_name, list(arrays), PARAM_NAMES)
    regs = [_pattern(p) for p in patterns]
    # in the layout's order (a stable sort by the pattern each name matches)
    names = sorted(arrays, key=lambda n: next(i for i, r in enumerate(regs) if r.match(n)))
    dev = resolve_device(device)
    # torch.tensor copies: JAX hands out read-only views of its buffers
    return {n: torch.tensor(np.asarray(arrays[n], dtype=np.float32)).to(dev) for n in names}


def params_from_jax(model_name: str, params_np, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's flat parameters from the JAX package's pytree of numpy
    arrays, name for name (nested names dotted)."""
    return _to_tensors(model_name, params_np, device)


def state_from_jax(model_name: str, state_np, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's flat model state from the JAX package's state pytree of
    numpy arrays (``jax.device_get(state)``), name for name: float tables
    as float32, cluster ids as int32."""
    flat = flatten_tree(dict(state_np))
    patterns = check_layout("state", model_name, list(flat), STATE_DTYPES)
    dtypes = STATE_DTYPES[ALIASES.get(model_name.lower(), model_name.lower())]
    regs = [(_pattern(p), dtypes[p]) for p in patterns]
    dev = resolve_device(device)
    return {n: torch.tensor(np.asarray(a, dtype=next(t for r, t in regs if r.match(n))))
            .to(dev) for n, a in flat.items()}


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    np.savez(path, **{n: t.detach().cpu().numpy() for n, t in params.items()})


def load_params(path: str, model_name: str, device="cuda") -> Dict[str, torch.Tensor]:
    with np.load(path) as f:
        arrays = {n: f[n] for n in f.files}
    return _to_tensors(model_name, arrays, device)


def opt_state_from_jax(optax_adam_state, params: Dict[str, torch.Tensor], lr: float = 1e-3) -> dict:
    """A ``torch.optim.Adam`` ``state_dict`` from optax's
    ``ScaleByAdamState(count, mu, nu)`` given as numpy arrays (or the
    ``optax.adam`` chain's state tuple that starts with it; nested moments
    are flattened to the parameters' dotted names), for an Adam
    built over ``list(params.values())`` at rate ``lr``, as
    ``train.loop.make_optimizer`` builds it. Each parameter's moments land on
    its device; ``step`` is optax's count, so the bias correction carries on
    mid-trajectory."""
    adam = optax_adam_state
    if not hasattr(adam, "mu"):
        adam = next(s for s in optax_adam_state if hasattr(s, "mu"))
    template = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8).state_dict()
    step = float(np.asarray(adam.count))
    mu, nu = flatten_tree(dict(adam.mu)), flatten_tree(dict(adam.nu))
    state = {}
    for index, (name, p) in enumerate(params.items()):
        state[index] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name], dtype=np.float32)).to(p.device),
        }
    return {"state": state, "param_groups": template["param_groups"]}
