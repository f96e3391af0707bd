"""Model parameters: import from the JAX package, and the port's checkpoint.

``params_from_jax`` takes a JAX parameter pytree given as numpy arrays
(``jax.device_get(params)``) and returns the port's tensors, name for name.
``save_params``/``load_params`` keep the same names in one ``.npz`` file:
the port's checkpoint for ``serve`` (the JAX package's orbax checkpoints
cannot be read without JAX). ``opt_state_from_jax`` carries an optax Adam
state over into a ``torch.optim.Adam`` ``state_dict``, and ``state_from_jax``
a model's non-gradient state (NCL's clusters), integer tables as int32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from recommendation_tpu_torch.device import resolve_device

# parameter names of each ported model, as its JAX counterpart's init returns them
PARAM_NAMES = {"lightgcn": ("user_emb", "item_emb"), "ncl": ("user_emb", "item_emb"),
               "directau": ("user_emb", "item_emb")}
# the model state each ported model carries, name -> dtype
STATE_DTYPES = {
    "lightgcn": {},
    "directau": {},
    "ncl": {"user_centroids": np.float32, "user_2cluster": np.int32,
            "item_centroids": np.float32, "item_2cluster": np.int32},
}


def _to_tensors(model_name: str, arrays, device) -> Dict[str, torch.Tensor]:
    names = PARAM_NAMES.get(model_name.lower())
    if names is None:
        raise KeyError(f"no parameter layout for model {model_name!r}; have {sorted(PARAM_NAMES)}")
    if set(arrays) != set(names):
        raise ValueError(f"{model_name} parameters are {sorted(names)}, got {sorted(arrays)}")
    dev = resolve_device(device)
    # torch.tensor copies: JAX hands out read-only views of its buffers
    return {n: torch.tensor(np.asarray(arrays[n], dtype=np.float32)).to(dev) for n in names}


def params_from_jax(model_name: str, params_np, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's parameters from the JAX package's pytree of numpy arrays."""
    return _to_tensors(model_name, dict(params_np), device)


def state_from_jax(model_name: str, state_np, device="cuda") -> Dict[str, torch.Tensor]:
    """The port's model state from the JAX package's state pytree of numpy
    arrays (``jax.device_get(state)``), name for name: float tables as
    float32, cluster ids as int32."""
    dtypes = STATE_DTYPES.get(model_name.lower())
    if dtypes is None:
        raise KeyError(f"no state layout for model {model_name!r}; have {sorted(STATE_DTYPES)}")
    state_np = dict(state_np)
    if set(state_np) != set(dtypes):
        raise ValueError(f"{model_name} state is {sorted(dtypes)}, got {sorted(state_np)}")
    dev = resolve_device(device)
    return {n: torch.tensor(np.asarray(state_np[n], dtype=t)).to(dev) for n, t in dtypes.items()}


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    np.savez(path, **{n: t.detach().cpu().numpy() for n, t in params.items()})


def load_params(path: str, model_name: str, device="cuda") -> Dict[str, torch.Tensor]:
    with np.load(path) as f:
        arrays = {n: f[n] for n in f.files}
    return _to_tensors(model_name, arrays, device)


def opt_state_from_jax(optax_adam_state, params: Dict[str, torch.Tensor], lr: float = 1e-3) -> dict:
    """A ``torch.optim.Adam`` ``state_dict`` from optax's
    ``ScaleByAdamState(count, mu, nu)`` given as numpy arrays (or the
    ``optax.adam`` chain's state tuple that starts with it), for an Adam
    built over ``list(params.values())`` at rate ``lr``, as
    ``train.loop.make_optimizer`` builds it. Each parameter's moments land on
    its device; ``step`` is optax's count, so the bias correction carries on
    mid-trajectory."""
    adam = optax_adam_state
    if not hasattr(adam, "mu"):
        adam = next(s for s in optax_adam_state if hasattr(s, "mu"))
    template = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8).state_dict()
    step = float(np.asarray(adam.count))
    state = {}
    for index, (name, p) in enumerate(params.items()):
        state[index] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(adam.mu[name], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.tensor(np.asarray(adam.nu[name], dtype=np.float32)).to(p.device),
        }
    return {"state": state, "param_groups": template["param_groups"]}
