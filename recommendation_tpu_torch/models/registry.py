"""Model registry: model name → model class (the port's models only)."""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}

# modules of the port that register models; more join as slices land
_MODEL_MODULES = ("lightgcn", "ncl", "directau", "selfcf", "buir", "ssl4rec", "gcl", "grace",
                  "gbt", "bgrl", "graphsage", "gat")


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def build(name: str, config):
    key = name.lower()
    if key not in _REGISTRY:
        _ensure_imported()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[key](config)


def available() -> list[str]:
    _ensure_imported()
    return sorted(_REGISTRY)


def _ensure_imported():
    import importlib

    for mod in _MODEL_MODULES:
        importlib.import_module(f"recommendation_tpu_torch.models.{mod}")
