"""Configuration system (a copy of ``recommendation_tpu/config.py``).

Unifies the reference's three coexisting config generations (SURVEY.md §5):
nested dicts with dotted keys (`ncl.py:507-526`), the YAML-capable ModelConf
(`selfcf.py:20-50`, hard error on missing key), and the string-encoded flag
lines parsed by OptionConf (`univariate/diffnet.py:505-542`, e.g.
``'on -topN 10,20'``).

Canonical keys honored across the framework (reference contract):
  embedding.size, batch.size, learning.rate, reg.lambda, max.epoch,
  item.ranking.topN (default [10, 20, 30, 50]), optimizer,
  plus per-model blocks, e.g. NCL.tau, SelfCF.n_layer, DirectAU.gamma.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class Config:
    """Dotted-key config with defaults, YAML loading, and strict access.

    ``conf['embedding.size']`` raises ``KeyError`` on a missing key (the
    ModelConf ``selfcf.py:31-35`` contract, minus the hard ``exit()``);
    ``conf.get(key, default)`` is the soft accessor.

    Nested dicts and flat dotted keys are interchangeable on input:
    ``{'NCL': {'tau': 0.1}}`` and ``{'NCL.tau': 0.1}`` denote the same key.
    """

    def __init__(self, config: Mapping[str, Any] | None = None, **kwargs: Any):
        self._store: dict[str, Any] = {}
        if config:
            self.update(config)
        if kwargs:
            self.update(kwargs)

    @staticmethod
    def _flatten(d: Mapping[str, Any], prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, Mapping):
                yield from Config._flatten(v, prefix=f"{key}.")
            else:
                yield key, v

    def update(self, other: Mapping[str, Any]) -> "Config":
        for k, v in Config._flatten(other):
            self._store[k] = v
        return self

    def __getitem__(self, key: str) -> Any:
        if key in self._store:
            return self._store[key]
        # Allow sub-tree access: conf['NCL'] -> {'tau': ..., ...}
        prefix = key + "."
        sub = {k[len(prefix):]: v for k, v in self._store.items() if k.startswith(prefix)}
        if sub:
            return sub
        raise KeyError(f"config key {key!r} not found (have: {sorted(self._store)})")

    def __setitem__(self, key: str, value: Any) -> None:
        self._store[key] = value

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def copy(self) -> "Config":
        c = Config()
        c._store = copy.deepcopy(self._store)
        return c

    def with_overrides(self, **overrides: Any) -> "Config":
        c = self.copy()
        c.update(overrides)
        return c

    def as_dict(self) -> dict[str, Any]:
        return dict(self._store)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self._store!r})"

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))


# Defaults shared by every model family; per-model configs layer on top.
DEFAULTS = {
    "embedding.size": 64,
    "batch.size": 2048,
    "learning.rate": 1e-3,
    "reg.lambda": 1e-4,
    "max.epoch": 30,
    "optimizer": "adam",
    "item.ranking.topN": [10, 20, 30, 50],
    "eval.interval": 1,
    "seed": 0,
    "dtype": "float32",
}


def default_config(**overrides: Any) -> Config:
    return Config(DEFAULTS).with_overrides(**overrides)


class OptionConf:
    """Parser for the reference's string-encoded flag lines.

    ``OptionConf('on -topN 10,20')['-topN'] == '10,20'``; leading bare token
    (``'on'``/``'off'``) toggles ``is_main_on``. Mirrors the behavior of
    ``univariate/diffnet.py:505-542`` (used there for `item.ranking` and
    cross-validation option strings).
    """

    def __init__(self, content: str):
        self.line = content.strip().split()
        self.options: dict[str, str] = {}
        self.main_option = False
        if self.line and self.line[0] in ("on", "off"):
            self.main_option = self.line[0] == "on"
            rest = self.line[1:]
        else:
            rest = self.line
        i = 0
        while i < len(rest):
            if rest[i].startswith("-"):
                key = rest[i]
                vals = []
                i += 1
                while i < len(rest) and not rest[i].startswith("-"):
                    vals.append(rest[i])
                    i += 1
                self.options[key] = " ".join(vals)
            else:
                i += 1

    def is_main_on(self) -> bool:
        return self.main_option

    def contains(self, key: str) -> bool:
        return key in self.options

    def __contains__(self, key: str) -> bool:
        return key in self.options

    def __getitem__(self, key: str) -> str:
        if key not in self.options:
            raise KeyError(f"parameter {key!r} is invalid")
        return self.options[key]

    def keys(self):
        return self.options.keys()


def apply_legacy_options(conf: Config) -> Config:
    """Translate the legacy string-flag config keys into canonical ones.

    Handles the two OptionConf-encoded keys the legacy stack uses
    (`univariate/diffnet.py:505-542`, usage 1220):
      * ``item.ranking``: ``'on -topN 10,20'`` → ``item.ranking.topN``
      * ``evaluation.setup``: ``'cv -k 1 -p on -rand-seed 1'`` →
        ``eval.cv_k`` / ``eval.rand_seed`` (k=1 == the single hold-out split
        every reference run actually uses)
    No-ops when the keys are absent or already canonical."""
    ranking = conf.get("item.ranking")
    if isinstance(ranking, str):
        opt = OptionConf(ranking)
        if opt.is_main_on() and "-topN" in opt:
            conf["item.ranking.topN"] = [int(x) for x in opt["-topN"].split(",")]
    setup = conf.get("evaluation.setup")
    if isinstance(setup, str):
        opt = OptionConf(setup)
        if "-k" in opt:
            conf["eval.cv_k"] = int(opt["-k"])
        if "-rand-seed" in opt:
            conf["eval.rand_seed"] = int(opt["-rand-seed"])
    return conf
