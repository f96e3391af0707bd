"""Logging / output (a copy of ``recommendation_tpu/utils/logging.py``).

Covers the reference's ``Log`` file logger (`ncl.py:212-224` — python logging
to ``./log/<name>.log``) and the buffered list logger (`selfcf.py:54-65`),
plus structured results writers (JSON `ncl.py:490-493`, CSV append
`lightgcn.py:164-173`). Everything downstream consumes structured dicts, not
parsed strings (SURVEY.md §5 observability fix).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Dict, Iterable, Sequence


class Log:
    """Buffered logger that optionally tees to ./log/<name>-<ts>.log."""

    def __init__(self, name: str = "run", to_file: bool = False, log_dir: str = "./log", echo: bool = True):
        self.name = name
        self.buffer: list[str] = []
        self.echo = echo
        self._logger = None
        if to_file:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{name}-{int(time.time())}.log")
            self._logger = logging.getLogger(f"rectpu.{name}.{id(self)}")
            self._logger.setLevel(logging.INFO)
            handler = logging.FileHandler(path)
            handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            self._logger.addHandler(handler)

    def add(self, text: str) -> None:
        self.buffer.append(str(text))
        if self.echo:
            print(text, flush=True)
        if self._logger:
            self._logger.info(text)

    def contents(self) -> list[str]:
        return list(self.buffer)


def save_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def append_csv(path: str, row: Dict, fieldnames: Sequence[str] | None = None) -> None:
    """CSV append with header-on-create (`lightgcn.py:164-173`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = os.path.exists(path)
    fieldnames = list(fieldnames or row.keys())
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        if not exists:
            writer.writeheader()
        writer.writerow(row)
