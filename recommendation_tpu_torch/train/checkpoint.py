"""Disk checkpoints of a training run (counterpart of
``recommendation_tpu/train/checkpoint.py``).

Each checkpoint is one ``torch.save`` file, ``step_<epoch>.pt``, holding
the parameters, the optimizer's ``state_dict``, the model state, the
trainer's generator states and the epoch. ``CheckpointManager`` keeps the
last ``keep`` of them. Saving the generators (which the JAX package's
checkpoints leave out) makes a resumed run draw what a straight run would.

A sharded trainer (``parallel/trainer.py``) gives each rank a manager of
its own (``rank``): the rank writes ``step_<epoch>.rank<r>.pt`` with its
shards, their optimizer moments and the mesh layout, where orbax writes
each process's shards of one global array.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    """Keep-last-N rolling checkpoints of a training run in ``directory``."""

    def __init__(self, directory: str, keep: int = 3, rank: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.suffix = ".pt" if rank is None else f".rank{rank}.pt"
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}{self.suffix}")

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        path = self._path(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a reader sees the whole file or none
        self._gc()
        return path

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(self.suffix):
                try:
                    steps.append(int(name[len("step_"):-len(self.suffix)]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        """The newest payload, its tensors on the CPU (the trainer copies
        them to its device), or None when there is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step)

    def restore(self, step: int) -> Dict[str, Any]:
        """The payload saved at ``step``, its tensors on the CPU."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            os.remove(self._path(s))
