"""Disk checkpoints of a training run (counterpart of
``recommendation_tpu/train/checkpoint.py``).

Each checkpoint is one ``torch.save`` file, ``step_<epoch>.pt``, holding
the parameters, the optimizer's ``state_dict``, the model state, the
trainer's generator states and the epoch. ``CheckpointManager`` keeps the
last ``keep`` of them. Saving the generators (which the JAX package's
checkpoints leave out) makes a resumed run draw what a straight run would.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    """Keep-last-N rolling checkpoints of a training run in ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

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
            if name.startswith("step_") and name.endswith(".pt"):
                try:
                    steps.append(int(name[len("step_"):-len(".pt")]))
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
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            os.remove(self._path(s))
