"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Nothing moves to the CPU by itself: asking for CUDA where there is no card
raises, and the CPU runs only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so the result compares equal to a tensor's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
