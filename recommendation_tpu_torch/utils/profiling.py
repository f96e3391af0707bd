"""Tracing / profiling utilities, the counterpart of
``recommendation_tpu/utils/profiling.py``.

* ``profile_trace(dir)``: a context manager around ``torch.profiler``
  (the host, and the card where there is one) that writes a Chrome trace
  (``trace-<pid>-<n>.json``, viewable in Perfetto or chrome://tracing).
* ``Throughput``: an examples/s (per device) counter over a window of
  steps or epochs.

The JAX package's ``enable_compilation_cache`` (XLA's persistent compile
cache) has no counterpart here: what the port compiles are its CUDA
kernels and its native host library, and both are already built once and
kept by content hash in ``recommendation_tpu_torch/_build/``
(``ops/build.py``, ``native/build.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: str = "./profile"):
    """``with profile_trace('./profile') as prof: step()`` writes the
    window's Chrome trace into ``log_dir`` on exit; ``prof`` is the
    ``torch.profiler.profile`` (its ``key_averages()``, and
    ``prof.trace_path`` once the block has ended)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_TRACES)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


class Throughput:
    """Examples/s (per chip) over a window of steps/epochs."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = max(1, n_devices)
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._examples = 0

    def add(self, n_examples: int):
        self._examples += n_examples

    @property
    def examples_per_s(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._examples / dt if dt > 0 else 0.0

    @property
    def examples_per_s_per_chip(self) -> float:
        return self.examples_per_s / self.n_devices
