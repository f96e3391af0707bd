"""The kernel wrappers' launch counters, read and written as one.

Every wrapper of a hand-written kernel counts its launches on the host in
``.launches`` (P1's also in ``.launches_int8`` and ``.launches_fused``).
A CUDA graph's replay calls no wrapper, so ``train/graphed.py`` takes a
snapshot of every counter around a capture (``launch_counts``), puts them
back (``set_counts``: a capture launches nothing) and adds the captured
launches on each replay (``add_launches``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

Counter = Tuple[Callable, str]


def kernel_wrappers() -> tuple:
    """The port's kernel wrappers, each counting its launches in
    ``.launches``: K1-K4, K5/K6, K7, P1, Q1, S1 (and with the head dot),
    S2 (on given logits and with GAT's fused in), P2."""
    from recommendation_tpu_torch.ops.gather import gather_rows, gather_sum, quantize_rows
    from recommendation_tpu_torch.ops.lse import catalog_lse, catalog_lse_bwd
    from recommendation_tpu_torch.ops.prop import (
        chain_mean,
        chain_mean_bwd,
        chain_mean_layer,
        chain_mean_layer_bwd,
    )
    from recommendation_tpu_torch.ops.segment import (
        attention_softmax,
        attention_softmax_bwd,
        segment_softmax_rows,
        segment_softmax_rows_bwd,
        segment_sum,
        weighted_pull,
        weighted_pull_dot,
    )

    return (chain_mean, chain_mean_bwd, chain_mean_layer, chain_mean_layer_bwd, catalog_lse,
            catalog_lse_bwd, gather_rows, gather_sum, quantize_rows, weighted_pull,
            weighted_pull_dot, segment_softmax_rows, segment_softmax_rows_bwd,
            attention_softmax, attention_softmax_bwd, segment_sum)


def launch_counts() -> Dict[Counter, int]:
    """Every counter of every wrapper: ``.launches`` and the other
    ``launches_*`` counts (not ``launches_per_call``, a constant)."""
    return {(f, name): value for f in kernel_wrappers() for name, value in vars(f).items()
            if name.startswith("launches") and name != "launches_per_call"}


def set_counts(counts: Dict[Counter, int]) -> None:
    for (f, name), value in counts.items():
        setattr(f, name, value)


def add_launches(delta: Dict[Counter, int]) -> None:
    for (f, name), value in delta.items():
        setattr(f, name, getattr(f, name) + value)


def count_delta(after: Dict[Counter, int], before: Dict[Counter, int]) -> Dict[Counter, int]:
    """The launches between two snapshots, the counters that moved."""
    return {k: v - before[k] for k, v in after.items() if v != before[k]}
