"""Graph augmentation on the device (counterpart of
``recommendation_tpu/graph/augment.py``).

Mask-based transforms of fixed shape: edge dropout with re-normalization
(`univariate/sept.py:53-61`), value-level edge dropout (PyG ``dropout_adj``,
`univariate/grace.py:270-289`; BUIR's sparse dropout,
`univariate/buir.py:300-309`) and column-wise feature masking. Every draw
comes from an explicit ``torch.Generator`` and is made on that
generator's device, then placed on the tensors' device. The trainer makes
one generator on the graph's device (``device_generator``, seeded once
from its host generator) and hands it to every step, so on the card the
masks are made where they are used, nothing crosses to the host, and a
CUDA graph that registers the generator advances it at every replay as
the eager steps do (``train/graphed.py``). The draws differ from
``jax.random``'s; a Bernoulli keep is ``uniform < 1 - p``, as there. Every
draw of the port's random models goes through ``uniform``,
``permutation`` or ``randint``, so a test or a check can give both
frameworks the same numbers by replacing those three.
"""

from __future__ import annotations

import torch

from recommendation_tpu_torch.graph.device import DeviceAdj, DeviceGraph, with_vals


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw of ``generator`` (a host
    generator: the draw stays on the host). The trainer makes its step
    generator so, once; SEPT's ``epoch_begin`` makes one from the epoch's
    generator, between the epoch's graphs."""
    return torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2**62, (1,), generator=_source(generator))))


def _source(generator: torch.Generator) -> torch.Generator:
    if generator is None:
        raise ValueError("this loss draws random masks: pass the trainer's generator")
    return generator


def uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """f32[shape] uniform in [0, 1) on ``device``, drawn on ``generator``'s
    device: the one draw every mask of the port's augmenting models is
    made from."""
    g = _source(generator)
    return torch.rand(tuple(shape), generator=g, device=g.device).to(device)


def permutation(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """i64[n]: a random permutation of 0..n-1 on ``device``, drawn on
    ``generator``'s device (MHCN's shuffled negatives): the one
    permutation draw of the port's models."""
    g = _source(generator)
    return torch.randperm(n, generator=g, device=g.device).to(device)


def randint(generator: torch.Generator, high: int, device) -> torch.Tensor:
    """i64[]: a uniform integer in [0, high) on ``device``, drawn on
    ``generator``'s device (ESRF's user segment start, an offset that a
    step reads on the device, never on the host)."""
    g = _source(generator)
    return torch.randint(0, high, (), generator=g, device=g.device).to(device)


def keep_draw(generator: torch.Generator, shape, keep_prob, device) -> torch.Tensor:
    """bool[shape]: each entry kept with probability ``keep_prob`` (a float
    or a 0-d tensor on ``device``)."""
    return uniform(generator, shape, device) < keep_prob


def edge_keep_mask(generator: torch.Generator, graph: DeviceGraph,
                   drop_rate: float) -> torch.Tensor:
    """Bernoulli keep-mask over the interaction edges (f32[E_pad])."""
    return keep_draw(generator, graph.edge_valid.shape, 1.0 - drop_rate,
                     graph.edge_valid.device).to(torch.float32)


def dropped_norm_adj(generator: torch.Generator, graph: DeviceGraph, drop_rate: float) -> DeviceAdj:
    """The edge-dropped, re-normalized bipartite adjacency, on the device."""
    return graph.normalized_bipartite(edge_keep_mask(generator, graph, drop_rate))


def drop_edges(generator: torch.Generator, adj: DeviceAdj, drop_rate: float,
               renormalize: bool = False) -> DeviceAdj:
    """Edge dropout on any ``DeviceAdj`` by zeroing values. With
    ``renormalize=False`` (BUIR's semantics) the kept values are scaled by
    1 / max(1 - p, 1e-8), as inverted dropout does."""
    keep = keep_draw(generator, adj.vals.shape, 1.0 - drop_rate, adj.vals.device)
    scale = 1.0 if renormalize else 1.0 / max(1.0 - drop_rate, 1e-8)
    return with_vals(adj, torch.where(keep, adj.vals * scale, torch.zeros_like(adj.vals)))


def mask_features(generator: torch.Generator, x: torch.Tensor, mask_rate: float) -> torch.Tensor:
    """Column-wise feature masking (`univariate/grace.py:281-289`): zero a
    random subset of feature dimensions across all nodes."""
    keep = keep_draw(generator, (x.shape[-1],), 1.0 - mask_rate, x.device)
    return x * keep.to(x.dtype)[None, :]
