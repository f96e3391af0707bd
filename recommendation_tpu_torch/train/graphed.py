"""The epoch as one device execution: CUDA graphs of the step loop
(counterpart of the JAX trainer's jitted epoch, ``make_epoch_fn`` with
its ``steps_per_call`` chunks, in ``recommendation_tpu/train/loop.py``).

``GraphedEpoch.run`` trains one epoch with the step of the eager loop
(``train.loop.train_step``), in the same order and with the same draws,
so it gives ``train.loop.train_epoch``'s bits. On the card it captures
the epoch once (``CUDAGraph.capture_begin`` on the runner's own stream)
and replays it; on the CPU the
same bodies run eagerly (``capture`` off), so the CPU tests cover the
bookkeeping. The trainer (``train/recommender.py``) runs its epochs so,
and fuses ``eval.interval`` epochs into a block that reads its losses
once, for every registered model at every configuration (NCL's
per-batch E-step, whose state every step produces, carried as any state
is). A sharded trainer (``parallel/trainer.py``) passes its ``placement``,
as ``train.loop.run_steps`` takes it: each captured step gathers the
rank's shards, cuts its rows of the global batch and sums the gradients
over the data group, so the graphs hold NCCL's collectives, as the JAX
package's sharded epoch is one jitted program with GSPMD's collectives in
it. Only NCCL's collectives can be captured (they run on a stream that
joins the capture); gloo's run on the host, so a placement over gloo runs
the same bodies eagerly (``capture`` off: the CPU) or is refused on a
card.

What a graph holds, as the JAX scan's carry and inputs:
  * **draws**: the epoch draws on the card from the trainer's generator
    there (``draws``), as the JAX epoch draws inside its jitted program:
    first its words (``sampling.epoch_words``: the permutation's round
    keys and salts, the negatives' words), then the losses' masks
    (``graph/augment.py``). Every capture registers that generator
    (``CUDAGraph.register_generator_state``): each replay reads its Philox
    offset when it starts and advances it by what the captured draws
    take, as the eager epoch does, so consecutive replays draw new words
    and masks and an epoch replayed from a generator state equals the
    eager epoch from that state. No word crosses from the host: a
    generator that is not on the card cannot be captured, and ``run``
    refuses it;
  * **sampling**: ``epoch_words`` and ``sampling.epoch_batches`` read
    nothing on the host, so they run inside the graph: before the steps
    in an unchunked epoch's one graph; in a chunked epoch in a graph of
    its own that writes the epoch's batches into buffers, whose slices
    each chunk's replay takes as its inputs (copied on the card, outside
    the graphs);
  * **carry**: the parameters and the optimizer's state are updated in
    place and keep their addresses; the model's state is functional, so
    the graph copies the last step's state into static tensors at its end.
    A state handed in from outside (NCL's E-step, SEPT's edge-dropped
    view, run eagerly between replays) is copied into them before the
    replay. A state's host values (ESRF's phase, a Python int) are
    constants of a captured step: the graphs are keyed by them, one graph
    (or one per chunk length) for each value the epochs meet;
  * **outputs**: each step's loss in a slot of a static buffer, and the
    mean of the finite ones; the trainer's one host read of the epoch
    (or of a fused block) reads that.

Chunking follows the JAX rule (``steps_per_call``): an epoch whose
batches weighted by its millions of edges exceed
``train.max_steps_per_call`` runs in chunks of ``train.steps_per_call``
steps, one graph for the full chunk and one for the remainder.

The first run of each graph is its warm-up, as capture requires: an
eager run on the runner's own stream (a real run of the epoch or chunk,
its launches counted), which also fills the lazy caches that a capture
must find filled (the chain's tile counters for the stream, the kernels'
plans, the optimizer's state, and under a placement NCCL's communicator
of every group the step reads, which each group makes at its first
collective). Then the graph is captured, and later runs replay it. Every
rank of a sharded trainer runs the same epochs with the same host values,
so every rank warms up, captures and replays the same keys in the same
order, as its collectives require.

Launch counts: a replay calls no wrapper, so each capture records the
launches its body's wrappers counted (``ops/counts.py``), puts the
counters back (a capture launches nothing), and every replay adds them.

A graph reads fixed addresses: the parameters, the optimizer's state, the
tensors of its param groups (a tensor rate, which
``train.loop.set_learning_rate`` fills in place; G-BT's schedule count)
and the generator it registered. A run whose tensors moved (a checkpoint
restored through ``load_state_dict``) or that draws from another
generator drops its graphs and captures again. A float rate is a
constant of the captured update: a run whose float rate moved raises (a
rate that moves is a tensor, ``train.loop.tensor_rates``). Adam
must be made ``capturable`` on the card (``train.loop.make_optimizer``
does): a capture of any step that the card cannot capture raises, and
nothing falls back to the eager loop.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from recommendation_tpu_torch.ops.counts import (
    add_launches,
    count_delta,
    launch_counts,
    set_counts,
)
from recommendation_tpu_torch.sampling import PairwiseBatch, epoch_batches, epoch_words
from recommendation_tpu_torch.train.loop import finite_mean, train_step


def steps_per_call(n_edges: int, batch_size: int, config) -> Optional[int]:
    """The chunk length of an epoch, or None for one piece: the JAX
    trainer's rule (``recommendation_tpu/train/recommender.py``). Each step
    propagates over the whole graph, so the batches are weighted by the
    graph's millions of edges against ``train.max_steps_per_call``."""
    n_batches = -(-n_edges // batch_size)
    cost_weight = max(1, -(-n_edges // 1_000_000))
    if n_batches * cost_weight > int(config.get("train.max_steps_per_call", 512)):
        return int(config.get("train.steps_per_call", 32))
    return None


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _clone(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _keys(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _host_values(tree: Any) -> tuple:
    """The leaves of ``tree`` that are not tensors, in order."""
    if isinstance(tree, dict):
        return tuple(v for t in tree.values() for v in _host_values(t))
    return () if isinstance(tree, torch.Tensor) else (tree,)


def _refill(static: Any, given: Any) -> Any:
    """``static`` with ``given``'s tensor values copied in and its host
    values taken."""
    if isinstance(given, dict):
        return {k: _refill(static[k], v) for k, v in given.items()}
    if isinstance(given, torch.Tensor):
        if given is not static:
            static.copy_(given)
        return static
    return given


class GraphedEpoch:
    """One epoch of ``train_step`` over ``params`` (updated in place) as
    CUDA graphs on a card, eagerly elsewhere (``capture``; module
    docstring); ``steps_per_call`` cuts the epoch into chunks; with a
    ``placement`` (``parallel/trainer.py``: NCCL's on a card) ``params``
    are the rank's shards.
    ``captures`` records each capture's graph, seconds and pool bytes;
    ``keys`` every graph's key in the order first run (the order in which
    the ranks of a sharded trainer must capture alike)."""

    def __init__(self, model, optimizer: torch.optim.Optimizer, graph,
                 params: Dict[str, torch.Tensor], batch_size: int,
                 steps_per_call: Optional[int] = None, n_redraws: int = 4, placement=None):
        self.model, self.optimizer, self.graph, self.params = model, optimizer, graph, params
        self.batch_size, self.n_redraws = batch_size, n_redraws
        self.placement = placement  # a sharded trainer's (``train.loop``): None alone
        self.device = graph.device
        self.capture = self.device.type == "cuda"
        if self.capture and placement is not None and not placement.capturable:
            raise ValueError(f"a placement over {placement.backend} cannot be captured: its "
                             f"collectives run on the host (NCCL's are captured)")
        if self.capture:
            for group in optimizer.param_groups:
                if group.get("capturable") is False:
                    raise ValueError(f"{type(optimizer).__name__} must be made with "
                                     "capturable=True for its step to be captured")
        self.n_batches = max(1, -(-graph.n_edges // batch_size))
        if steps_per_call is not None and steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.chunks: Optional[List[Tuple[int, int]]] = None
        if steps_per_call is not None and steps_per_call < self.n_batches:
            self.chunks = [(s, min(steps_per_call, self.n_batches - s))
                           for s in range(0, self.n_batches, steps_per_call)]
        self.stream = torch.cuda.Stream(self.device) if self.capture else None
        self.state: Any = None  # the static model state (the carry)
        self.batches: Optional[List[torch.Tensor]] = None  # a chunked epoch's batches
        self.losses: Optional[torch.Tensor] = None  # a chunked epoch's step losses
        self._inputs: Dict[int, List[torch.Tensor]] = {}  # a chunk's static batches
        self._graphs: Dict[Any, tuple] = {}  # key -> (graph, its outputs, its launches)
        self._bound = None  # the addresses and float rates the graphs read
        self._draws: Optional[torch.Generator] = None  # the epoch's generator
        self.captures: List[dict] = []
        self.keys: List[tuple] = []  # every graph's key in the order first run, on any device

    # -- the bodies: what a graph holds -----------------------------------------

    def _steps(self, users, items, negs, weights) -> torch.Tensor:
        """The steps over [n, B] batches, the state carried into the static
        state; the n step losses."""
        n = users.shape[0]
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        state = self.state
        for b in range(n):
            state, losses[b] = train_step(self.model, self.optimizer, self.graph, self.params,
                                          state, PairwiseBatch(users[b], items[b], negs[b],
                                                               weights[b]), self._draws,
                                          self.placement)
        for static, new in zip(_leaves(self.state), _leaves(state)):
            if new is not static:
                static.copy_(new)
        return losses

    def _batches(self):
        """The epoch's words drawn from the registered generator, and its
        [n, B] batches."""
        words = epoch_words(self._draws, self.graph, self.batch_size, self.n_redraws)
        return epoch_batches(words, self.graph, self.batch_size, self.n_redraws)[:4]

    def _epoch_body(self) -> torch.Tensor:
        return finite_mean(self._steps(*self._batches()))

    def _sample_body(self) -> None:
        out = self._batches()
        if self.batches is None:  # the warm-up runs first, eagerly: never under capture
            self.batches = [torch.empty_like(t) for t in out]
        for static, t in zip(self.batches, out):
            static.copy_(t)

    def _chunk_body(self, size: int) -> torch.Tensor:
        return self._steps(*self._inputs[size])

    # -- running ------------------------------------------------------------------

    def _addresses(self):
        groups = self.optimizer.param_groups
        tensors = list(self.params.values())
        for p in tensors:
            tensors += [v for v in self.optimizer.state.get(p, {}).values()
                        if isinstance(v, torch.Tensor)]
        tensors += [v for g in groups for k, v in g.items()
                    if k != "params" and isinstance(v, torch.Tensor)]
        rates = tuple(g["lr"] for g in groups if not isinstance(g["lr"], torch.Tensor))
        return tuple(t.data_ptr() for t in tensors) + (id(self._registered()),), rates

    def _registered(self) -> Optional[torch.Generator]:
        """The generator the graphs register: the epoch's on the card."""
        return self._draws if self.capture else None

    def reset(self) -> None:
        """Drop the graphs: the next run warms up and captures again."""
        self._graphs.clear()
        self._bound = None

    def _capture(self, key, body):
        """``body`` captured on the runner's stream, after its warm-up there:
        ``capture_begin``, not ``torch.cuda.graph``, so that no synchronize
        and no ``empty_cache`` of the whole process precede it. The pool
        bytes are the reserved memory the capture added (a private pool
        takes new segments)."""
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._registered())
        graph.capture_begin()
        try:
            out = body()
        finally:
            graph.capture_end()
        seconds = time.perf_counter() - t0
        launches = count_delta(launch_counts(), before)
        set_counts(before)
        self.captures.append({"graph": "/".join(map(str, key)), "seconds": seconds,
                              "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved})
        self._bound = self._addresses()
        return graph, out, launches

    def _launch(self, key, body):
        """``body``'s outputs: eagerly without capture; on the card its
        graph's replay, or at its first run the warm-up and the capture."""
        if key not in self.keys:
            self.keys.append(key)
        if not self.capture:
            return body()
        entry = self._graphs.get(key)
        if entry is not None:
            graph, out, launches = entry
            graph.replay()
            add_launches(launches)
            return out
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = body()  # the warm-up
            self._graphs[key] = self._capture(key, body)
        current.wait_stream(self.stream)
        return out

    def _take_state(self, state: Any) -> None:
        """``state``'s tensors copied into the static ones, its host values
        taken as they are."""
        if self.state is None:
            self.state = _clone(state)
            return
        static, given = _leaves(self.state), _leaves(state)
        if (_keys(self.state) != _keys(state) or len(static) != len(given)
                or any(s.shape != g.shape or s.dtype != g.dtype
                       for s, g in zip(static, given))):
            raise ValueError("the model state changed its structure between epochs")
        self.state = _refill(self.state, state)

    def run(self, state: Any, draws: torch.Generator) -> Tuple[Any, torch.Tensor]:
        """One epoch from ``state``, its words and then its masks drawn from
        ``draws`` (the trainer's generator on the graph's device) inside the
        graphs, as ``train.loop.train_epoch`` draws them. Returns (the
        static state, the mean loss as a device scalar)."""
        if draws.device.type != self.device.type:
            raise ValueError(f"the epoch draws on {self.device.type}: a generator on "
                             f"{draws.device.type} cannot feed it (the trainer's is on the "
                             f"graph's device)")
        self._take_state(state)
        self._draws = draws
        if self._graphs:
            bound = self._addresses()
            if bound[1] != self._bound[1]:
                raise ValueError("a float learning rate moved under a captured epoch: give the "
                                 "optimizer a tensor rate (train.loop.set_learning_rate)")
            if bound != self._bound:
                self.reset()  # a restored optimizer's state: capture again
        host = _host_values(self.state)
        if self.chunks is None:
            loss = self._launch(("epoch",) + host, self._epoch_body)
        else:
            if self.losses is None:
                self.losses = torch.empty(self.n_batches, dtype=torch.float32,
                                          device=self.device)
            self._launch(("sample",), self._sample_body)
            for start, size in self.chunks:
                if size not in self._inputs:
                    self._inputs[size] = [torch.empty((size,) + t.shape[1:], dtype=t.dtype,
                                                      device=self.device) for t in self.batches]
                for static, t in zip(self._inputs[size], self.batches):
                    static.copy_(t[start:start + size])
                out = self._launch(("chunk", size) + host,
                                   functools.partial(self._chunk_body, size))
                self.losses[start:start + size].copy_(out)
            loss = finite_mean(self.losses)
        return self.state, loss.clone()
