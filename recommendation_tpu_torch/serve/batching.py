"""Request micro-batching for the serving path (a copy of
``recommendation_tpu/serve/batching.py``).

Concurrent HTTP handler threads enqueue queries; a single dispatcher thread
drains the queue every ``max_wait_ms`` (or as soon as ``max_batch`` users
are pending) and answers the whole wave with ONE device MIPS top-k call.
This is the production-serving pattern for accelerator-backed retrieval:
the device runs one batched program per tick instead of N contending
single-row programs, so tail latency stays flat under concurrency and
throughput scales with the device's batch efficiency rather than the
request count. (The reference has no serving at all — north-star component,
DESIGN.md §8.)
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Sequence


class BatcherClosed(RuntimeError):
    """Raised when a request races a MicroBatcher shutdown. Deliberately a
    DEDICATED type: device errors (torch raises RuntimeError for CUDA
    failures) must propagate, not be retried unbatched."""


@dataclass
class _Pending:
    user_ids: List[int]
    k: int
    exclude_seen: bool
    future: Future = field(default_factory=Future)


class MicroBatcher:
    """Coalesces ``recommend_ids`` calls onto a dispatcher thread.

    ``submit`` is thread-safe and returns a Future resolving to
    (scores[B, k], ids[B, k]) for the submitted users. Requests with
    different (k, exclude_seen) are grouped per tick — each group costs one
    device call.
    """

    def __init__(self, service, max_batch: int = 1024, max_wait_ms: float = 2.0):
        self.service = service
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.stats: Dict[str, int] = {"requests": 0, "device_calls": 0, "users": 0}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, user_ids: Sequence[int], k: int, exclude_seen: bool = True) -> Future:
        if self._stop.is_set():
            raise BatcherClosed("MicroBatcher is closed")
        p = _Pending(list(user_ids), int(k), bool(exclude_seen))
        self._queue.put(p)
        # close() may have drained the queue between the stop check and the
        # put (TOCTOU); re-check AFTER enqueueing so the pending can never be
        # stranded — either the dispatcher is alive and will consume it, or
        # we fail it here ourselves (set_exception is guarded: the drain in
        # close() may have failed it already)
        if self._stop.is_set() and not p.future.done():
            try:
                p.future.set_exception(BatcherClosed("MicroBatcher is closed"))
            except Exception:  # already resolved by the drain — fine
                pass
        return p.future

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # fail any requests that raced into the queue after shutdown
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if not p.future.done():
                p.future.set_exception(BatcherClosed("MicroBatcher closed"))

    # -- dispatcher -----------------------------------------------------------

    def _drain_wave(self) -> List[_Pending]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        wave = [first]
        deadline = time.monotonic() + self.max_wait
        users = len(first.user_ids)
        while users < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            wave.append(nxt)
            users += len(nxt.user_ids)
        return wave

    def _run(self):
        while not self._stop.is_set():
            wave: List[_Pending] = []
            try:
                wave = self._drain_wave()
                if not wave:
                    continue
                self._serve_wave(wave)
            except Exception as e:
                # A failure outside the per-group guard (drain / grouping /
                # result slicing) must not kill the dispatcher silently —
                # that would strand every later submit() on its 60 s future
                # timeout with no BatcherClosed fallback. Fail this wave's
                # futures and keep serving.
                for p in wave:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _serve_wave(self, wave: List[_Pending]):
        # stats are only touched on this thread — no lock needed
        self.stats["requests"] += len(wave)
        groups: Dict[tuple, List[_Pending]] = {}
        for p in wave:
            groups.setdefault((p.k, p.exclude_seen), []).append(p)
        for (k, excl), members in groups.items():
            flat: List[int] = []
            for p in members:
                flat.extend(p.user_ids)
            try:
                scores, ids = self.service._recommend_ids_device(flat, k, excl)
                self.stats["device_calls"] += 1
                self.stats["users"] += len(flat)
                off = 0
                for p in members:
                    n = len(p.user_ids)
                    p.future.set_result((scores[off:off + n], ids[off:off + n]))
                    off += n
            except Exception as e:  # propagate to every waiter in the group
                for p in members:
                    if not p.future.done():
                        p.future.set_exception(e)
