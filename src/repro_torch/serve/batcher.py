"""Request queue + shape-bucket micro-batcher.

One ``MicroBatcher`` per routing lane. Requests accumulate in arrival
order; ``drain`` releases a batch when either

  * enough requests are pending to fill the largest bucket (throughput
    regime: always launch full, maximally-shaped batches), or
  * the oldest pending request has waited ``max_wait_s`` (latency
    regime: launch a partially-filled batch padded up to the smallest
    bucket that holds it, so tail latency is bounded under low load).

Buckets are the *only* shapes that ever reach the compiled query
functions — the serving layer pads every drained batch up to its bucket
— so after one warmup pass per bucket no entry point sees a new batch
shape on the serving path.

The batcher is clock-driven (callers pass ``now``), which makes serving
runs deterministic and lets traces replay on a simulated clock; a
thread/asyncio front end only needs to call ``add``/``drain`` under its
own lock with wall-clock ``now``.

The port's copy of ``repro.serve.batcher`` (pure Python).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PendingRequest:
    """One enqueued query: request id + endpoints + arrival time."""
    rid: int
    s: int
    t: int
    t_arrival: float


@dataclasses.dataclass
class Batch:
    """A drained batch: the requests, the shape bucket they will be
    padded to, and the (possibly simulated) instant the flush fired."""
    requests: list
    bucket: int
    t_flush: float

    @property
    def fill(self) -> float:
        return len(self.requests) / self.bucket


class MicroBatcher:
    """Accumulates requests into fixed shape-bucket batches."""

    def __init__(self, buckets=(64, 256, 1024), max_wait_s: float = 0.002):
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.buckets = buckets
        self.max_wait_s = float(max_wait_s)
        self._pending: list[PendingRequest] = []

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, req: PendingRequest) -> None:
        self._pending.append(req)

    def next_deadline(self) -> float | None:
        """Instant at which the oldest pending request must flush."""
        if not self._pending:
            return None
        return self._pending[0].t_arrival + self.max_wait_s

    def _bucket_for(self, count: int) -> int:
        for b in self.buckets:
            if count <= b:
                return b
        return self.buckets[-1]

    def drain(self, now: float, force: bool = False) -> Batch | None:
        """Release the next ready batch, or None.

        Call in a loop until None — a deep queue can yield several
        largest-bucket batches per pump. ``force`` flushes whatever is
        pending (end of trace / shutdown).
        """
        p = len(self._pending)
        if p == 0:
            return None
        top = self.buckets[-1]
        if p >= top:
            reqs, self._pending = self._pending[:top], self._pending[top:]
            # the bucket filled the moment its last request arrived
            return Batch(reqs, top, max(now, reqs[-1].t_arrival))
        deadline = self._pending[0].t_arrival + self.max_wait_s
        if force or deadline <= now:
            reqs, self._pending = self._pending, []
            t_flush = now if force else deadline
            return Batch(reqs, self._bucket_for(p), t_flush)
        return None
