"""Span-based request tracing with a Chrome trace-event exporter.

The serving stack is clock-driven: queue waits live on
the trace's simulated clock while device execution is measured wall
time, charged as an interval starting at the flush instant. Spans here
therefore carry caller-supplied timestamps (seconds on the serving
timeline) rather than reading a wall clock, which keeps traces exactly
reproducible for replayed loadgen traces — and works unchanged for a
wall-clock front end that passes ``time.perf_counter()``.

Span model:

  request lane    request ── queue_wait ── device_exec
  path lane       request ── queue_wait ── tier:h<cap>* ── host_fallback?
  mutation lane   mutation ── flush_pending ── cow_apply ── swap_publish
                           ── retire

Every span has a ``trace_id`` (the request id for request-lifecycle
spans) and a ``span_id``; children carry ``parent_id``. ``chrome()``
exports the standard Chrome trace-event JSON (``traceEvents`` with
``ph: "X"`` complete events, microsecond timestamps) that
``chrome://tracing`` and https://ui.perfetto.dev open directly.

``NULL_TRACER`` is a no-op sink: call sites instrument unconditionally
and the disabled path costs one attribute lookup plus a no-op call.

The port's copy of ``repro.obs.trace`` (pure Python), and the
program's own spans and counters, which ``repro`` does not have:

  ``span(name)``          a ``torch.profiler.record_function`` range, so
                          it lands in the profiler's event list on the
                          device events' clock and every launch inside
                          it can be put down to it (``spanned(name)``
                          wraps a whole function in one)
  ``count(name, n)``      a host-known count, into ``REGISTRY``
  ``count_device(name, x)``  a count held in a device scalar: summed on
                          the device with no read, folded into
                          ``REGISTRY`` by one read when the block closes
  ``program_spans()``     turns the three on for a block

Off (the default), ``span`` is one test of a module global that returns
a shared no-op context manager, and the counts return at once: nothing
calls the profiler, allocates or launches. Span and counter names are
dotted by layer (``query.relax``, ``build.dedup_live``); PERF.md lists
them with the metric that reads each.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from pathlib import Path

from repro_torch.obs.registry import REGISTRY

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "count",
           "count_device", "program_spans", "span", "spanned", "spans_on"]


@dataclasses.dataclass
class Span:
    name: str
    cat: str
    t0: float                    # seconds on the serving timeline
    span_id: int
    trace_id: int = 0
    parent_id: int | None = None
    t1: float | None = None      # None while open
    track: str | None = None     # Chrome "thread" row; defaults to cat
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    @property
    def open(self) -> bool:
        return self.t1 is None


class Tracer:
    """Collects spans and instant events on a shared timeline."""

    enabled = True

    def __init__(self, process: str = "repro.serve"):
        self.process = process
        self.spans: list[Span] = []
        self.events: list[dict] = []
        self._next_id = 1

    # ------------------------------------------------------------ record
    def start(self, name: str, now: float, *, cat: str = "serve",
              trace_id: int = 0, parent: Span | None = None,
              track: str | None = None, **args) -> Span:
        span = Span(name=name, cat=cat, t0=float(now),
                    span_id=self._next_id, trace_id=int(trace_id),
                    parent_id=None if parent is None else parent.span_id,
                    track=track, args=args)
        self._next_id += 1
        self.spans.append(span)
        return span

    def end(self, span: Span, now: float, **args) -> Span:
        if span.t1 is not None:
            raise ValueError(f"span {span.name!r} already ended")
        if float(now) < span.t0:
            raise ValueError(f"span {span.name!r} ends at {now} before "
                             f"its start {span.t0}")
        span.t1 = float(now)
        span.args.update(args)
        return span

    def add(self, name: str, t0: float, t1: float, *, cat: str = "serve",
            trace_id: int = 0, parent: Span | None = None,
            track: str | None = None, **args) -> Span:
        """Record an already-measured interval in one call."""
        span = self.start(name, t0, cat=cat, trace_id=trace_id,
                          parent=parent, track=track, **args)
        return self.end(span, t1)

    def event(self, name: str, now: float, *, cat: str = "serve",
              trace_id: int = 0, track: str | None = None, **args) -> None:
        """Instant event (Chrome ``ph: "i"``)."""
        self.events.append({"name": name, "cat": cat, "ts": float(now),
                            "trace_id": int(trace_id), "track": track,
                            "args": args})

    # ----------------------------------------------------------- queries
    def finished(self) -> list[Span]:
        return [s for s in self.spans if s.t1 is not None]

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def request_coverage(self) -> dict:
        """Fraction of each request span covered by its child spans —
        the acceptance probe: children must account for (almost) all of
        the request's measured wall time. Returns summary stats."""
        fracs = []
        for s in self.finished():
            if s.cat != "request" or s.duration <= 0:
                continue
            covered = sum(c.duration for c in self.children(s)
                          if c.t1 is not None)
            fracs.append(min(covered / s.duration, 1.0))
        if not fracs:
            return {"requests": 0, "min": 0.0, "mean": 0.0}
        return {"requests": len(fracs), "min": min(fracs),
                "mean": sum(fracs) / len(fracs)}

    # ------------------------------------------------------------ export
    def chrome(self) -> dict:
        """Chrome trace-event JSON object format (Perfetto-loadable)."""
        tracks = {}

        def tid(track: str) -> int:
            return tracks.setdefault(track, len(tracks) + 1)

        ev = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
               "args": {"name": self.process}}]
        for s in self.spans:
            if s.t1 is None:
                continue
            ev.append({
                "ph": "X", "pid": 1, "tid": tid(s.track or s.cat),
                "name": s.name, "cat": s.cat,
                "ts": s.t0 * 1e6, "dur": s.duration * 1e6,
                "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                         **({"parent_id": s.parent_id}
                            if s.parent_id is not None else {}),
                         **s.args},
            })
        for e in self.events:
            ev.append({
                "ph": "i", "pid": 1, "tid": tid(e["track"] or e["cat"]),
                "name": e["name"], "cat": e["cat"], "ts": e["ts"] * 1e6,
                "s": "t",
                "args": {"trace_id": e["trace_id"], **e["args"]},
            })
        for track, t in sorted(tracks.items(), key=lambda kv: kv[1]):
            ev.append({"ph": "M", "pid": 1, "tid": t, "name": "thread_name",
                       "args": {"name": track}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def write_chrome(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome()) + "\n")
        return p


class NullTracer(Tracer):
    """No-op sink for the uninstrumented hot path."""

    enabled = False

    def __init__(self):
        super().__init__()

    def start(self, name, now, **kw):
        return _NULL_SPAN

    def end(self, span, now, **args):
        return _NULL_SPAN

    def add(self, name, t0, t1, **kw):
        return _NULL_SPAN

    def event(self, name, now, **kw):
        return None


_NULL_SPAN = Span(name="", cat="", t0=0.0, span_id=0, t1=0.0)
NULL_TRACER = NullTracer()


# ------------------------------------------------ program spans, counters
_ON = False
_DEPTH = 0
_PENDING: dict = {}     # (name, device) -> int64 device accumulator


class _Off:
    """The shared no-op context manager of a span while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def spans_on() -> bool:
    return _ON


def span(name: str):
    """A ``record_function`` range named ``name`` while program spans
    are on; otherwise the shared no-op."""
    if not _ON:
        return _OFF
    from torch.profiler import record_function
    return record_function(name)


def spanned(name: str):
    """Decorator: run the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


def count(name: str, amount=1) -> None:
    """Add a host-known ``amount`` to the counter ``name`` while program
    spans are on."""
    if _ON:
        REGISTRY.counter(name).inc(amount)


def count_device(name: str, value) -> None:
    """Add the integer device scalar ``value`` to the counter ``name``
    while program spans are on: summed where it lies, with no read,
    until the outermost ``program_spans`` block closes."""
    if not _ON:
        return
    key = (name, value.device)
    acc = _PENDING.get(key)
    if acc is None:
        import torch
        _PENDING[key] = value.to(torch.int64, copy=True)
    else:
        acc.add_(value)


def _fold() -> None:
    """Read every pending device count (one read a device, not counted
    by ``core.sync``) into ``REGISTRY``."""
    import torch
    pending = dict(_PENDING)
    _PENDING.clear()
    by_device: dict = {}
    for (name, dev), acc in pending.items():
        by_device.setdefault(dev, []).append((name, acc))
    for dev, items in by_device.items():
        stacked = torch.stack([acc for _, acc in items])
        if dev.type == "cuda":
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                values = stacked.cpu().tolist()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        else:
            values = stacked.tolist()
        for (name, _), v in zip(items, values):
            REGISTRY.counter(name).inc(int(v))


@contextlib.contextmanager
def program_spans():
    """Turn the program's spans and counters on for the block. Blocks
    nest; the outermost one folds the device counts into ``REGISTRY``
    when it closes."""
    global _ON, _DEPTH
    _DEPTH += 1
    _ON = True
    try:
        yield
    finally:
        _DEPTH -= 1
        if _DEPTH == 0:
            _ON = False
            _fold()
