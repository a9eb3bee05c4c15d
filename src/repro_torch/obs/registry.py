"""Process-wide metric registry: counters, gauges, fixed-bucket
histograms, all supporting labeled series. The port's copy of
``repro.obs.registry`` (numpy only; the port imports nothing of
``repro``), with the same metric names, so a series reads the same in
either package.

One registry instance (the module-level ``REGISTRY`` by default) is
shared by every component that reports through it; in the port the
path engine (``path.batches`` per hop_cap tier), the serving metrics
(``serve.*``) and the first-use builds of ``obs.profiler``. A single
``snapshot()`` captures the whole process.

Naming scheme: dotted ``<component>.<metric>`` names (``serve.served``,
``versions.swaps``, ``fault.retries``); unit suffixes where the value is
not a plain count (``_seconds``, ``_bytes``, ``_ratio``). Series within
a metric are keyed by their sorted ``(label, value)`` items, so
``counter.inc(server="g", lane="mu")`` and a later
``inc(lane="mu", server="g")`` hit the same series.

Histograms keep the fixed cumulative-bucket counts *and* (by default)
the raw observations, so percentile export stays exactly the numpy
quantile of what was observed — bucket interpolation is only used once
a series overflows ``raw_cap`` (set ``raw_cap=0`` to never retain).
"""
from __future__ import annotations

import contextlib
import json
import re
import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry", "REGISTRY",
           "default_latency_buckets"]


def default_latency_buckets() -> tuple:
    """Seconds-scale log buckets: 100µs .. ~100s, 4 per decade."""
    return tuple(float(f"{10 ** (e / 4):.3g}") * 1e-4
                 for e in range(0, 25))


def _key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    """Shared labeled-series plumbing. Subclasses define the per-series
    state (``_new_series``) and its snapshot form."""

    kind = "metric"

    def __init__(self, name: str, help: str = "", registry=None):
        self.name = name
        self.help = help
        self._series: dict = {}
        self._lock = threading.Lock()

    def _get(self, labels: dict):
        k = _key(labels)
        s = self._series.get(k)
        if s is None:
            with self._lock:
                s = self._series.setdefault(k, self._new_series())
        return s

    def labels_seen(self) -> list:
        return [dict(k) for k in self._series]

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "help": self.help,
            "series": [{"labels": dict(k), **self._series_snapshot(s)}
                       for k, s in sorted(self._series.items())],
        }


class Counter(_Metric):
    """Monotonic float counter."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._get(labels)[0] += amount

    def value(self, **labels) -> float:
        return self._get(labels)[0]

    def total(self) -> float:
        return sum(s[0] for s in self._series.values())

    def _series_snapshot(self, s) -> dict:
        return {"value": s[0]}


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        self._get(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._get(labels)[0] += amount

    def value(self, **labels) -> float:
        return self._get(labels)[0]

    def _series_snapshot(self, s) -> dict:
        return {"value": s[0]}


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "raw")

    def __init__(self, n_buckets: int):
        self.counts = np.zeros(n_buckets + 1, np.int64)  # +overflow
        self.sum = 0.0
        self.count = 0
        self.raw: list | None = []


class Histogram(_Metric):
    """Fixed-bucket histogram with exact-percentile raw retention.

    ``buckets`` are the (sorted, strictly increasing) upper bounds;
    observation ``v`` lands in the first bucket with ``v <= bound``,
    past the last bound in the overflow bucket. ``quantile`` returns
    the numpy linear-interpolation quantile over the retained raw
    values; once ``raw_cap`` is exceeded the series drops its raw list
    and quantiles fall back to within-bucket linear interpolation.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=None,
                 raw_cap: int = 1 << 20, registry=None):
        super().__init__(name, help)
        b = tuple(float(x) for x in (buckets if buckets is not None
                                     else default_latency_buckets()))
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram {name}: buckets must be sorted "
                             f"strictly increasing, got {b!r}")
        if not b:
            raise ValueError(f"histogram {name}: need at least one bucket")
        self.buckets = b
        self.raw_cap = int(raw_cap)
        self._bounds = np.asarray(b, np.float64)

    def _new_series(self):
        return _HistSeries(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        s = self._get(labels)
        v = float(value)
        s.counts[int(np.searchsorted(self._bounds, v, side="left"))] += 1
        s.sum += v
        s.count += 1
        if s.raw is not None:
            if len(s.raw) < self.raw_cap:
                s.raw.append(v)
            else:
                s.raw = None          # overflow: bucket estimates only

    def values(self, **labels) -> list:
        """The retained raw observations (empty once dropped)."""
        s = self._get(labels)
        return list(s.raw) if s.raw is not None else []

    def count(self, **labels) -> int:
        return self._get(labels).count

    def sum(self, **labels) -> float:
        return self._get(labels).sum

    def mean(self, **labels) -> float:
        s = self._get(labels)
        return s.sum / s.count if s.count else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Exact (numpy ``quantile``) while raw values are retained,
        within-bucket linear interpolation afterwards."""
        s = self._get(labels)
        if s.count == 0:
            return 0.0
        if s.raw is not None:
            return float(np.quantile(np.asarray(s.raw, np.float64), q))
        rank = q * (s.count - 1)
        cum = np.cumsum(s.counts)
        i = int(np.searchsorted(cum, rank + 1))
        lo = 0.0 if i == 0 else self.buckets[i - 1]
        hi = self.buckets[min(i, len(self.buckets) - 1)]
        prev = 0 if i == 0 else int(cum[i - 1])
        width = max(int(s.counts[i]), 1)
        return lo + (hi - lo) * min((rank + 1 - prev) / width, 1.0)

    def max(self, **labels) -> float:
        s = self._get(labels)
        if s.count == 0:
            return 0.0
        if s.raw is not None:
            return float(np.max(s.raw))
        top = int(np.flatnonzero(s.counts)[-1])
        return self.buckets[min(top, len(self.buckets) - 1)]

    def count_le(self, bound: float, **labels) -> int:
        """Observations with value <= ``bound`` — exact while raw values
        are retained; after raw overflow, the cumulative count of every
        bucket whose upper bound is <= ``bound`` (an underestimate when
        ``bound`` falls inside a bucket). The SLO latency source reads
        good-event counts through this."""
        s = self._get(labels)
        if s.count == 0:
            return 0
        if s.raw is not None:
            return int(np.count_nonzero(
                np.asarray(s.raw, np.float64) <= float(bound)))
        i = int(np.searchsorted(self._bounds, float(bound), side="right"))
        return int(s.counts[:i].sum())

    def _series_snapshot(self, s) -> dict:
        return {
            "count": int(s.count),
            "sum": float(s.sum),
            "buckets": {str(b): int(c)
                        for b, c in zip(self.buckets, s.counts)},
            "overflow": int(s.counts[-1]),
        }


class MetricRegistry:
    """Name → metric map. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent; conflicting re-registration raises), so
    call sites simply ask for the metric where they use it."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name, help, **kw))
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=None,
                  raw_cap: int = 1 << 20) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets,
                              raw_cap=raw_cap)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list:
        return sorted(self._metrics)

    def clear(self) -> None:
        self._metrics.clear()

    def snapshot(self, prefix: str = "") -> dict:
        """{name: metric snapshot} for every metric under ``prefix``."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())
                if name.startswith(prefix)}

    def section(self, prefix: str) -> dict:
        """Flat {name: value} view of one component's scalar series —
        counters/gauges only, labels folded into the key — the compact
        form ``DistanceServer.stats()`` embeds."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            if not name.startswith(prefix) or m.kind == "histogram":
                continue
            for k, s in sorted(m._series.items()):
                tag = ",".join(f"{lk}={lv}" for lk, lv in k)
                out[f"{name}{{{tag}}}" if tag else name] = s[0]
        return out

    def to_json(self, prefix: str = "", **extra) -> str:
        return json.dumps({"metrics": self.snapshot(prefix), **extra},
                          indent=2, sort_keys=True)

    # ------------------------------------------------ test isolation
    def reset(self) -> None:
        """Drop every registered metric. Components holding direct
        metric references keep recording into their (now detached)
        objects; fresh ``counter``/``gauge``/``histogram`` calls start
        clean — the between-tests isolation point (tests construct
        their servers after the reset)."""
        with self._lock:
            self._metrics = {}

    @contextlib.contextmanager
    def isolated(self):
        """Run a block against an empty metric map, restoring the
        previous one afterwards. Because call sites import the module-
        level ``REGISTRY`` object (never a copy), swapping its internal
        map is enough: nothing recorded inside the block leaks out, and
        nothing from outside is visible inside."""
        with self._lock:
            saved, self._metrics = self._metrics, {}
        try:
            yield self
        finally:
            with self._lock:
                self._metrics = saved

    # ------------------------------------------- Prometheus exposition
    def render_prometheus(self, prefix: str = "") -> str:
        """Prometheus text exposition (format version 0.0.4) of every
        metric under ``prefix`` — the front end's ``/metrics`` body.

        Rules (so real Prometheus scrapers and the round-trip parser in
        tests both accept the output): metric names are sanitized to
        ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots become underscores), labels
        are emitted in sorted-key order, label values escape ``\\``,
        ``\"`` and newlines, HELP text escapes ``\\`` and newlines, and
        histograms expose cumulative ``_bucket{le=...}`` series ending
        in ``le="+Inf"`` plus ``_sum`` and ``_count``.
        """
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            if not name.startswith(prefix):
                continue
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {_prom_escape_help(m.help)}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for key, s in sorted(m._series.items()):
                labels = dict(key)
                if m.kind == "histogram":
                    cum = 0
                    for bound, cnt in zip(m.buckets, s.counts):
                        cum += int(cnt)
                        lines.append(_prom_line(
                            pname + "_bucket",
                            {**labels, "le": _prom_float(bound)}, cum))
                    lines.append(_prom_line(
                        pname + "_bucket", {**labels, "le": "+Inf"},
                        int(s.count)))
                    lines.append(_prom_line(pname + "_sum", labels, s.sum))
                    lines.append(_prom_line(pname + "_count", labels,
                                            int(s.count)))
                else:
                    lines.append(_prom_line(pname, labels, s[0]))
        return "\n".join(lines) + ("\n" if lines else "")


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _prom_escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom_escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _prom_float(v: float) -> str:
    """Shortest exact decimal for a bucket bound / sample value."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f)) + ".0"
    return repr(f)


def _prom_line(name: str, labels: dict, value) -> str:
    lbl = ",".join(f'{k}="{_prom_escape_label(v)}"'
                   for k, v in sorted(labels.items()))
    val = (_prom_float(value) if isinstance(value, float)
           else str(int(value)))
    return f"{name}{{{lbl}}} {val}" if lbl else f"{name} {val}"


# The process-wide default registry every component reports through.
REGISTRY = MetricRegistry()
