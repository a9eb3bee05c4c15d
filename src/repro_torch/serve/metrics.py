"""Serving metrics: QPS, latency percentiles, batch fill, cache hits,
relaxation rounds — with JSON export so benchmark runs accumulate a
machine-readable perf trajectory (``BENCH_serving.json``).

Since the observability layer landed, ``ServeMetrics`` is a per-server
*view* over the process-wide metric registry (``repro_torch.obs.REGISTRY``): every observation is recorded as a labeled
series (``server=<name>, sid=<instance>``) on shared ``serve.*``
counters/histograms, ``snapshot()`` reads those series back, and a
single ``repro_torch.obs.write_metrics`` dump therefore carries every
server's series next to the versions/shard/path/fault metrics. The
``sid`` label keeps instances isolated — two servers over the same
graph name never alias each other's series.

Latency accounting: a request's latency is queue wait (flush instant −
arrival, on the trace's clock) plus the measured wall-clock execution
time of the batch that served it. Cache hits have zero latency. QPS is
reported two ways: ``qps_compute`` (device-path requests / summed
device execution time — what the hardware sustains; cache hits are
excluded from the numerator since they consume no device time) and
``qps_offered`` (all served requests / trace span — what the scenario
asked for).

The port's copy of ``repro.serve.metrics`` (numpy only), with the
same series names.
"""
from __future__ import annotations

import dataclasses
import itertools
import json

import numpy as np

from repro_torch.obs.registry import REGISTRY

# Lanes that always appear in the per-lane report, even when idle.
# Observed lanes are unioned in (snapshot derives the set from the
# recorded BatchRecords), so a new lane's batches are never dropped.
KNOWN_LANES = ("mu", "full", "path")


@dataclasses.dataclass
class BatchRecord:
    lane: str          # "mu" | "full" | "path" | any future lane
    bucket: int
    n_real: int
    exec_s: float
    rounds: int

    @property
    def fill(self) -> float:
        return self.n_real / self.bucket


class ServeMetrics:
    """Accumulates per-request and per-batch observations into the
    registry; keeps the raw ``BatchRecord`` list for the per-lane and
    per-bucket breakdowns."""

    _sid = itertools.count()

    def __init__(self, server: str = "default", registry=None):
        self.server = server
        self.registry = registry if registry is not None else REGISTRY
        # per-instance series isolation within the shared registry
        self._lbl = {"server": server, "sid": str(next(ServeMetrics._sid))}
        r = self.registry
        self._served = r.counter("serve.served", "requests answered")
        self._batches = r.counter("serve.batches", "device batches run")
        self._exec_seconds = r.counter(
            "serve.exec_seconds", "summed device batch execution time")
        self._cache_hits = r.counter("serve.cache_hits", "LRU cache hits")
        self._path_overflows = r.counter(
            "serve.path_overflows", "path-lane hop_cap tier escalations")
        self._mutations = r.counter(
            "serve.mutations", "applied §8.3 write batches (version swaps)")
        self._mutation_ops = r.counter(
            "serve.mutation_ops", "individual insert/delete ops")
        self._types = r.counter(
            "serve.query_types", "paper §5.2 endpoint classes served")
        self._latency = r.histogram(
            "serve.latency_seconds", "request latency (wait + exec)")
        self._swap = r.histogram(
            "serve.swap_seconds", "COW apply + hot-swap wall time")
        self._span = r.gauge(
            "serve.trace_span_seconds", "summed replayed trace spans")
        self.batches: list[BatchRecord] = []

    # ---------------------------------------------- registry-view props
    @property
    def served(self) -> int:
        return int(self._served.value(**self._lbl))

    @property
    def cache_hits(self) -> int:
        return int(self._cache_hits.value(**self._lbl))

    @property
    def path_overflows(self) -> int:
        return int(self._path_overflows.value(**self._lbl))

    @property
    def mutations(self) -> int:
        return int(self._mutations.value(**self._lbl))

    @property
    def mutation_ops(self) -> int:
        return int(self._mutation_ops.value(**self._lbl))

    @property
    def latencies(self) -> list:
        return self._latency.values(**self._lbl)

    @property
    def swap_seconds(self) -> list:
        return self._swap.values(**self._lbl)

    @property
    def type_counts(self) -> dict:
        out = {c: 0 for c in (1, 2, 3)}
        for labels in self._types.labels_seen():
            if all(labels.get(k) == v for k, v in self._lbl.items()):
                out[int(labels["cls"])] = int(self._types.value(**labels))
        return out

    @property
    def trace_span_s(self) -> float:
        return self._span.value(**self._lbl)

    @trace_span_s.setter
    def trace_span_s(self, value: float) -> None:
        self._span.set(float(value), **self._lbl)

    # ------------------------------------------------------------ record
    def record_batch(self, lane: str, bucket: int, n_real: int,
                     exec_s: float, rounds: int) -> None:
        self.batches.append(BatchRecord(lane, bucket, n_real, exec_s,
                                        rounds))
        self._batches.inc(1, lane=lane, **self._lbl)
        self._exec_seconds.inc(float(exec_s), lane=lane, **self._lbl)
        self._served.inc(n_real, **self._lbl)

    def record_latency(self, seconds: float) -> None:
        self._latency.observe(float(seconds), **self._lbl)

    def record_cache_hit(self) -> None:
        self._cache_hits.inc(1, **self._lbl)
        self._served.inc(1, **self._lbl)
        self._latency.observe(0.0, **self._lbl)

    def record_path_overflow(self) -> None:
        self._path_overflows.inc(1, **self._lbl)

    def record_mutation(self, n_ops: int, swap_s: float) -> None:
        """One applied §8.3 write batch: ``n_ops`` insert/delete ops,
        ``swap_s`` = copy-on-write apply + hot-swap wall time."""
        self._mutations.inc(1, **self._lbl)
        self._mutation_ops.inc(int(n_ops), **self._lbl)
        self._swap.observe(float(swap_s), **self._lbl)

    def record_types(self, classes) -> None:
        for c, cnt in zip(*np.unique(np.asarray(classes),
                                     return_counts=True)):
            self._types.inc(int(cnt), cls=str(int(c)), **self._lbl)

    # ----------------------------------------------------------- export
    def snapshot(self) -> dict:
        lat = self._latency
        sw = self._swap
        lbl = self._lbl
        exec_total = sum(b.exec_s for b in self.batches)
        # per-lane breakdown over the lanes actually observed (plus the
        # standing ones) — a new lane shows up instead of vanishing
        lanes = {}
        for lane in sorted(set(KNOWN_LANES)
                           | {b.lane for b in self.batches}):
            bs = [b for b in self.batches if b.lane == lane]
            lanes[lane] = {
                "batches": len(bs),
                "requests": sum(b.n_real for b in bs),
                "fill_ratio": (float(np.mean([b.fill for b in bs]))
                               if bs else 0.0),
                "rounds_per_batch": (float(np.mean([b.rounds for b in bs]))
                                     if bs else 0.0),
            }
        total = self.served
        batch_served = sum(b.n_real for b in self.batches)
        bucket_counts: dict[str, int] = {}
        for b in self.batches:
            bucket_counts[str(b.bucket)] = bucket_counts.get(str(b.bucket),
                                                             0) + 1
        has_lat = lat.count(**lbl) > 0
        has_sw = sw.count(**lbl) > 0
        return {
            "served": total,
            "batches": len(self.batches),
            "cache_hits": self.cache_hits,
            "cache_hit_rate": self.cache_hits / total if total else 0.0,
            "path_overflows": self.path_overflows,
            # device-path requests only: cache hits consume no device
            # time and must not inflate the hardware-throughput figure
            "qps_compute": batch_served / exec_total if exec_total else 0.0,
            "qps_offered": (total / self.trace_span_s
                            if self.trace_span_s else 0.0),
            "latency_ms": {
                "p50": lat.quantile(0.50, **lbl) * 1e3 if has_lat else 0.0,
                "p95": lat.quantile(0.95, **lbl) * 1e3 if has_lat else 0.0,
                "p99": lat.quantile(0.99, **lbl) * 1e3 if has_lat else 0.0,
                "mean": lat.mean(**lbl) * 1e3 if has_lat else 0.0,
            },
            "batch_fill_ratio": (float(np.mean([b.fill
                                                for b in self.batches]))
                                 if self.batches else 0.0),
            "bucket_counts": bucket_counts,
            "lanes": lanes,
            "query_types": {str(k): v for k, v in self.type_counts.items()},
            "mutations": self.mutations,
            "mutation_ops": self.mutation_ops,
            "swap_ms": {
                "p50": sw.quantile(0.50, **lbl) * 1e3 if has_sw else 0.0,
                "p95": sw.quantile(0.95, **lbl) * 1e3 if has_sw else 0.0,
                "max": sw.max(**lbl) * 1e3 if has_sw else 0.0,
                "mean": sw.mean(**lbl) * 1e3 if has_sw else 0.0,
            },
        }

    def to_json(self, **extra) -> str:
        return json.dumps({**self.snapshot(), **extra}, indent=2,
                          sort_keys=True)
