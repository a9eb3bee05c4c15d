"""Replica groups: N ``DistanceServer`` replicas over one index with
straggler-health observability — the port's copy of
``repro.serve.replicas``.

A ``ReplicaSet`` duck-types the server API the front end and the
``IndexRegistry`` drive (``submit``/``pump``/``take_result``/``route``/
``serve_trace``/``stats``/``drain``), dispatching each request to one
replica round-robin. Every replica runs the same pre-warmed entry
points over the same index (they are memoized per (engine, backend), so
N replicas share one engine, one set of entry points and, on the card,
the same kernels; answers are bitwise identical whichever replica
serves them — replication changes *timing*, never *values*). The index
may be a ``ShardedIndex``.

Health: after every pump, each replica's new per-batch execution times
feed the ``repro_torch.fault`` straggler machinery — one ``StragglerMonitor``
per replica under a ``HostTimingAggregator`` fleet view. The two
detectors are complementary: the per-replica EMA flags *degradation
onset* (a replica that was fast and got slow), the fleet-median
comparison catches *steady-state outliers* (a replica slow from its
first batch, whose own EMA never saw a fast baseline). Eviction is
keyed on the fleet view — ``evict_after`` consecutive health rounds
above ``fleet_threshold`` × the fleet-median EMA removes the replica
from the dispatch rotation (in-flight work still completes; dispatch
just stops choosing it) — recorded by the ``serve.replica_evictions``
counter and per-replica ``serve.replica_healthy`` gauge next to the
``fault.*`` series from stragglers.py.

Determinism: fed timings are clamped below at ``min_step_s`` — µs-scale
batch wall times on an idle graph are indistinguishable scheduler noise
and would otherwise produce flaky ratios. Above the floor (real fleets,
injected stalls) the clamp is a no-op. With the floor, a clean run
feeds identical values for every replica, so the fleet comparison is
exactly quiet; a 2-replica fleet's median is the mean of both EMAs,
bounding any outlier's ratio below 2.0 — hence the default
``fleet_threshold`` of 1.5, not the aggregator's whole-fleet 1.3.

Failure injection: ``set_stall(replica, stall_s)`` charges a synthetic
stall to every distance batch the replica executes
(``DistanceServer.exec_delay_s`` — accounting-only, no real sleep), and
``apply_injection(meta)`` wires a ``straggler`` loadgen scenario's
``meta["inject"]`` plan. The injected replica's latencies and straggler
flags degrade deterministically on the serving clock while answers stay
bitwise exact — the clean/degraded pair the SLO burn-rate tests gate.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fault.stragglers import (HostTimingAggregator,
                                         StragglerMonitor)
from repro_torch.obs.registry import REGISTRY
from repro_torch.serve.engine import DistanceServer

__all__ = ["ReplicaSet"]


class ReplicaSet:
    """Round-robin dispatch over N bitwise-identical replicas."""

    def __init__(self, index, n_replicas: int = 2, *, name: str = "default",
                 straggler_threshold: float = 4.0, evict_after: int = 5,
                 fleet_threshold: float = 1.5, min_step_s: float = 0.01,
                 registry=None, **server_kwargs):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.name = name
        self.registry = registry if registry is not None else REGISTRY
        self.replicas = [
            DistanceServer(index, name=f"{name}/r{i}",
                           registry=self.registry, **server_kwargs)
            for i in range(n_replicas)
        ]
        self.index = self.replicas[0].index
        self.versions = None          # replica groups are read-only
        self.evict_after = int(evict_after)
        self.min_step_s = float(min_step_s)
        self.aggregator = HostTimingAggregator(threshold=fleet_threshold)
        for i, srv in enumerate(self.replicas):
            self.aggregator.hosts[srv.name] = StragglerMonitor(
                host=srv.name, threshold=straggler_threshold,
                evict_after=evict_after)
        self.healthy = [True] * n_replicas
        self._rr = 0
        self._owner: dict[int, int] = {}      # rid -> replica idx
        self._batches_seen = [0] * n_replicas
        self._fleet_streak = [0] * n_replicas
        r = self.registry
        self._evictions = r.counter(
            "serve.replica_evictions",
            "replicas removed from dispatch after straggler streaks")
        self._healthy_g = r.gauge(
            "serve.replica_healthy", "1 while the replica is in rotation")
        self._straggler_g = r.gauge(
            "serve.replica_straggler",
            "1 while the replica's last batch was flagged")
        for srv in self.replicas:
            self._healthy_g.set(1.0, replica=srv.name)
            self._straggler_g.set(0.0, replica=srv.name)

    # -------------------------------------------------------- properties
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def server_names(self) -> list:
        return [srv.name for srv in self.replicas]

    @property
    def buckets(self):
        return self.replicas[0].buckets

    @property
    def metrics(self):
        """Primary replica's metrics view (per-replica views live on
        each ``replicas[i].metrics``)."""
        return self.replicas[0].metrics

    # -------------------------------------------------- fault injection
    def set_stall(self, replica: int, stall_s: float) -> None:
        """Charge ``stall_s`` of synthetic stall to every distance
        batch replica ``replica`` executes from now on."""
        self.replicas[replica].exec_delay_s = float(stall_s)

    def apply_injection(self, meta: dict) -> None:
        """Wire a loadgen ``straggler`` scenario's injection plan."""
        inject = (meta or {}).get("inject")
        if inject:
            self.set_stall(int(inject["replica"]),
                           float(inject["stall_s"]))

    # ------------------------------------------------------ request path
    def _pick(self) -> int:
        n = len(self.replicas)
        for _ in range(n):
            i = self._rr % n
            self._rr += 1
            if self.healthy[i]:
                return i
        return self._rr % n           # all evicted: degrade, keep serving

    def submit(self, s: int, t: int, now: float,
               lane: str | None = None) -> int:
        i = self._pick()
        rid = self.replicas[i].submit(s, t, now, lane=lane)
        key = self._key(i, rid)
        self._owner[key] = i
        return key

    def take_result(self, rid: int):
        # keep the rid -> replica mapping until the result actually
        # lands: callers poll take_result before the batch flushes
        i = self._owner.get(rid)
        if i is None:
            return None
        val = self.replicas[i].take_result(self._unkey(rid))
        if val is not None:
            del self._owner[rid]
        return val

    def route(self, s, t):
        return self.replicas[0].route(s, t)

    def pump(self, now: float, force: bool = False) -> int:
        done = 0
        for srv in self.replicas:
            done += srv.pump(now, force=force)
        self._collect_timings()
        return done

    def drain(self, now: float | None = None) -> int:
        done = 0
        for srv in self.replicas:
            done += srv.drain(now)
        self._collect_timings()
        return done

    def _key(self, i: int, rid: int) -> int:
        # per-replica rid spaces interleaved into one global space
        return rid * len(self.replicas) + i

    def _unkey(self, key: int) -> int:
        return key // len(self.replicas)

    # ----------------------------------------------------- health intake
    def _collect_timings(self) -> None:
        """One health round: feed every replica's new per-batch
        execution times (floored at ``min_step_s``) into its straggler
        monitor, then compare EMAs against the fleet median. A replica
        above ``fleet_threshold`` × median for ``evict_after``
        consecutive rounds-with-data is evicted from rotation."""
        fed = False
        for i, srv in enumerate(self.replicas):
            batches = srv.metrics.batches
            for b in batches[self._batches_seen[i]:]:
                self.aggregator.record(srv.name,
                                       max(b.exec_s, self.min_step_s))
                fed = True
            self._batches_seen[i] = len(batches)
        if not fed:
            return
        flagged = set(self.aggregator.stragglers())
        for i, srv in enumerate(self.replicas):
            slow = srv.name in flagged
            self._straggler_g.set(1.0 if slow else 0.0, replica=srv.name)
            self._fleet_streak[i] = self._fleet_streak[i] + 1 if slow else 0
            if (slow and self.healthy[i]
                    and self._fleet_streak[i] >= self.evict_after):
                self.healthy[i] = False
                self._evictions.inc(1, replica=srv.name)
                self._healthy_g.set(0.0, replica=srv.name)

    # ------------------------------------------------------ trace replay
    def serve_trace(self, trace, slo=None, eval_interval_s: float | None =
                    None) -> np.ndarray:
        """Replay a loadgen trace across the replica group on its
        simulated clock (applies the trace's injection plan first). With
        an ``SLOEngine``, polls + evaluates it every
        ``eval_interval_s`` of trace time (default: fast_window / 4 of
        the tightest spec), so burn-rate alerts fire *during* the replay
        exactly as they would behind the live front end."""
        self.apply_injection(trace.meta)
        if slo is not None and eval_interval_s is None:
            eval_interval_s = min(s.fast_window_s
                                  for s in slo.specs.values()) / 4.0
        lanes = self.route(trace.s, trace.t)
        n_req = len(trace)
        rids = np.empty(n_req, np.int64)
        next_eval = 0.0
        for i in range(n_req):
            now = float(trace.arrival_s[i])
            self.pump(now)
            if slo is not None and now >= next_eval:
                slo.step(now)
                next_eval = now + eval_interval_s
            rids[i] = self.submit(int(trace.s[i]), int(trace.t[i]), now,
                                  lane=str(lanes[i]))
            self.pump(now)
        self.pump(trace.span_s, force=True)
        if slo is not None:
            slo.step(trace.span_s)
        for srv in self.replicas:
            srv.metrics.trace_span_s += trace.span_s
        answers = np.empty(n_req, np.float32)
        for i in range(n_req):
            answers[i] = self.take_result(int(rids[i]))
        return answers

    # ----------------------------------------------------------- status
    def stats(self) -> dict:
        agg = {
            "name": self.name,
            "replicas": {
                srv.name: {
                    "healthy": self.healthy[i],
                    "served": srv.metrics.served,
                    "batches": len(srv.metrics.batches),
                    "exec_delay_s": srv.exec_delay_s,
                    "ema_s": self.aggregator.hosts[srv.name].ema,
                    "flag_streak": self.aggregator.hosts[srv.name].flags,
                    "fleet_streak": self._fleet_streak[i],
                } for i, srv in enumerate(self.replicas)
            },
            "fleet_stragglers": self.aggregator.stragglers(),
        }
        primary = self.replicas[0].stats()
        # group-level roll-up: sum served/hits, merge latency via the
        # shared registry histogram (per-replica series stay exported)
        agg["served"] = sum(srv.metrics.served for srv in self.replicas)
        agg["cache_hits"] = sum(srv.metrics.cache_hits
                                for srv in self.replicas)
        lat = self.registry.get("serve.latency_seconds")
        vals: list = []
        if lat is not None:
            names = set(self.server_names)
            for labels in lat.labels_seen():
                if labels.get("server") in names:
                    vals.extend(lat.values(**labels))
        if vals:
            v = np.asarray(vals, np.float64)
            agg["latency_ms"] = {
                "p50": float(np.quantile(v, 0.50)) * 1e3,
                "p95": float(np.quantile(v, 0.95)) * 1e3,
                "p99": float(np.quantile(v, 0.99)) * 1e3,
                "mean": float(v.mean()) * 1e3,
            }
        else:
            agg["latency_ms"] = primary["latency_ms"]
        for key in ("graph", "buckets", "backend", "compiled_shapes",
                    "fault", "obs"):
            agg[key] = primary[key]
        agg["qps_compute"] = (
            agg["served"] / es if (es := sum(
                b.exec_s for srv in self.replicas
                for b in srv.metrics.batches)) else 0.0)
        return agg
