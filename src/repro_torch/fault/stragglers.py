"""Straggler detection & mitigation hooks: the port's copy of
``repro.fault.stragglers`` (no JAX in either).

On a real fleet each host reports step wall-time; the controller compares
against the EMA and flags hosts persistently above ``threshold`` x the
fleet median (SPMD steps are synchronous, so one slow host gates all).
Mitigations wired here: (1) alert hook, (2) data re-balancing hint
(shrink the flagged host's shard of the next data window), (3) eviction
recommendation after ``evict_after`` consecutive flags — the elastic
restart path (checkpoint + re-mesh) then removes the host.

Single-process builds exercise the same logic with simulated timings;
the port's replica groups (``serve/replicas.py``) feed it per-batch
execution times.

Both classes report into the process metric registry
(``repro_torch.obs.REGISTRY``, ``fault.*`` series), which the serving
stack surfaces through ``DistanceServer.stats()["fault"]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.registry import REGISTRY


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2              # EMA coefficient
    threshold: float = 1.5          # x EMA -> flagged
    evict_after: int = 5
    ema: float | None = None
    flags: int = 0
    history: list = dataclasses.field(default_factory=list)
    host: str = "local"             # registry series label

    def record(self, step_seconds: float) -> dict:
        verdict = {"straggler": False, "evict": False,
                   "ratio": 1.0}
        if self.ema is None:
            self.ema = step_seconds
        else:
            ratio = step_seconds / max(self.ema, 1e-9)
            verdict["ratio"] = ratio
            if ratio > self.threshold:
                self.flags += 1
                verdict["straggler"] = True
                if self.flags >= self.evict_after:
                    verdict["evict"] = True
            else:
                self.flags = 0
                # only fold non-straggler steps into the EMA
                self.ema = (1 - self.alpha) * self.ema \
                    + self.alpha * step_seconds
        self.history.append((step_seconds, dict(verdict)))
        if verdict["straggler"]:
            REGISTRY.counter("fault.straggler_flags",
                             "steps flagged above the EMA threshold").inc(
                1, host=self.host)
        g = REGISTRY.gauge
        g("fault.step_seconds_ema", "per-host step wall-time EMA").set(
            self.ema, host=self.host)
        g("fault.straggler_streak",
          "consecutive flagged steps (evict at evict_after)").set(
            self.flags, host=self.host)
        return verdict


@dataclasses.dataclass
class HostTimingAggregator:
    """Fleet-level view: per-host EMAs + median comparison (the controller
    side of straggler mitigation)."""
    threshold: float = 1.3
    hosts: dict = dataclasses.field(default_factory=dict)

    def record(self, host: str, step_seconds: float):
        mon = self.hosts.setdefault(host, StragglerMonitor(host=host))
        return mon.record(step_seconds)

    def stragglers(self):
        import numpy as np
        emas = {h: m.ema for h, m in self.hosts.items() if m.ema}
        if not emas:
            return []
        med = float(np.median(list(emas.values())))
        out = [h for h, e in emas.items() if e > self.threshold * med]
        REGISTRY.gauge("fault.fleet_stragglers",
                       "hosts above threshold x fleet-median EMA").set(
            len(out))
        return out
