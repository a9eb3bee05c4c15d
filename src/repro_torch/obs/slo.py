"""SLO burn-rate engine: declarative objectives over the serving
stack, evaluated as rolling multi-window burn rates with fire/resolve
hysteresis — the port's copy of ``repro.obs.slo``.

An ``SLOSpec`` states an objective — the target fraction of *good*
events (availability, requests under a latency bound, exactness-audit
passes, zero ``serve_read`` first-use builds) — and the engine tracks
how fast the error budget ``1 - objective`` is being consumed:

    burn rate = (bad events / total events over a window) / budget

following the multi-window multi-burn-rate alerting policy (Google SRE
workbook ch. 5): an alert **fires** only when the *fast* window (a
5-minute-equivalent on the serving clock) and the *slow* window (a
1-hour-equivalent) both burn strictly above their thresholds — the fast
window gives low detection latency, the slow window keeps one transient
spike from paging. Windows are expressed on the *serving clock*: wall
seconds behind the HTTP front end, simulated trace seconds in a
deterministic replay (the engine never reads a wall clock itself).

Observations enter two ways:

  * **push** — ``record(name, now, good=, bad=)`` from call sites that
    witness events directly (the front end's availability accounting,
    exactness audits);
  * **poll** — ``attach(name, probe)`` registers a cumulative
    ``() -> (good_total, total)`` source sampled at every
    ``poll(now)``; built-ins below read the metric registry
    (``latency_source``), counter pairs (``counter_source``) and the
    first-use build watcher (``compiles_source``: the port builds
    kernels and layouts at first use where ``repro`` compiles), so the
    engine wires onto the existing serving stack without touching its
    hot path.

State machine per SLO: ``ok -> firing`` when both windows burn strictly
above threshold (ties do NOT fire; a burn rate exactly at threshold is
budget-neutral), ``firing -> ok`` only after the fire condition has
been continuously false for ``resolve_hold_s`` (hysteresis — a flapping
burn rate holds the alert). Every transition emits a structured
``slo_alert`` event into the ``EventLog`` (JSON-lines / SSE-streamable)
and updates ``slo.*`` registry series; ``breach_summary()`` is the
machine-readable digest CI gates on.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.obs.registry import REGISTRY

__all__ = ["SLOSpec", "SLOEngine", "AlertState", "latency_source",
           "counter_source", "compiles_source", "default_serving_slos"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``objective`` is the target good fraction (0 < objective < 1); the
    error budget is ``1 - objective``. ``fast_window_s``/``slow_window_s``
    are the two rolling windows on the serving clock, ``fast_burn``/
    ``slow_burn`` their fire thresholds (both must be exceeded
    *strictly*). ``min_events`` guards empty/thin windows: fewer total
    events than this in the fast window can never fire. ``resolve_hold_s``
    is the hysteresis hold: the fire condition must stay false this
    long before the alert resolves.
    """
    name: str
    objective: float = 0.999
    fast_window_s: float = 300.0          # 5m-equivalent
    slow_window_s: float = 3600.0         # 1h-equivalent
    fast_burn: float = 14.0
    slow_burn: float = 6.0
    resolve_hold_s: float = 120.0
    min_events: int = 1
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"slo {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(f"slo {self.name!r}: fast window "
                             f"{self.fast_window_s} exceeds slow window "
                             f"{self.slow_window_s}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


@dataclasses.dataclass
class AlertState:
    """Mutable per-SLO evaluation state."""
    spec: SLOSpec
    samples: deque = dataclasses.field(default_factory=deque)
    good: int = 0                  # push-path cumulative tallies
    bad: int = 0
    firing: bool = False
    fires: int = 0
    resolves: int = 0
    fired_ever: bool = False
    last_true_ts: float | None = None   # last eval where condition held
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    max_burn_fast: float = 0.0
    max_burn_slow: float = 0.0

    def window_rate(self, now: float, window_s: float):
        """(bad fraction, total events) across the trailing window:
        delta between the newest sample and the newest sample at or
        before ``now - window_s`` (the earliest retained sample when
        the run is younger than the window)."""
        if not self.samples:
            return 0.0, 0
        newest = self.samples[-1]
        base = None
        cutoff = now - window_s
        for s in self.samples:          # deque is ts-ordered
            if s[0] <= cutoff:
                base = s
            else:
                break
        if base is None:
            base = (self.samples[0][0], 0, 0)   # run younger than window
        d_good = newest[1] - base[1]
        d_total = newest[2] - base[2]
        if d_total <= 0:
            return 0.0, 0
        return (d_total - d_good) / d_total, d_total


class SLOEngine:
    """Evaluates a set of ``SLOSpec``s over push/poll observations and
    drives the fire/resolve state machine."""

    def __init__(self, specs, *, log=None, registry=None):
        self.specs = {s.name: s for s in specs}
        if len(self.specs) != len(list(specs)):
            raise ValueError("duplicate SLO names")
        self.log = log
        self.registry = registry if registry is not None else REGISTRY
        self.states = {n: AlertState(spec=s) for n, s in self.specs.items()}
        self._probes: dict[str, object] = {}
        self._burn_g = self.registry.gauge(
            "slo.burn_rate", "error-budget burn rate per window")
        self._firing_g = self.registry.gauge(
            "slo.firing", "1 while the SLO alert is firing")
        self._alerts_c = self.registry.counter(
            "slo.alerts", "fire/resolve transitions")

    # -------------------------------------------------------- ingestion
    def attach(self, name: str, probe) -> None:
        """Register a cumulative ``() -> (good_total, total)`` source
        sampled at every ``poll``."""
        if name not in self.specs:
            raise KeyError(f"unknown SLO {name!r}; have "
                           f"{sorted(self.specs)}")
        self._probes[name] = probe

    def record(self, name: str, now: float, good: int = 0,
               bad: int = 0) -> None:
        """Push ``good``/``bad`` events observed at ``now``."""
        st = self.states[name]
        st.good += int(good)
        st.bad += int(bad)
        self._push_sample(st, now, st.good, st.good + st.bad)

    def poll(self, now: float) -> None:
        """Sample every attached cumulative source at ``now``."""
        for name, probe in self._probes.items():
            good, total = probe()
            self._push_sample(self.states[name], now, int(good),
                              int(total))

    def _push_sample(self, st: AlertState, now: float, good: int,
                     total: int) -> None:
        now = float(now)
        if st.samples and now < st.samples[-1][0]:
            raise ValueError(
                f"slo {st.spec.name!r}: sample at {now} precedes newest "
                f"{st.samples[-1][0]} (the serving clock is monotonic)")
        st.samples.append((now, good, total))
        horizon = now - 2.0 * st.spec.slow_window_s
        while len(st.samples) > 2 and st.samples[1][0] <= horizon:
            st.samples.popleft()

    # ------------------------------------------------------- evaluation
    def evaluate(self, now: float) -> list:
        """Advance every SLO's state machine to ``now``; returns the
        alert events emitted by this call (also appended to ``log``)."""
        now = float(now)
        events = []
        for name, st in self.states.items():
            spec = st.spec
            rate_f, n_f = st.window_rate(now, spec.fast_window_s)
            rate_s, _ = st.window_rate(now, spec.slow_window_s)
            st.burn_fast = rate_f / spec.budget
            st.burn_slow = rate_s / spec.budget
            st.max_burn_fast = max(st.max_burn_fast, st.burn_fast)
            st.max_burn_slow = max(st.max_burn_slow, st.burn_slow)
            self._burn_g.set(st.burn_fast, slo=name, window="fast")
            self._burn_g.set(st.burn_slow, slo=name, window="slow")
            condition = (n_f >= spec.min_events
                         and st.burn_fast > spec.fast_burn
                         and st.burn_slow > spec.slow_burn)
            if condition:
                st.last_true_ts = now
            if condition and not st.firing:
                st.firing = st.fired_ever = True
                st.fires += 1
                events.append(self._emit(now, st, "fire"))
            elif (st.firing and not condition
                  and st.last_true_ts is not None
                  and now - st.last_true_ts >= spec.resolve_hold_s):
                st.firing = False
                st.resolves += 1
                events.append(self._emit(now, st, "resolve"))
            self._firing_g.set(1.0 if st.firing else 0.0, slo=name)
        return events

    def step(self, now: float) -> list:
        """poll + evaluate in one call (the front end's cadence hook)."""
        self.poll(now)
        return self.evaluate(now)

    def _emit(self, now: float, st: AlertState, state: str) -> dict:
        spec = st.spec
        self._alerts_c.inc(1, slo=spec.name, state=state)
        fields = {
            "slo": spec.name, "state": state,
            "objective": spec.objective,
            "burn_fast": round(st.burn_fast, 4),
            "burn_slow": round(st.burn_slow, 4),
            "fast_window_s": spec.fast_window_s,
            "slow_window_s": spec.slow_window_s,
            "fast_burn_threshold": spec.fast_burn,
            "slow_burn_threshold": spec.slow_burn,
        }
        if self.log is not None:
            return self.log.log("slo_alert", ts=now, **fields)
        return {"ts": now, "kind": "slo_alert", **fields}

    # ----------------------------------------------------------- status
    def snapshot(self) -> dict:
        """Live per-SLO state — the ``/events`` metrics-frame section
        and the ``/stats`` ``slo`` block."""
        return {name: {
            "firing": st.firing,
            "burn_fast": st.burn_fast,
            "burn_slow": st.burn_slow,
            "fires": st.fires,
            "resolves": st.resolves,
            "objective": st.spec.objective,
        } for name, st in self.states.items()}

    def breach_summary(self) -> dict:
        """Machine-readable run digest for CI gating: which SLOs ever
        fired, which are still firing, and the worst burn observed."""
        return {
            "fired": sorted(n for n, st in self.states.items()
                            if st.fired_ever),
            "firing": sorted(n for n, st in self.states.items()
                             if st.firing),
            "slos": {name: {
                "fires": st.fires,
                "resolves": st.resolves,
                "max_burn_fast": st.max_burn_fast,
                "max_burn_slow": st.max_burn_slow,
            } for name, st in self.states.items()},
        }


# --------------------------------------------------------------- sources
def latency_source(threshold_s: float, *, registry=None,
                   metric: str = "serve.latency_seconds",
                   servers=None):
    """Cumulative (good, total) over the serving latency histogram:
    good = requests at or under ``threshold_s``. ``servers`` restricts
    to series whose ``server`` label is in the set (None = all) — a
    ``ReplicaSet`` passes its replica names so one SLO covers the whole
    group."""
    reg = registry if registry is not None else REGISTRY
    allowed = None if servers is None else {str(s) for s in servers}

    def probe():
        h = reg.get(metric)
        if h is None:
            return 0, 0
        good = total = 0
        for labels in h.labels_seen():
            if allowed is not None and labels.get("server") not in allowed:
                continue
            total += h.count(**labels)
            good += h.count_le(threshold_s, **labels)
        return good, total
    return probe


def counter_source(good_metric: str, bad_metric: str, *, registry=None):
    """Cumulative (good, total) from a pair of counters (availability:
    answered requests vs front-end errors)."""
    reg = registry if registry is not None else REGISTRY

    def probe():
        g = reg.get(good_metric)
        b = reg.get(bad_metric)
        good = g.total() if g is not None else 0.0
        bad = b.total() if b is not None else 0.0
        return int(good), int(good + bad)
    return probe


def compiles_source(watcher, region: str = "serve_read"):
    """Zero-tolerance source over the first-use build watcher
    (``obs.profiler.BuildWatcher``): every build counted in ``region``
    — the kernel library, a route layout, chase planes; the port's
    counterpart of an XLA compile — is a bad event (and there are no
    good ones), so any build inside the window burns at rate 1. A
    watcher that reports ``supported = False`` counts nothing."""
    def probe():
        supported = getattr(watcher, "supported", True)
        bad = int(watcher.count(region)) if supported else 0
        return 0, bad
    return probe


def default_serving_slos(*, latency_threshold_s: float = 0.1,
                         latency_objective: float = 0.999,
                         availability_objective: float = 0.999,
                         fast_window_s: float = 300.0,
                         slow_window_s: float = 3600.0,
                         resolve_hold_s: float = 120.0) -> list:
    """The standing serving SLOs: availability, read-lane latency,
    exactness-audit pass rate, and zero serve_read builds. Window sizes
    scale with the serving clock — a trace replay passes windows sized
    to its simulated span."""
    kw = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
              resolve_hold_s=resolve_hold_s)
    return [
        SLOSpec("availability", objective=availability_objective,
                description="answered / (answered + errors)", **kw),
        SLOSpec("latency", objective=latency_objective,
                description=f"requests <= {latency_threshold_s * 1e3:g}ms",
                **kw),
        SLOSpec("exactness", objective=0.9999, min_events=1,
                description="audit passes / audited answers", **kw),
        SLOSpec("read_compiles", objective=0.5, min_events=1,
                fast_burn=0.0, slow_burn=0.0,
                description="zero first-use builds in region "
                            "serve_read",
                **kw),
    ]
