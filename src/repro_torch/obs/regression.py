"""Bench-trajectory regression gating over the committed
``BENCH_*.json`` files (the cross-PR perf trajectory) — the port's copy
of ``repro.obs.regression`` (numpy-free, standard library only), for
the port's own benchmark tables to gate with.

``compare_docs`` diffs a fresh benchmark document against the committed
baseline of the same table and classifies every shared metric:

  timing metrics    (``us_per_call`` rows, serving ``qps_compute`` /
                    ``latency_ms`` cells) — machine- and load-dependent,
                    gated at the *timing* tolerance (CI passes a loose
                    one; see .github/workflows/ci.yml).
  behavior metrics  (``cache_hit_rate``, ``batch_fill_ratio``, lane
                    request counts, plus any derived row field whose key
                    names a correctness/behavior quantity — exactness
                    flags, parity bits, fill ratios, relaxation round
                    counts, overflow counts) — deterministic given the
                    same trace/preset, gated at the tight *behavior*
                    tolerance: a drift here is a real serving-logic
                    regression, not noise.

Tolerances are relative: a lower-is-better metric regresses when
``fresh > base * (1 + tol)``; higher-is-better when
``fresh < base * (1 - tol)``. Metrics missing from the fresh run are
reported as regressions (coverage loss); metrics new in the fresh run
are ignored (the next commit of the baseline picks them up).

``repro``'s ``scripts/obs_report.py`` is the CLI over ``repro``'s copy.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

__all__ = ["Metric", "Regression", "extract_metrics", "compare_docs",
           "compare_dirs", "format_report"]

# Baseline values at or below these floors are noise (a 3µs row
# doubling is scheduler jitter, not a regression) — skipped.
TIMING_FLOOR_US = 20.0
QPS_FLOOR = 1.0


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str            # stable key, e.g. "row:uniform-b32:us_per_call"
    value: float
    higher_better: bool
    kind: str            # "timing" | "behavior"


@dataclasses.dataclass
class Regression:
    table: str
    metric: str
    kind: str
    baseline: float
    fresh: float | None          # None = missing from the fresh run
    tolerance: float

    @property
    def ratio(self) -> float:
        if self.fresh is None or self.baseline == 0:
            return float("inf")
        return self.fresh / self.baseline

    def describe(self) -> str:
        if self.fresh is None:
            return (f"[{self.table}] {self.metric}: missing from fresh "
                    f"run (baseline {self.baseline:g})")
        return (f"[{self.table}] {self.metric} ({self.kind}): baseline "
                f"{self.baseline:g} -> fresh {self.fresh:g} "
                f"(x{self.ratio:.2f}, tolerance ±{self.tolerance:.0%})")


# Derived row keys matching these fragments are deterministic behavior
# metrics (same code + preset => same value): exactness/parity flags and
# fill ratios must not drop; round counts, overflow counts, and host-sync
# counts (the construction suite's syncs_per_level — the device-resident
# build promises <= 1) must not grow. Everything else in a row stays
# timing-or-ignored.
BEHAVIOR_KEY_FRAGMENTS = (
    ("exact", True), ("parity", True), ("bitwise", True), ("fill", True),
    ("hit", True), ("rounds", False), ("overflow", False), ("sync", False),
)


def _behavior_direction(key: str) -> bool | None:
    """higher_better for a behavior-classified row key, None otherwise."""
    k = key.lower()
    for frag, higher_better in BEHAVIOR_KEY_FRAGMENTS:
        if frag in k:
            return higher_better
    return None


def _row_metrics(doc: dict) -> list[Metric]:
    out = []
    for r in doc.get("rows", []):
        name, us = r.get("name"), r.get("us_per_call")
        if name is None or us is None or name == "ERROR":
            continue
        if float(us) > TIMING_FLOOR_US:
            out.append(Metric(f"row:{name}:us_per_call", float(us),
                              higher_better=False, kind="timing"))
        for key, val in r.items():
            if key in ("table", "name", "us_per_call"):
                continue
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                continue
            hb = _behavior_direction(key)
            if hb is not None:
                out.append(Metric(f"row:{name}:{key}", float(val),
                                  higher_better=hb, kind="behavior"))
    return out


def _serving_metrics(doc: dict) -> list[Metric]:
    out = []
    for cell in doc.get("results", []):
        tag = (f"{cell.get('scenario', '?')}-b"
               + "x".join(str(b) for b in cell.get("buckets", [])))
        qps = cell.get("qps_compute", 0.0)
        if qps and qps > QPS_FLOOR:
            out.append(Metric(f"cell:{tag}:qps_compute", float(qps),
                              higher_better=True, kind="timing"))
        p99 = cell.get("latency_ms", {}).get("p99")
        if p99:
            out.append(Metric(f"cell:{tag}:latency_p99_ms", float(p99),
                              higher_better=False, kind="timing"))
        for key in ("cache_hit_rate", "batch_fill_ratio"):
            if key in cell:
                out.append(Metric(f"cell:{tag}:{key}", float(cell[key]),
                                  higher_better=True, kind="behavior"))
        for lane, ln in sorted(cell.get("lanes", {}).items()):
            if ln.get("requests", 0) > 0:
                out.append(Metric(f"cell:{tag}:lane_{lane}_requests",
                                  float(ln["requests"]),
                                  higher_better=True, kind="behavior"))
    return out


def extract_metrics(doc: dict) -> dict:
    """{metric name: Metric} for one BENCH document. Serving-style
    documents (``results`` cells) get the cell metrics on top of the
    generic ``us_per_call`` rows every table emits."""
    metrics = _row_metrics(doc)
    if "results" in doc:
        metrics += _serving_metrics(doc)
    return {m.name: m for m in metrics}


def compare_docs(table: str, baseline: dict, fresh: dict, *,
                 timing_tolerance: float = 0.5,
                 behavior_tolerance: float = 0.05) -> list[Regression]:
    """Every baseline metric the fresh run regressed on (or dropped)."""
    base_m = extract_metrics(baseline)
    fresh_m = extract_metrics(fresh)
    out = []
    for name, bm in sorted(base_m.items()):
        tol = (behavior_tolerance if bm.kind == "behavior"
               else timing_tolerance)
        fm = fresh_m.get(name)
        if fm is None:
            out.append(Regression(table, name, bm.kind, bm.value, None,
                                  tol))
            continue
        if bm.higher_better:
            bad = fm.value < bm.value * (1.0 - tol)
        else:
            bad = fm.value > bm.value * (1.0 + tol)
        if bad:
            out.append(Regression(table, name, bm.kind, bm.value,
                                  fm.value, tol))
    return out


def compare_dirs(baseline_dir, fresh_dir, *, tables=None,
                 timing_tolerance: float = 0.5,
                 behavior_tolerance: float = 0.05):
    """Diff every ``BENCH_<table>.json`` present in both directories.

    Returns ``(regressions, compared_tables, skipped_tables)`` —
    skipped = baseline tables with no fresh counterpart (not a failure:
    partial bench runs are normal; pass ``tables`` to require a set).
    """
    baseline_dir, fresh_dir = Path(baseline_dir), Path(fresh_dir)
    regs, compared, skipped = [], [], []
    for bpath in sorted(baseline_dir.glob("BENCH_*.json")):
        table = bpath.stem[len("BENCH_"):]
        if tables and table not in tables:
            continue
        fpath = fresh_dir / bpath.name
        if not fpath.exists():
            skipped.append(table)
            continue
        regs += compare_docs(table, json.loads(bpath.read_text()),
                             json.loads(fpath.read_text()),
                             timing_tolerance=timing_tolerance,
                             behavior_tolerance=behavior_tolerance)
        compared.append(table)
    if tables:
        missing = sorted(set(tables) - set(compared))
        for table in missing:
            regs.append(Regression(table, "<table>", "coverage", 1.0,
                                   None, 0.0))
    return regs, compared, skipped


def format_report(regs, compared, skipped, *, timing_tolerance,
                  behavior_tolerance) -> str:
    lines = [f"bench-regression report: {len(compared)} table(s) "
             f"compared ({', '.join(compared) or 'none'}), "
             f"{len(skipped)} skipped ({', '.join(skipped) or 'none'}), "
             f"tolerances timing ±{timing_tolerance:.0%} / "
             f"behavior ±{behavior_tolerance:.0%}"]
    if not regs:
        lines.append("OK: no metric regressed beyond tolerance")
    else:
        lines.append(f"FAIL: {len(regs)} regression(s)")
        lines += ["  " + r.describe() for r in regs]
    return "\n".join(lines)
