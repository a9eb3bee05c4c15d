"""The program's own spans and counters in a traced run of a cell.

The program (``repro_torch``) marks its layers with ``record_function``
spans and keeps counts, all off unless a block turns them on
(``repro_torch.obs.trace.program_spans``). ``SpanWindow`` is the
harness's ``bench.Window`` with them on for the traced window; its
``analyse`` adds to the harness's numbers

  ``program_spans``     by span name (``by_span``): its ranges, their
                        host seconds, the device seconds launched while
                        it was open (``device_s``) and while it was the
                        innermost program span (``device_self_s``), and
                        the idle seconds whose gap opens while it is the
                        innermost program span open on the host
  ``program_counters``  each counter's change across the window

which the readers in ``metrics/`` (``relax.*``, ``sync.idle_share.*``,
``build.*``) read. The harness's ranges are ``window``, the ``entry`` or
``build`` range directly inside it, and ``stage2``; every other range is
the program's (the program's own ``build`` span lies inside the
harness's ``build`` range).

One traced run of a cell, as ``run.py --trace 1`` makes it, with the
program's spans on (``--spans 1``) or with the harness's ranges only
(``--spans 0``), printed as one JSON line::

    python3 portbench/spans.py --workload btc_er2m.rebuild --seed 7 \\
        --seconds 51 --spans 1
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)

from portbench import bench, timeline  # noqa: E402

ROOT = bench.ROOT
HARNESS_TOP = ("entry", "build")

# the readers of the program's spans and counters, with the cells whose
# traced runs have something for each to read
QUERY = ["btc_er2m.q1024", "web_rmat17.q4096"]
REBUILD = ["btc_er2m.rebuild", "web_rmat17.rebuild"]
METRICS = [
    {"name": "relax.rounds", "unit": "rounds/request", "workloads": QUERY},
    {"name": "relax.changed_share", "unit": "%", "workloads": QUERY},
    {"name": "relax.device_ms", "unit": "ms", "workloads": QUERY},
    {"name": "sync.idle_share.query", "unit": "%", "workloads": QUERY},
    {"name": "sync.idle_share.build", "unit": "%", "workloads": REBUILD},
    {"name": "build.pull_s", "unit": "s", "workloads": REBUILD},
    {"name": "build.assemble_s", "unit": "s", "workloads": REBUILD},
    {"name": "build.dedup_live", "unit": "%", "workloads": REBUILD},
    {"name": "build.label_live", "unit": "%", "workloads": REBUILD},
    {"name": "build.mis_useful", "unit": "%", "workloads": REBUILD},
]


def counter_totals() -> dict:
    """Every counter of the program's registry, summed over its
    series."""
    from repro_torch.obs.registry import REGISTRY
    out = {}
    for name in REGISTRY.names():
        m = REGISTRY.get(name)
        if m.kind == "counter":
            out[name] = m.total()
    return out


def spans_context():
    """The program's ``program_spans()``, or nothing where the program
    has none."""
    try:
        from repro_torch.obs.trace import program_spans
    except ImportError:
        return None
    return program_spans()


class Stacks:
    """The program spans open on the host at each instant: a step
    function over the sorted boundaries of the nested ranges."""

    def __init__(self, ranges):
        """``ranges``: (start, end, name) with name None for a harness
        range."""
        self.times: list[int] = []
        self.stacks: list[tuple] = []
        stack: list[tuple] = []
        for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= start:
                self._mark(stack.pop()[0], stack)
            stack.append((end, name))
            self._mark(start, stack)
        while stack:
            self._mark(stack.pop()[0], stack)

    def _mark(self, t, stack):
        self.times.append(t)
        self.stacks.append(tuple(n for _, n in stack if n is not None))

    def at(self, t) -> tuple:
        """The names of the program spans open at ``t``, outermost
        first."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()


def split_ranges(events):
    """The host ranges of ``events``: the harness's (``window``, the
    ``entry`` or ``build`` ranges directly inside it, ``stage2``) and
    the program's, as (start, end, name or None for the harness's), and
    the harness's top ranges as (start, end, name)."""
    ann = sorted(((e["start"], e["end"], e["name"]) for e in events
                  if e["annotation"] and not e["device"]),
                 key=lambda r: (r[0], -r[1]))
    out, top, stack = [], [], []
    for start, end, name in ann:
        while stack and stack[-1] <= start:
            stack.pop()
        harness = (name in ("window", "stage2")
                   or (len(stack) == 1 and name in HARNESS_TOP))
        if harness and name in HARNESS_TOP:
            top.append((start, end, name))
        out.append((start, end, None if harness else name))
        stack.append(end)
    return out, top


def by_span(events, lo: int, hi: int) -> dict:
    """The window [lo, hi] of ``events`` (``timeline.events_of``'s form)
    by program span. Returns ``spans`` (name -> n, host_s, device_s,
    device_self_s, idle_s), the idle seconds that open inside the
    harness's top ranges (``harness_idle_s``) and the part of them that
    opens inside a program span (``put_down_s``), the harness's top
    ranges by name (n, host_s), and the ten longest idle gaps by the
    innermost program span open where each opens (``-`` for none)."""
    ranges, top = split_ranges(events)
    stacks = Stacks(ranges)
    spans: dict[str, dict] = {}

    def entry(name):
        return spans.setdefault(name, {"n": 0, "host_s": 0.0,
                                       "device_s": 0.0,
                                       "device_self_s": 0.0, "idle_s": 0.0})

    for start, end, name in ranges:
        if name is not None and min(end, hi) > max(start, lo):
            rec = entry(name)
            rec["n"] += 1
            rec["host_s"] += (min(end, hi) - max(start, lo)) * 1e-9
    launch = {}
    for e in events:
        if not e["device"] and not e["annotation"] \
                and e["name"].startswith("cu"):
            launch.setdefault(e["corr"], e["start"])
    device = []
    for e in events:
        if not e["device"] or e["annotation"]:
            continue
        device.append((e["start"], e["end"]))
        t = launch.get(e["corr"])
        if t is None:
            continue
        open_ = stacks.at(t)
        dur = (e["end"] - e["start"]) * 1e-9
        for name in set(open_):
            entry(name)["device_s"] += dur
        if open_:
            entry(open_[-1])["device_self_s"] += dur
    harness = timeline.Ranges([(a, b) for a, b, _ in top])
    harness_idle = put_down = 0.0
    longest = []
    for a, b in timeline.gaps(device, lo, hi):
        open_ = stacks.at(a)
        longest.append((open_[-1] if open_ else "-", (b - a) * 1e-9))
        if open_:
            entry(open_[-1])["idle_s"] += (b - a) * 1e-9
        if harness.find(a) >= 0:
            harness_idle += (b - a) * 1e-9
            put_down += (b - a) * 1e-9 if open_ else 0.0
    tops: dict[str, dict] = {}
    for start, end, name in top:
        rec = tops.setdefault(name, {"n": 0, "host_s": 0.0})
        rec["n"] += 1
        rec["host_s"] += (end - start) * 1e-9
    longest.sort(key=lambda kv: -kv[1])
    return {"spans": spans, "harness_idle_s": harness_idle,
            "put_down_s": put_down, "harness": tops,
            "longest_gaps": longest[:10]}


class SpanWindow(bench.Window):
    """``bench.Window`` with the program's spans and counters on for a
    traced window (``spans`` False: the harness's ranges only)."""

    spans = True
    last: dict | None = None

    @contextlib.contextmanager
    def open(self):
        with super().open():
            ctx = spans_context() if self.trace and self.spans else None
            if ctx is None:
                self.counters = None
                yield self
                return
            before = counter_totals()
            with ctx:
                yield self
            after = counter_totals()
            self.counters = {k: v - before.get(k, 0.0)
                             for k, v in after.items()
                             if v != before.get(k, 0.0)}

    def analyse(self) -> dict:
        events = timeline.events_of(self.prof)
        self.prof = None
        lo, hi = next((e["start"], e["end"]) for e in events
                      if e["annotation"] and not e["device"]
                      and e["name"] == "window")
        out = timeline.analyse(events, lo, hi)
        table = by_span(events, lo, hi)
        out["harness_ranges"] = table["harness"]
        if self.counters is not None:
            out["program_spans"] = table["spans"]
            out["program_counters"] = self.counters
            out["harness_idle_s"] = table["harness_idle_s"]
            out["put_down_s"] = table["put_down_s"]
            out["longest_gaps"] = table["longest_gaps"]
        SpanWindow.last = out
        return out


@contextlib.contextmanager
def span_windows(spans: bool = True):
    """While open, the traffic kinds open a ``SpanWindow`` (with the
    program's spans on or off) where they would open a ``bench.Window``."""
    orig = bench.Window
    SpanWindow.spans = spans
    bench.Window = SpanWindow
    try:
        yield
    finally:
        bench.Window = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = bench.resolve(spec, args.workload)
    metrics = bench.metrics_of(spec, cell, True) + [
        m for m in METRICS if args.spans and cell["name"] in m["workloads"]]
    with span_windows(bool(args.spans)):
        result, lines = bench.run_cell(cell, config, traffic, args.seed,
                                       args.seconds, True, "cuda", T_START,
                                       metrics)
    tr = SpanWindow.last
    keep = ("busy_s", "window_s", "idle_share", "harness_ranges",
            "program_spans", "program_counters", "harness_idle_s",
            "put_down_s", "longest_gaps")
    idle_by_range: dict[str, float] = {}
    for label, secs in tr["idle_gaps"]:
        idle_by_range[label] = idle_by_range.get(label, 0.0) + secs
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "spans": bool(args.spans), **result,
                      "trace": {**{k: tr[k] for k in keep if k in tr},
                                "idle_by_range": idle_by_range}}))
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
