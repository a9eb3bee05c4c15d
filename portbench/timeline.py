"""The traced window: host ranges, device events, and the arithmetic
that turns them into busy time, idle share, per-request device time and
the breakdown.

A traced run opens ``torch.profiler`` over the whole measured window.
The harness marks its own ranges with ``record_function``: ``entry``
around each request, ``build`` around each build, and ``stage2`` around
the program's ``CoreRelaxer.run`` (``wrap_stage2``). Each device event
(kernel, copy, set) is tied to the host call that launched it through
the CUDA runtime's correlation id, so it is counted for the range that
was open when it was launched, wherever it ran on the device.

The busy and idle arithmetic is a copy of ``chip_smoke.py``'s
``profile_idle``: busy time is the union of the device events'
intervals, and the idle share is one less busy time over the window's
wall time.
"""
from __future__ import annotations

import bisect
import contextlib
import re

RANGES = ("entry", "stage2", "build")


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class Ranges:
    """Sorted host ranges of one name, for lookups by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def find(self, t: float) -> int:
        """Index of the range open at ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        return i if i >= 0 and t <= self.spans[i][1] else -1


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its return type and its
    parameter list, at most 96 characters."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not name.startswith(
                "(anonymous", i):
            name = name[:i]
            break
    return name[:96]


def analyse(events, window_lo: float, window_hi: float) -> dict:
    """Reduce raw events to the traced window's numbers.

    ``events``: dicts with ``name``, ``device`` (bool: a device event),
    ``annotation`` (bool: a ``record_function`` range), ``corr`` (the
    correlation id, which a device event shares with the CUDA runtime
    call, ``cu...``, that launched it) and ``start``/``end`` in integer
    nanoseconds, host and device on one clock; ``window_lo`` and
    ``window_hi`` bound the window on that clock. Returns, in seconds,
    busy and window seconds, the idle share, each request's
    device seconds inside and outside its ``stage2`` range, device
    seconds by kernel name, the longest idle gaps by the range open on
    the host, the count of ``stage2`` ranges, and the count of device
    events tied to no launch."""
    host = {}
    device, ranges = [], {r: [] for r in RANGES}
    for e in events:
        if e["annotation"]:
            if not e["device"] and e["name"] in ranges:
                ranges[e["name"]].append((e["start"], e["end"]))
        elif e["device"]:
            device.append(e)
        elif e["name"].startswith("cu"):       # a CUDA runtime call
            host.setdefault(e["corr"], e["start"])
    look = {r: Ranges(s) for r, s in ranges.items()}
    entries = look["entry"]
    per_req = [[0.0, 0.0] for _ in entries.spans]   # [outside, inside]
    by_name: dict[str, float] = {}
    unlinked = 0
    spans = []
    for e in device:
        spans.append((e["start"], e["end"]))
        dur = (e["end"] - e["start"]) * 1e-9
        key = short_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + dur
        launch = host.get(e["corr"])
        if launch is None:
            unlinked += 1
            continue
        i = entries.find(launch)
        if i >= 0:
            per_req[i][look["stage2"].find(launch) >= 0] += dur
    idle = []
    for a, b in gaps(spans, window_lo, window_hi):
        label = next((r for r in ("stage2", "entry", "build")
                      if look[r].find(a) >= 0), "loop")
        idle.append((label, (b - a) * 1e-9))
    idle.sort(key=lambda kv: -kv[1])
    window = window_hi - window_lo
    busy = union_length(clip(spans, window_lo, window_hi))
    return {"busy_s": busy * 1e-9, "window_s": window * 1e-9,
            "idle_share": 1.0 - busy / window,
            "stage2_ranges": len(ranges["stage2"]),
            "device_events": len(device), "unlinked": unlinked,
            "requests": per_req,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_gaps": idle}


def events_of(prof) -> list[dict]:
    """The raw events of a finished ``torch.profiler.profile``, in the
    form ``analyse`` reads."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append({"name": e.name(),
                    "device": e.device_type() != DeviceType.CPU,
                    "annotation": bool(e.is_user_annotation()),
                    "corr": e.correlation_id(),
                    "start": e.start_ns(), "end": e.end_ns()})
    return out


@contextlib.contextmanager
def wrap_stage2(on_call=None):
    """While open, every ``CoreRelaxer.run`` runs inside a ``stage2``
    range; ``on_call(args, result)`` sees each call."""
    from torch.profiler import record_function
    from repro_torch.core.dispatch import CoreRelaxer
    orig = CoreRelaxer.run

    def run(self, *args, **kw):
        with record_function("stage2"):
            out = orig(self, *args, **kw)
        if on_call is not None:
            on_call(args, out)
        return out

    CoreRelaxer.run = run
    try:
        yield
    finally:
        CoreRelaxer.run = orig
