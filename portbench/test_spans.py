"""CPU tests of the readers of the program's spans and counters
(``spans.py``, ``metrics/``): the reduction by program span on
synthetic events, the readers on tiny traced runs with the program's
spans on and off, and the device-time readers on a synthetic record."""
from __future__ import annotations

import time

import pytest

from portbench import bench, spans
from portbench.test_portbench import TINY_CONFIG, TRAFFIC

NAMES = [m["name"] for m in spans.METRICS]
# what a CPU run can read: counts and host seconds, not device time
ON_CPU = {"query": ["relax.rounds"],
          "rebuild": ["build.pull_s", "build.assemble_s", "build.dedup_live",
                      "build.label_live", "build.mis_useful"]}


def _run(kind: str, program_spans: bool):
    cell = {"name": f"tiny.{kind}", "chips": 1}
    metrics = [{"name": m, "unit": "x"} for m in NAMES]
    with spans.span_windows(program_spans):
        result, _ = bench.run_cell(cell, TINY_CONFIG, TRAFFIC[kind],
                                   2 ** 31 + 7, 0.05, True, "cpu",
                                   time.perf_counter(), metrics)
    return result, spans.SpanWindow.last


def _ann(name, start, end):
    return {"name": name, "device": False, "annotation": True, "corr": 0,
            "start": start, "end": end}


def _launch(corr, t):
    return {"name": "cudaLaunchKernel", "device": False, "annotation": False,
            "corr": corr, "start": t, "end": t + 1}


def _kernel(corr, start, end):
    return {"name": "k", "device": True, "annotation": False, "corr": corr,
            "start": start, "end": end}


def test_by_span_on_synthetic_events():
    """window [0, 100]; the harness's build range [10, 90] holds the
    program's build [11, 89], its level [12, 50] with a read [40, 50],
    and its pull [60, 70] with a read [61, 66]. Kernels launched at 13
    (level, 13-40) and 62 (read in the pull, 62-80): idle gaps [0, 13)
    outside every program span, [40, 62) opening in the level's read,
    [80, 100) opening in the build after the pull."""
    events = [_ann("window", 0, 100), _ann("build", 10, 90),
              _ann("build", 11, 89), _ann("build.level", 12, 50),
              _ann("sync.read", 40, 50), _ann("build.pull", 60, 70),
              _ann("sync.read", 61, 66), _launch(1, 13), _launch(2, 62),
              _kernel(1, 13, 40), _kernel(2, 62, 80)]
    got = spans.by_span(events, 0, 100)
    sp = got["spans"]
    assert set(sp) == {"build", "build.level", "sync.read", "build.pull"}
    assert sp["build"]["n"] == 1
    assert sp["build"]["host_s"] == pytest.approx(78e-9)
    assert sp["sync.read"]["n"] == 2
    assert sp["sync.read"]["host_s"] == pytest.approx(15e-9)
    assert sp["build"]["device_s"] == pytest.approx(45e-9)
    assert sp["build"]["device_self_s"] == 0.0
    assert sp["build.level"]["device_self_s"] == pytest.approx(27e-9)
    assert sp["build.pull"]["device_s"] == pytest.approx(18e-9)
    assert sp["sync.read"]["device_self_s"] == pytest.approx(18e-9)
    assert sp["sync.read"]["idle_s"] == pytest.approx(22e-9)
    assert sp["build"]["idle_s"] == pytest.approx(20e-9)
    assert got["harness"] == {"build": {"n": 1,
                                        "host_s": pytest.approx(80e-9)}}
    # gaps opening inside the harness's build range: [40, 62), [80, 100)
    assert got["harness_idle_s"] == pytest.approx(42e-9)
    assert got["put_down_s"] == pytest.approx(42e-9)
    assert [name for name, _ in got["longest_gaps"]] \
        == ["sync.read", "build", "-"]


@pytest.mark.parametrize("kind", ["query", "rebuild"])
def test_readers_on_tiny_traced_runs(kind):
    """With the program's spans on, each reader its kind can feed on the
    CPU reads a number; the device-time readers read nothing without
    device events; with the harness's ranges only every reader reads
    nothing."""
    result, tr = _run(kind, True)
    assert result["correct"]
    got = result["metrics"]
    assert sorted(got) == sorted(ON_CPU[kind])
    assert all(got[m]["value"] > 0 for m in got)
    if kind == "query":
        assert got["relax.rounds"]["value"] \
            == tr["program_counters"]["relax.rounds"] / result["attempted"]
        assert "query.relax" in tr["program_spans"]
    else:
        assert 0 < got["build.dedup_live"]["value"] < 100
        assert tr["program_spans"]["build.pull"]["n"] == result["attempted"]
    result, tr = _run(kind, False)
    assert result["correct"] and result["metrics"] == {}
    assert "program_spans" not in tr and tr["harness_ranges"]


def test_device_readers_on_a_synthetic_record():
    def span(device_s=0.0, idle_s=0.0, host_s=0.0):
        return {"n": 1, "host_s": host_s, "device_s": device_s,
                "device_self_s": device_s, "idle_s": idle_s}
    trace = {"device_events": 10, "window_s": 50.0,
             "program_spans": {"query.relax": span(device_s=4.0),
                               "sync.read": span(idle_s=1.5)},
             "program_counters": {"relax.changed": 30.0,
                                  "relax.slots": 120.0,
                                  "relax.rounds": 50.0}}
    query = {"requests": 25, "trace": trace}
    rebuild = {"builds": [{}] * 4, "trace": trace}
    read = {m: bench.reader(m) for m in NAMES}
    assert read["relax.changed_share"](query) == 25.0
    assert read["relax.device_ms"](query) == 160.0
    assert read["relax.rounds"](query) == 2.0
    assert read["sync.idle_share.query"](query) == 3.0
    assert read["sync.idle_share.query"](rebuild) is None
    assert read["sync.idle_share.build"](rebuild) == 3.0
    assert read["sync.idle_share.build"](query) is None
    no_device = {"requests": 25, "trace": {**trace, "device_events": 0}}
    assert read["relax.device_ms"](no_device) is None
    for m in NAMES:
        assert read[m]({"requests": 1, "builds": [{}], "trace": {
            "device_events": 1, "window_s": 1.0}}) is None
        assert read[m]({"requests": 1, "builds": [{}]}) is None
