"""The observability layer and the serving launcher of the PyTorch port.

The copied ``Tracer``, ``EventLog``, ``write_chrome_trace`` and
``write_metrics`` give what ``repro.obs``'s give on the same spans,
events and series. ``compile_region`` attributes the port's first-use
builds (kernel library, route layouts, chase planes) to the region they
happen in, and ``BuildWatcher`` reads them. A traced replay's request
spans cover at least 99% of every request's time. ``python -m
repro_torch.launch.serve --device cpu`` exits 0 in ``--mode distance
--audit dijkstra`` and ``--mode path`` on ``er --n 256``, and its sinks
are written.
"""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from repro.obs import EventLog as JEventLog
from repro.obs import MetricRegistry as JMetricRegistry
from repro.obs import Tracer as JTracer
from repro.obs import write_chrome_trace as j_write_chrome_trace
from repro.obs import write_metrics as j_write_metrics
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.core.dispatch import CoreRelaxer
from repro_torch.graphs import generators as gen
from repro_torch.obs import (NULL_TRACER, BuildWatcher, EventLog,
                             MetricRegistry, Tracer, compile_region,
                             current_region, device_memory_gauges,
                             profiler_session, write_chrome_trace,
                             write_metrics)
from repro_torch.serve import DistanceServer, make_trace
from repro_torch.serve.metrics import KNOWN_LANES, ServeMetrics


@pytest.fixture(scope="module")
def index():
    n, src, dst, w = gen.er_graph(140, 2.4, seed=3)
    return ISLabelIndex.build(n, src, dst, w,
                              IndexConfig(l_cap=128, label_chunk=64),
                              device="cpu")


# ------------------------------------------------- copies against repro
def _record(tr):
    """One request with both children, a half-covered request, a path
    batch's tier spans and two instant events, on one tracer."""
    req = tr.start("request", 0.010, cat="request", trace_id=3,
                   track="lane:mu", lane="mu", s=1, t=2, bucket=8)
    tr.add("queue_wait", 0.010, 0.011, cat="wait", trace_id=3, parent=req,
           track="lane:mu")
    tr.add("device_exec", 0.011, 0.0115, cat="exec", trace_id=3,
           parent=req, track="lane:mu", rounds=4, vid=None)
    tr.end(req, 0.0115)
    half = tr.start("request", 0.02, cat="request", trace_id=4)
    tr.add("queue_wait", 0.02, 0.025, parent=half)
    tr.end(half, 0.03)
    tr.add("tier:h4", 0.04, 0.041, cat="batch", track="lane:path",
           hop_cap=4, bucket=8)
    tr.event("escalate", 0.041, cat="batch", track="lane:path", hop_cap=4)
    tr.event("cache_hit", 0.05, cat="request", trace_id=9,
             track="lane:cache", s=5, t=6)
    tr.start("open", 0.06)                       # never ended: not exported


def test_tracer_matches_repro_on_the_same_spans(tmp_path):
    got, want = Tracer("proc"), JTracer("proc")
    _record(got)
    _record(want)
    assert got.chrome() == want.chrome()
    assert got.request_coverage() == want.request_coverage()
    assert ([(s.name, s.span_id, s.parent_id) for s in got.finished()]
            == [(s.name, s.span_id, s.parent_id) for s in want.finished()])
    a = write_chrome_trace(tmp_path / "a" / "t.json", got)
    b = j_write_chrome_trace(tmp_path / "b" / "t.json", want)
    assert a.read_text() == b.read_text()


def test_span_errors_and_null_tracer():
    tr = Tracer()
    req = tr.start("request", 1.0, cat="request")
    tr.end(req, 2.0)
    with pytest.raises(ValueError):
        tr.end(req, 3.0)
    bad = tr.start("x", 5.0)
    with pytest.raises(ValueError):
        tr.end(bad, 4.0)
    assert NULL_TRACER.enabled is False
    NULL_TRACER.end(NULL_TRACER.start("x", 1.0), 2.0)
    NULL_TRACER.add("y", 0.0, 1.0)
    NULL_TRACER.event("z", 0.0)
    assert NULL_TRACER.spans == [] and NULL_TRACER.events == []


def test_event_log_matches_repro(tmp_path):
    paths = []
    for cls, name in ((EventLog, "port"), (JEventLog, "repro")):
        path = tmp_path / name / "events.jsonl"
        with cls(path, keep=2) as log:
            log.log("start", ts=1.0, mode="distance", n=np.int64(7))
            log.log("batch", ts=2.0, fill=np.float32(0.5),
                    ids=np.arange(3))
            log.log("finish", ts=3.0, failures=0)
            assert [e["kind"] for e in log.recent] == ["batch", "finish"]
        paths.append(path)
    assert paths[0].read_text() == paths[1].read_text()
    assert EventLog.read(paths[0]) == JEventLog.read(paths[1])
    assert [e["seq"] for e in EventLog.read(paths[0])] == [0, 1, 2]


def test_write_metrics_matches_repro(tmp_path):
    docs = []
    for reg_cls, write, name in ((MetricRegistry, write_metrics, "port"),
                                 (JMetricRegistry, j_write_metrics, "repro")):
        reg = reg_cls()
        reg.counter("w.c").inc(4, lane="mu")
        reg.gauge("w.g").set(2.5, device="0")
        reg.histogram("w.h").observe(0.003, server="a")
        p = write(tmp_path / name / "m.json", reg, run="t")
        docs.append(json.loads(p.read_text()))
    assert docs[0] == docs[1]
    assert docs[0]["run"] == "t"


def test_serve_metrics_lane_set_derives_from_observed_batches():
    m = ServeMetrics(server="lane-t")
    assert set(m.snapshot()["lanes"]) == set(KNOWN_LANES)
    m.record_batch("mu", 8, 8, 1e-4, rounds=0)
    m.record_batch("aux", 16, 12, 2e-4, rounds=3)
    lanes = m.snapshot()["lanes"]
    assert set(lanes) == set(KNOWN_LANES) | {"aux"}
    assert lanes["aux"]["requests"] == 12
    assert lanes["aux"]["fill_ratio"] == pytest.approx(0.75)
    assert lanes["path"]["batches"] == 0


def test_serve_metrics_instances_do_not_alias():
    a = ServeMetrics(server="same-name")
    b = ServeMetrics(server="same-name")
    a.record_cache_hit()
    a.record_batch("mu", 8, 5, 1e-4, rounds=0)
    assert a.served == 6 and a.cache_hits == 1
    assert b.served == 0 and b.cache_hits == 0
    assert b.snapshot()["qps_compute"] == 0.0


# ---------------------------------------------------- first-use builds
def test_compile_region_attributes_route_layout_builds():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    w = rng.integers(1, 5, 300).astype(np.float32)
    rel = CoreRelaxer(src, dst, w, 50)
    assert current_region() == "other"
    with BuildWatcher() as watch:
        with compile_region("zone-a"):
            assert current_region() == "zone-a"
            rel.csr()
            rel.csr()                       # cached: no second build
            with compile_region("zone-b"):
                rel.sliced()
                rel.dense_adj()
            rel.coo()
        assert current_region() == "other"
        rel.csr()
        rel.sliced()
        assert watch.snapshot() == {"zone-a": 2, "zone-b": 2}
    assert watch.count("zone-a") == 2 and watch.count() == 4
    rel2 = CoreRelaxer(src, dst, w, 50)
    rel2.csr()                              # after stop: not in the watch
    assert watch.snapshot() == {"zone-a": 2, "zone-b": 2}


def test_chase_planes_and_kernel_library_count_as_builds(index,
                                                          monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.paths import PathEngine
    with BuildWatcher() as watch:
        with compile_region("zone-p"):
            PathEngine.from_index(index)
    assert watch.snapshot() == {"zone-p": 1}
    # the library load, with the build and the loader stood in for (no
    # nvcc here): counted once, on the first call only

    class _Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", lambda: "libstub.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    with BuildWatcher() as watch:
        with compile_region("zone-k"):
            lib = _build.load()
            assert _build.load() is lib
    assert watch.snapshot() == {"zone-k": 1}


def test_server_builds_only_in_warmup(index):
    """A fresh server over a fresh route layout: every build lands in
    ``warmup``; serving and the path lane add none."""
    with BuildWatcher() as watch:
        index.engine.relaxer._coo = None            # built again in warmup
        srv = DistanceServer(index, buckets=(8, 32), max_wait_ms=1.0,
                             path_hop_caps=(8, 64))
        warm = watch.snapshot()
        srv.serve_trace(make_trace("uniform", n=index.n, num_requests=120,
                                   seed=1))
        srv.serve_path_trace(make_trace("hotspot", n=index.n,
                                        num_requests=80, seed=2))
    assert warm.get("warmup", 0) >= 1
    assert watch.snapshot() == warm
    assert watch.count("serve_read") == watch.count("serve_path") == 0


# ------------------------------------------------- engine tracer wiring
def test_traced_serve_full_request_coverage(index, tmp_path):
    tracer = Tracer("test-serve")
    srv = DistanceServer(index, buckets=(8, 32), max_wait_ms=1.0,
                         cache_size=1024, tracer=tracer)
    tr = make_trace("repeated", n=index.n, num_requests=150, pool=40,
                    seed=2, rate_qps=2e4)
    got = srv.serve_trace(tr)
    np.testing.assert_array_equal(got, index.query_host(tr.s, tr.t))
    snap = srv.stats()
    reqs = tracer.by_name("request")
    assert len(reqs) == snap["served"] - snap["cache_hits"]
    hits = [e for e in tracer.events if e["name"] == "cache_hit"]
    assert len(hits) == snap["cache_hits"] > 0
    cov = tracer.request_coverage()
    assert cov["requests"] == len(reqs)
    assert cov["min"] >= 0.99
    assert len({s.trace_id for s in reqs}) == len(reqs)
    doc = json.loads(tracer.write_chrome(tmp_path / "t.json").read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "thread_name"}
    assert any(t.startswith("lane:") for t in tracks)


def test_profiler_session_and_memory_gauges(tmp_path):
    with profiler_session("") as on:
        assert on is False
    with profiler_session(str(tmp_path / "prof")) as on:
        assert on is True
        torch.ones(64).cumsum(0)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]
    reg = MetricRegistry()
    gauges = device_memory_gauges(reg)
    if torch.cuda.is_available():
        assert gauges["device0_bytes_in_use"] >= 0
    else:
        assert gauges == {} and reg.names() == []


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("mode,extra", [
    ("distance", ["--audit", "dijkstra", "--scenario", "hotspot"]),
    ("path", ["--audit", "index", "--hop-caps", "4,32"])])
def test_launcher_exits_zero_on_cpu(mode, extra, tmp_path, capsys):
    from repro_torch.launch.serve import main
    sinks = {"--trace-out": tmp_path / "trace.json",
             "--metrics-out": tmp_path / "metrics.json",
             "--events-out": tmp_path / "events.jsonl"}
    argv = ["--device", "cpu", "--mode", mode, "--graph", "er", "--n",
            "256", "--l-cap", "128", "--queries", "256", "--buckets",
            "16,64", *extra]
    for flag, path in sinks.items():
        argv += [flag, str(path)]
    with pytest.raises(SystemExit) as stop:
        main(argv)
    out = capsys.readouterr().out
    assert stop.value.code == 0, out
    assert "AUDIT FAIL" not in out
    assert "bitwise-equal to ISLabelIndex.query" in out
    if mode == "path":
        assert "256/256 served paths valid" in out
    else:
        assert "256 answers match the oracle" in out
    for path in sinks.values():
        assert path.exists()
    events = EventLog.read(sinks["--events-out"])
    assert [e["kind"] for e in events][-1] == "finish"
    assert events[-1]["failures"] == 0
    metrics = json.loads(sinks["--metrics-out"].read_text())
    assert "serve.served" in metrics["metrics"]


def test_launcher_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--graph", "er", "--n", "64", "--queries", "8"])
