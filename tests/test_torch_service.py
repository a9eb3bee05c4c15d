"""The replicated HTTP service of the PyTorch port against ``repro``'s:
straggler detection (``fault/stragglers.py``), the SLO burn-rate engine
(``obs/slo.py``), replica groups (``serve/replicas.py``), the asyncio
front end (``serve/frontend.py``) and the launcher's ``--mode http``.

The monitor, aggregator and SLO cases of ``tests/test_fault.py`` and
``tests/test_slo.py`` run against both packages' modules, with equal
verdicts, burns and alert sequences. Replica groups replay the same
traces in both packages over indexes of ``tests/test_frontend.py``'s
graph (``er_graph(120, 2.4, seed=5)`` + 6 spares, ``l_cap=96``) built
with JAX's MIS permutations. One port front end runs for the module on
an ephemeral localhost port, over a versioned server.
"""
from __future__ import annotations

import http.client
import json
import time
import types

import numpy as np
import pytest

import repro.fault.stragglers as j_stragglers
import repro.obs as j_obs
import repro_torch.fault.stragglers as t_stragglers
import repro_torch.obs as t_obs
from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro.serve import ReplicaSet as JReplicaSet
from repro.serve import make_trace as j_make_trace
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.obs import (REGISTRY, BuildWatcher, EventLog, SLOEngine,
                             compile_region, compiles_source,
                             default_serving_slos, record_build)
from repro_torch.serve import (HttpClient, IndexRegistry, MutationOp,
                               ReplicaSet, ServiceFrontend, SSEReader,
                               make_trace)
from test_frontend import _far_pair, parse_prometheus
from test_torch_build import jax_perms

FAULT = {"repro": j_stragglers, "port": t_stragglers}
SLO = {"repro": j_obs, "port": t_obs}
# objective 0.75 -> budget exactly 0.25 in binary: threshold ties are
# representable without rounding (tests/test_slo.py)
EXACT = dict(objective=0.75, fast_window_s=10.0, slow_window_s=40.0,
             fast_burn=2.0, slow_burn=0.5, resolve_hold_s=5.0)


# -------------------------------------------------------- stragglers
def _monitor_cases(m):
    """test_fault.py's monitor and aggregator cases on module ``m``;
    returns every verdict and the aggregator outputs."""
    out = {}
    mon = m.StragglerMonitor()
    out["seed"] = (mon.record(0.25), mon.ema)
    assert out["seed"] == ({"straggler": False, "evict": False,
                            "ratio": 1.0}, 0.25)
    mon = m.StragglerMonitor(alpha=0.2, threshold=1.5, evict_after=3)
    mon.record(1.0)
    out["streak"] = [mon.record(2.0) for _ in range(3)]
    assert [v["evict"] for v in out["streak"]] == [False, False, True]
    assert mon.ema == 1.0
    mon = m.StragglerMonitor(alpha=0.5, threshold=1.5, evict_after=3)
    out["recovery"] = [mon.record(x) for x in (1.0, 2.0, 2.0, 1.0, 2.0,
                                               2.0, 2.0)]
    assert [v["evict"] for v in out["recovery"]][-1]
    mon = m.StragglerMonitor(alpha=0.25, threshold=10.0)
    for x in (1.0, 2.0, 1.0, 4.0):
        mon.record(x)
    out["ema"] = (mon.ema, [h[0] for h in mon.history])
    assert mon.ema == pytest.approx(0.75 * (0.75 * (0.75 + 0.5) + 0.25)
                                    + 1.0)
    mon = m.StragglerMonitor(evict_after=2)
    out["script"] = [mon.record(x) for x in (1.0, 1.1, 3.0, 0.9, 3.0, 3.0,
                                             1.0)]
    agg = m.HostTimingAggregator(threshold=1.3)
    for _ in range(4):
        for h, x in [("h0", 1.0), ("h1", 1.0), ("h2", 1.0), ("h3", 2.0)]:
            agg.record(h, x)
    out["fleet"] = agg.stragglers()
    assert out["fleet"] == ["h3"]
    agg = m.HostTimingAggregator()
    out["empty"] = agg.stragglers()
    for h in ("a", "b"):
        agg.record(h, 1.0)
    out["uniform"] = agg.stragglers()
    assert out["empty"] == out["uniform"] == []
    return out


@pytest.mark.parametrize("mod", sorted(FAULT))
def test_straggler_verdicts_equal_repro(mod):
    assert _monitor_cases(FAULT[mod]) == _monitor_cases(j_stragglers)


# --------------------------------------------------------------- SLO
def _engine(m, *specs, log=None):
    return m.SLOEngine(specs, log=log, registry=m.MetricRegistry())


def _states(eng):
    return {n: (st.firing, st.fires, st.resolves, st.burn_fast,
                st.burn_slow, st.max_burn_fast, st.max_burn_slow)
            for n, st in eng.states.items()}


def _slo_windows(m):
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    out = [eng.evaluate(100.0), _states(eng)]
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    eng.record("a", 0.0, good=10)
    eng.record("a", 20.0, bad=10)
    st = eng.states["a"]
    out += [st.window_rate(20.0, 10.0), st.window_rate(20.0, 40.0)]
    assert out[-2:] == [(1.0, 10), (0.5, 20)]
    eng = _engine(m, m.SLOSpec("a", min_events=10, **EXACT))
    eng.record("a", 1.0, bad=5)
    out.append(eng.evaluate(1.0))
    eng.record("a", 2.0, bad=5)
    out.append(eng.evaluate(2.0))
    assert [e["state"] for e in out[-1]] == ["fire"]
    return out


def _slo_threshold_and_windows(m):
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    eng.record("a", 1.0, good=2, bad=2)          # burn exactly 2.0
    out = [eng.evaluate(1.0), _states(eng)]
    assert out[0] == [] and eng.states["a"].burn_fast == 2.0
    eng.record("a", 2.0, bad=1)
    out.append(eng.evaluate(2.0))
    assert [e["state"] for e in out[-1]] == ["fire"]
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    eng.record("a", 0.0, good=1000)
    eng.record("a", 35.0, bad=4)                 # slow window stays quiet
    out += [eng.evaluate(35.0), _states(eng)]
    assert out[-2] == []
    return out


def _slo_hysteresis(m):
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    eng.record("a", 1.0, bad=4)
    out = [eng.evaluate(1.0)]
    eng.record("a", 2.0, good=100)
    out += [eng.evaluate(x) for x in (2.0, 5.9, 6.0, 8.0)]
    assert [[e["state"] for e in ev] for ev in out] == [
        ["fire"], [], [], ["resolve"], []]
    eng.record("a", 30.0, bad=400)
    out.append(eng.evaluate(30.0))
    out.append(_states(eng))
    assert eng.states["a"].fires == 2 and eng.states["a"].resolves == 1
    return out


def _slo_rules(m):
    out = []
    for kw, match in ((dict(objective=1.0), "objective"),
                      (dict(objective=0.0), "objective"),
                      (dict(fast_window_s=60.0, slow_window_s=30.0),
                       "fast window")):
        with pytest.raises(ValueError, match=match):
            m.SLOSpec("x", **kw)
    out.append(m.SLOSpec("x", objective=0.75).budget)
    with pytest.raises(ValueError, match="duplicate"):
        _engine(m, m.SLOSpec("a"), m.SLOSpec("a"))
    eng = _engine(m, m.SLOSpec("a", **EXACT))
    eng.record("a", 10.0, good=1)
    with pytest.raises(ValueError, match="monotonic"):
        eng.record("a", 5.0, good=1)
    with pytest.raises(KeyError, match="unknown SLO"):
        eng.attach("nope", lambda: (0, 0))
    return out


def _slo_sources(m):
    reg = m.MetricRegistry()
    ok, err = reg.counter("t.ok", ""), reg.counter("t.err", "")
    probe = m.counter_source("t.ok", "t.err", registry=reg)
    out = [probe()]
    ok.inc(7)
    err.inc(3)
    out.append(probe())
    h = reg.histogram("serve.latency_seconds", "", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5):
        h.observe(v, server="a", sid="1")
    h.observe(5.0, server="b", sid="1")
    out += [m.latency_source(0.1, registry=reg)(),
            m.latency_source(0.1, registry=reg, servers=["a"])(),
            m.latency_source(0.1, registry=reg, metric="missing")()]
    assert out == [(0, 0), (7, 10), (2, 4), (2, 3), (0, 0)]

    class FakeWatcher:
        supported = True

        def count(self, region):
            return {"serve_read": 2}.get(region, 0)

    out += [m.compiles_source(FakeWatcher())(),
            m.compiles_source(FakeWatcher(), region="other")()]
    FakeWatcher.supported = False
    out.append(m.compiles_source(FakeWatcher())())
    assert out[-3:] == [(0, 2), (0, 0), (0, 0)]
    eng = _engine(m, m.SLOSpec("a", min_events=1, **EXACT))
    bad = {"n": 0}
    eng.attach("a", lambda: (0, bad["n"]))
    out.append(eng.step(1.0))
    bad["n"] = 4
    out.append(eng.step(2.0))
    assert [e["state"] for e in out[-1]] == ["fire"]
    return out


def _slo_events_and_digest(m):
    log = m.EventLog()
    reg = m.MetricRegistry()
    eng = m.SLOEngine([m.SLOSpec("a", **EXACT), m.SLOSpec("b", **EXACT)],
                      log=log, registry=reg)
    eng.record("a", 1.0, bad=4)
    (ev,) = eng.evaluate(1.0)
    assert log.recent[-1] is ev and json.loads(json.dumps(ev)) == ev
    out = [ev, reg.get("slo.burn_rate").value(slo="a", window="fast"),
           reg.get("slo.firing").value(slo="a"),
           reg.get("slo.alerts").total()]
    eng.record("a", 2.0, good=100)
    eng.evaluate(7.0)
    out += [eng.breach_summary(), eng.snapshot()]
    assert out[-2]["fired"] == ["a"] and out[-2]["firing"] == []
    specs = m.default_serving_slos(fast_window_s=1.0, slow_window_s=4.0)
    eng = m.SLOEngine(specs, registry=m.MetricRegistry())

    class OneCompile:
        supported = True

        def count(self, region):
            return 1

    eng.attach("read_compiles", m.compiles_source(OneCompile()))
    out += [[s.name for s in specs], eng.step(0.5)]
    assert [(e["slo"], e["state"]) for e in out[-1]] == \
        [("read_compiles", "fire")]
    return out


SLO_CASES = {f.__name__[5:]: f for f in (
    _slo_windows, _slo_threshold_and_windows, _slo_hysteresis, _slo_rules,
    _slo_sources, _slo_events_and_digest)}


@pytest.mark.parametrize("mod", sorted(SLO))
@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_engine_equals_repro(case, mod):
    """Each of test_slo.py's engine cases on both packages: the same
    alert events, states, burns and digests."""
    assert SLO_CASES[case](SLO[mod]) == SLO_CASES[case](j_obs)


def test_compiles_source_reads_the_build_watcher():
    with REGISTRY.isolated():
        with BuildWatcher() as watch:
            probe = compiles_source(watch)
            assert probe() == (0, 0)
            with compile_region("serve_read"):
                record_build("relax_layout:csr")
            record_build("relax_layout:csr")        # region "other"
            assert probe() == (0, 1)
            assert compiles_source(watch, region="other")() == (0, 1)


# ---------------------------------------------------------- replicas
@pytest.fixture(scope="module")
def indexes():
    n, src, dst, w = gen.er_graph(120, 2.4, seed=5)
    cfg = dict(l_cap=96, label_chunk=64)
    j_idx = JIndex.build(n + 6, src, dst, w, JConfig(**cfg))
    t_idx = ISLabelIndex.build(n + 6, src, dst, w, IndexConfig(**cfg),
                               device="cpu", perms=jax_perms(0, n + 6))
    return j_idx, t_idx


def _replicas(pkg, idx):
    """A clean uniform replay on one group and a straggler replay on a
    fresh group (its replica 0 stalled from the first batch). The
    timings feed the straggler monitors floored at 0.5 s, so only the
    injected stall moves a verdict."""
    group, trace, extra = ((JReplicaSet, j_make_trace,
                            dict(backend="reference")) if pkg == "repro"
                           else (ReplicaSet, make_trace, {}))
    reg = (j_obs if pkg == "repro" else t_obs).MetricRegistry()
    kw = dict(buckets=(8, 32), max_wait_ms=1.0, cache_size=4096,
              min_step_s=0.5, registry=reg, **extra)
    out = {}
    rs = group(idx, 2, name="clean", **kw)
    tr = trace("uniform", n=idx.n, num_requests=256, rate_qps=2e4, seed=1)
    out["clean"] = rs.serve_trace(tr)
    out["clean_batches"] = [len(s.metrics.batches) for s in rs.replicas]
    out["clean_healthy"] = list(rs.healthy)
    rs = group(idx, 2, name="strag", **kw)
    tr = trace("straggler", n=idx.n, num_requests=512, rate_qps=2e4, seed=2,
               stall_replica=0, stall_s=5.0)
    out["strag"] = rs.serve_trace(tr)
    out["strag_batches"] = [len(s.metrics.batches) for s in rs.replicas]
    out["strag_healthy"] = list(rs.healthy)
    out["evictions"] = reg.get("serve.replica_evictions").total()
    st = rs.stats()
    out["fleet"] = st["fleet_stragglers"]
    out["served"] = st["served"]
    return out


def test_replica_set_equals_repro(indexes):
    j_idx, t_idx = indexes
    got, want = _replicas("port", t_idx), _replicas("repro", j_idx)
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key], key)
        else:
            assert got[key] == want[key], key
    np.testing.assert_array_equal(got["clean"], t_idx.query_host(
        *_trace_pairs(t_idx.n, "uniform", 256, 1)))
    assert got["clean_healthy"] == [True, True]
    assert got["strag_healthy"] == [False, True] and got["evictions"] == 1


def _trace_pairs(n, scenario, requests, seed):
    tr = make_trace(scenario, n=n, num_requests=requests, rate_qps=2e4,
                    seed=seed)
    return tr.s, tr.t


# --------------------------------------------------------- front end
@pytest.fixture(scope="module")
def stack(indexes):
    with REGISTRY.isolated():
        idx = indexes[1]
        registry = IndexRegistry()
        registry.register("default", idx, buckets=(8, 32),
                          max_wait_ms=1.0, versioned=True)
        log = EventLog()
        slo = SLOEngine(
            default_serving_slos(latency_threshold_s=1.0,
                                 fast_window_s=2.0, slow_window_s=8.0,
                                 resolve_hold_s=1.0),
            log=log)
        fe = ServiceFrontend(registry, slo=slo, log=log,
                             sse_interval_s=0.05, heartbeat_s=0.3)
        host, port = fe.start_background()
        yield {"fe": fe, "host": host, "port": port, "idx": idx,
               "log": log, "slo": slo}
        fe.stop()


@pytest.fixture()
def client(stack):
    with HttpClient(stack["host"], stack["port"]) as c:
        yield c


def test_healthz_and_unknown_route(stack, client):
    out = client.healthz()
    assert out["ok"] is True and out["uptime_s"] >= 0.0
    with pytest.raises(RuntimeError, match="404"):
        client._call("GET", "/nope")


def test_query_single_and_batch_equal_the_index(stack, client):
    idx = stack["idx"]
    rng = np.random.default_rng(7)
    s = rng.integers(0, idx.n, 24)
    t = rng.integers(0, idx.n, 24)
    want = idx.query_host(s, t)
    got_one = np.asarray([client.query(int(a), int(b))[0]
                          for a, b in zip(s, t)], np.float32)
    got_batch = client.query_batch(list(zip(s.tolist(), t.tolist())))
    assert not np.isfinite(want).all()       # Infinity crosses the wire
    for got in (got_one, got_batch):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bad_requests_map_to_http_errors(stack, client):
    with pytest.raises(RuntimeError, match="400"):
        client._call("POST", "/query", {"s": 1})
    with pytest.raises(RuntimeError, match="404"):
        client._call("POST", "/query", {"graph": "nope", "s": 0, "t": 1})
    with pytest.raises(RuntimeError, match="400"):
        client._call("POST", "/mutate", {"ops": []})
    with pytest.raises(RuntimeError, match="400"):
        client._call("POST", "/path", {"s": 0, "t": 1})
    conn = http.client.HTTPConnection(stack["host"], stack["port"],
                                      timeout=10)
    conn.request("POST", "/query", body=b"{not json",
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    assert "bad JSON" in json.loads(resp.read())["error"]
    conn.close()


def test_mutate_advances_version_and_reads_observe_it(stack, client):
    idx = stack["idx"]
    a, b, d_old = _far_pair(types.SimpleNamespace(
        core_ids=idx.core_ids, query=idx.query_host))
    u = idx.n - 1                                  # last spare, not core
    ans0, vid0 = client.query(a, b)
    assert ans0 == d_old
    vid1 = client.mutate([MutationOp("insert", u, (a, b), (1.0, 1.0))])
    assert vid1 == vid0 + 1
    ans1, vid_now = client.query(a, b)
    assert vid_now == vid1 and ans1 == np.float32(2.0)
    vid2 = client.mutate([MutationOp("delete", u)])
    ans2, _ = client.query(a, b)
    assert vid2 == vid1 + 1 and ans2 == d_old


def test_stats_and_metrics(stack, client):
    out = client.stats()
    assert out["uptime_s"] > 0.0 and "default" in out["graphs"]
    assert set(out["slo"]) == {"availability", "latency", "exactness",
                               "read_compiles"}
    assert out["slo_breaches"]["fired"] == []
    types_, samples = parse_prometheus(client.metrics_text())
    assert types_["http_requests"] == "counter"
    assert types_["serve_latency_seconds"] == "histogram"
    assert sum(v for (name, labels), v in samples.items()
               if name == "http_requests"
               and dict(labels).get("route") == "/query") > 0


def test_sse_frames_heartbeats_and_a_live_alert(stack, client):
    fe, slo = stack["fe"], stack["slo"]
    reader = SSEReader(stack["host"], stack["port"], timeout_s=10.0)
    try:
        client.query(0, 1)
        events = reader.read_events(max_events=8, max_s=5.0)
        frames = [d for e, d in events if e == "metrics"]
        assert frames and frames[0]["graphs"]["default"]["served"] > 0
        more = reader.read_events(max_events=24, max_s=3.0)
        assert ("comment", None) in more
        fe._loop.call_soon_threadsafe(
            lambda: slo.record("exactness", fe._now(), bad=5))
        deadline = time.monotonic() + 8.0
        alerts = []
        while not alerts and time.monotonic() < deadline:
            alerts = [d for e, d in reader.read_events(max_events=8,
                                                       max_s=2.0)
                      if e == "slo_alert"]
        assert alerts and alerts[0]["slo"] == "exactness"
        assert alerts[0]["state"] == "fire"
    finally:
        reader.close()


@pytest.mark.parametrize("scenario,extra,expect", [
    ("straggler", ["--n", "256", "--replicas", "2"],
     ["audit[slo-fire]: latency burn-rate alert fired",
      "evicted replicas: ['default/r0']"]),
    ("readwrite", ["--n", "128", "--queries", "256", "--spares", "8",
                   "--write-ratio", "0.06"],
     ["bitwise-equal to the in-process replay",
      "audit[slo-quiet]: no alert fired"])])
def test_launcher_http_modes_exit_zero(scenario, extra, expect, capsys):
    """``--mode http`` with ``--device cpu``: a straggler run fires the
    latency SLO and evicts the stalled replica; a readwrite run serves
    a versioned index over the wire, equal to the in-process replay."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as stop:
        main(["--device", "cpu", "--mode", "http", "--graph", "er",
              "--l-cap", "128", "--scenario", scenario, "--audit", "index",
              *extra])
    out = capsys.readouterr().out
    assert stop.value.code == 0, out
    assert "AUDIT FAIL" not in out
    for line in expect:
        assert line in out
