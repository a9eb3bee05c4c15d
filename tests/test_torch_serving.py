"""The serving engine of the PyTorch port (``repro_torch.serve``) against
``repro.serve``.

``repro`` builds and saves the indexes; the port loads the files on the
CPU (``test_torch_paths._load``'s pattern). Covered: the copied batcher,
cache and load generator (``make_trace`` field by field against
``repro``'s), served answers bitwise equal to ``ISLabelIndex.query`` on
every scenario, zero first-use builds and unchanged shape counts after
warmup (exactly {"mu": 2, "full": 2} on a private index), cache hits,
μ routing, the metrics snapshot, the low-level submit/pump API, the
registry, save/load over both backends, ``refresh`` after
``delete_vertex``, wall-clock pumps, one counted sync per distance
batch, and parity with ``repro``'s ``DistanceServer`` on the same trace
(answers, lanes, batches per lane and bucket, cache hits, and the
``PathAnswer``s of the path lane at hop caps 4 and 32, escalation
included). Then ``classify``, ``query_types`` and ``query_host`` on
numpy arrays, scalars and CPU tensors against ``repro``'s. Tolerance:
bitwise.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro.serve import DistanceServer as JServer
from repro.serve import make_trace as j_make_trace
from repro.serve import mu_exact_mask as j_mu_exact_mask
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.core.dispatch import CoreRelaxer
from repro_torch.core.sync import sync_span
from repro_torch.obs import BuildWatcher
from repro_torch.serve import (DistanceServer, IndexRegistry, LRUCache,
                               MicroBatcher, MutationOp, PathAnswer,
                               PendingRequest, make_trace, mu_exact_mask)

BUCKETS = (8, 32)
SCENARIOS = ["uniform", "hotspot", "bursty", "repeated"]


def _load(tmp_path_factory, name, n, src, dst, w, **cfg):
    j_idx = JIndex.build(n, src, dst, w, JConfig(**cfg))
    path = tmp_path_factory.mktemp(name)
    j_idx.save(path)
    return j_idx, ISLabelIndex.load(path, device="cpu")


@pytest.fixture(scope="module")
def graph():
    # sparse ER: small components exist, so the μ-only lane sees real
    # traffic (routing is exercised)
    return gen.er_graph(700, 2.2, seed=2)


@pytest.fixture(scope="module")
def pair(graph, tmp_path_factory):
    return _load(tmp_path_factory, "er700", *graph, l_cap=256)


@pytest.fixture(scope="module")
def index(pair):
    return pair[1]


@pytest.fixture(scope="module")
def server(index):
    return DistanceServer(index, buckets=BUCKETS, max_wait_ms=1.0,
                          cache_size=4096)


def _want(index, tr):
    return index.query_host(tr.s, tr.t)


# --------------------------------------------------------------- batcher
def _reqs(ts):
    return [PendingRequest(i, i, i, t) for i, t in enumerate(ts)]


def test_batcher_full_bucket_flush():
    mb = MicroBatcher(buckets=(4, 8), max_wait_s=1.0)
    for r in _reqs([0.0] * 9):
        mb.add(r)
    b = mb.drain(now=0.0)
    assert b.bucket == 8 and len(b.requests) == 8 and b.fill == 1.0
    assert mb.drain(now=0.0) is None and len(mb) == 1


def test_batcher_deadline_flush_pads_to_smallest_bucket():
    mb = MicroBatcher(buckets=(4, 8), max_wait_s=0.010)
    for r in _reqs([0.0, 0.001, 0.002]):
        mb.add(r)
    assert mb.drain(now=0.005) is None
    b = mb.drain(now=0.011)
    assert b is not None and b.bucket == 4 and len(b.requests) == 3
    assert b.t_flush == pytest.approx(0.010)
    assert mb.drain(now=1.0) is None


def test_batcher_force_flush_and_bucket_choice():
    mb = MicroBatcher(buckets=(4, 8), max_wait_s=10.0)
    for r in _reqs([0.0] * 6):
        mb.add(r)
    b = mb.drain(now=0.0, force=True)
    assert b.bucket == 8 and len(b.requests) == 6
    assert mb.next_deadline() is None


def test_batcher_rejects_bad_buckets():
    with pytest.raises(ValueError):
        MicroBatcher(buckets=())
    with pytest.raises(ValueError):
        MicroBatcher(buckets=(0, 4))


# ----------------------------------------------------------------- cache
def test_lru_cache_eviction_and_hit_rate():
    c = LRUCache(2)
    c.put(1, 2, 5.0)
    c.put(3, 4, 7.0)
    assert c.get(1, 2) == 5.0
    c.put(5, 6, 9.0)
    assert c.get(3, 4) is None
    assert c.get(1, 2) == 5.0 and c.get(5, 6) == 9.0
    assert c.hits == 3 and c.misses == 1 and len(c) == 2


def test_lru_cache_symmetric_and_disabled():
    c = LRUCache(8, symmetric=True)
    c.put(2, 1, 3.0)
    assert c.get(1, 2) == 3.0
    off = LRUCache(0)
    off.put(1, 2, 3.0)
    assert off.get(1, 2) is None and len(off) == 0


# --------------------------------------------------------------- loadgen
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_loadgen_traces_well_formed(scenario):
    tr = make_trace(scenario, n=500, num_requests=300, rate_qps=1e4, seed=1)
    assert len(tr) == 300 and tr.name == scenario
    assert np.all(np.diff(tr.arrival_s) >= 0) and tr.arrival_s[0] >= 0
    for arr in (tr.s, tr.t):
        assert arr.dtype == np.int32
        assert arr.min() >= 0 and arr.max() < 500


@pytest.mark.parametrize("scenario,kw", [
    ("uniform", {}), ("hotspot", {}), ("bursty", {}),
    ("repeated", {"pool": 40}),
    ("straggler", {"stall_replica": 1, "stall_s": 0.5}),
    ("readwrite", {"write_ratio": 0.1, "n_read": 480,
                   "spares": range(480, 500), "attach_to": range(0, 60)})])
def test_loadgen_matches_repro_field_by_field(scenario, kw):
    got = make_trace(scenario, n=500, num_requests=400, rate_qps=3e4,
                     seed=9, **kw)
    want = j_make_trace(scenario, n=500, num_requests=400, rate_qps=3e4,
                        seed=9, **kw)
    assert got.name == want.name and got.meta == want.meta
    assert got.span_s == want.span_s
    for f in ("arrival_s", "s", "t"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if want.writes is None:
        assert got.writes is None
    else:
        assert [None if w is None else [tuple(op) for op in w]
                for w in got.writes] == [
            None if w is None else [tuple(op) for op in w]
            for w in want.writes]


def test_loadgen_scenario_shapes():
    hot = make_trace("hotspot", n=2000, num_requests=1000, seed=1)
    uni = make_trace("uniform", n=2000, num_requests=1000, seed=1)
    assert len(np.unique(hot.s)) < 0.5 * len(np.unique(uni.s))
    rep = make_trace("repeated", n=2000, num_requests=1000, pool=64, seed=1)
    assert len({(int(a), int(b)) for a, b in zip(rep.s, rep.t)}) <= 64
    with pytest.raises(ValueError):
        make_trace("nope", n=10, num_requests=1)


# --------------------------------------------------- serving exactness
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_serve_trace_matches_index_bitwise(index, server, scenario):
    tr = make_trace(scenario, n=index.n, num_requests=300, rate_qps=2e4,
                    seed=4)
    got = server.serve_trace(tr)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _want(index, tr))


def test_zero_builds_and_shapes_after_warmup(index, server):
    sizes = server.compile_cache_sizes()
    assert all(n >= len(BUCKETS) for n in sizes.values())
    tr = make_trace("bursty", n=index.n, num_requests=400, rate_qps=5e4,
                    seed=5)
    with BuildWatcher() as w:
        server.serve_trace(tr)
    assert w.count("serve_read") == 0 and w.count() == 0
    assert server.compile_cache_sizes() == sizes


def test_zero_builds_exact_counts_on_private_index():
    # an index served by exactly one server: one shape per (lane, bucket)
    n, src, dst, w = gen.er_graph(200, 3.0, seed=4)
    idx = ISLabelIndex.build(n, src, dst, w,
                             IndexConfig(l_cap=128, label_chunk=64),
                             device="cpu")
    with BuildWatcher() as warm:
        srv = DistanceServer(idx, buckets=(8, 16), max_wait_ms=1.0)
    assert warm.snapshot() == {"warmup": 1}      # the route's COO layout
    assert srv.compile_cache_sizes() == {"mu": 2, "full": 2}
    with BuildWatcher() as serve:
        srv.serve_trace(make_trace("uniform", n=n, num_requests=150,
                                   seed=5))
    assert serve.snapshot() == {}
    assert srv.compile_cache_sizes() == {"mu": 2, "full": 2}


def test_cache_hits_on_repeated_traffic(index):
    srv = DistanceServer(index, buckets=BUCKETS, max_wait_ms=1.0,
                         cache_size=4096)
    tr = make_trace("repeated", n=index.n, num_requests=400, pool=50, seed=6)
    got = srv.serve_trace(tr)
    assert srv.metrics.snapshot()["cache_hit_rate"] > 0.5
    np.testing.assert_array_equal(got, _want(index, tr))


def test_routing_sends_mu_exact_traffic_to_fast_lane(pair, server):
    j_idx, index = pair
    no_core = mu_exact_mask(index)
    np.testing.assert_array_equal(no_core, j_mu_exact_mask(j_idx))
    assert no_core[:index.n].any() and not no_core[:index.n].all()
    s = np.flatnonzero(no_core[:index.n])[:4].astype(np.int64)
    t = np.full_like(s, int(np.flatnonzero(~no_core[:index.n])[0]))
    assert list(server.route(s, t)) == ["mu"] * len(s)
    cs = np.flatnonzero(~no_core[:index.n])[:4].astype(np.int64)
    assert list(server.route(cs, cs[::-1])) == ["full"] * len(cs)


def test_serve_metrics_snapshot_and_json(index, server):
    tr = make_trace("uniform", n=index.n, num_requests=200, rate_qps=2e4,
                    seed=7)
    server.serve_trace(tr)
    snap = server.metrics.snapshot()
    for key in ("served", "qps_compute", "qps_offered", "latency_ms",
                "batch_fill_ratio", "cache_hit_rate", "lanes",
                "bucket_counts"):
        assert key in snap
    assert snap["served"] > 0 and snap["qps_compute"] > 0
    assert 0 < snap["batch_fill_ratio"] <= 1
    assert set(snap["lanes"]) == {"mu", "full", "path"}
    doc = json.loads(server.metrics.to_json(extra_field=1))
    assert doc["extra_field"] == 1 and doc["served"] == snap["served"]
    stats = server.stats()
    assert stats["versions"] is None and stats["graph"]["shards"] == 1


def test_submit_pump_low_level_api(index):
    srv = DistanceServer(index, buckets=BUCKETS, max_wait_ms=1.0,
                         cache_size=16)
    r1 = srv.submit(1, 2, now=0.0)
    assert srv.take_result(r1) is None
    assert srv.pump(now=0.0) == 0
    assert srv.pump(now=0.002) == 1
    v1 = srv.take_result(r1)
    assert v1 == float(index.query_host(1, 2)[0])
    r2 = srv.submit(1, 2, now=0.003)            # cache hit: immediate
    assert srv.take_result(r2) == v1


def test_batches_upload_int32_to_the_index_device(index, server):
    mb = MicroBatcher(BUCKETS, 1.0)
    for r in _reqs([0.0] * 5):
        mb.add(r)
    reqs, p, s, t = server._batch_arrays(mb.drain(0.0, force=True))
    assert p == 5 and len(reqs) == 5
    for x in (s, t):
        assert x.dtype == torch.int32 and x.device == index.device
        assert x.shape == (8,) and x[5:].eq(x[4]).all()   # edge padding


# -------------------------------------------------------------- registry
def test_registry_hosts_multiple_named_indexes(index, tmp_path):
    index.save(tmp_path / "g")
    reg = IndexRegistry()
    reg.register("live", index, buckets=BUCKETS, warmup=False)
    reg.register("loaded", ISLabelIndex.load(tmp_path / "g", device="cpu"),
                 buckets=BUCKETS, warmup=False)
    assert reg.names() == ["live", "loaded"] and len(reg) == 2
    tr = make_trace("uniform", n=index.n, num_requests=60, rate_qps=2e4,
                    seed=8)
    a = reg.get("live").serve_trace(tr)
    b = reg.get("loaded").serve_trace(tr)
    np.testing.assert_array_equal(a, b)
    stats = reg.stats()
    assert stats["live"]["served"] == stats["loaded"]["served"] == 60
    reg.unregister("loaded")
    assert "loaded" not in reg
    with pytest.raises(KeyError):
        reg.get("loaded")


# ------------------------------------- save/load round trip × backends
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_save_load_serve_round_trip_across_backends(index, tmp_path,
                                                    backend):
    """A loaded index served through the subsystem answers bitwise as
    the one it was saved from, on both backends (``cuda`` runs the
    kernels' plain versions on CPU tensors)."""
    index.save(tmp_path / "idx")
    loaded = ISLabelIndex.load(tmp_path / "idx", device="cpu")
    tr = make_trace("hotspot", n=index.n, num_requests=120, rate_qps=2e4,
                    seed=9)
    fresh = DistanceServer(index, buckets=(16,), max_wait_ms=1.0,
                           backend=backend)
    again = DistanceServer(loaded, buckets=(16,), max_wait_ms=1.0,
                           backend=backend)
    a = fresh.serve_trace(tr)
    np.testing.assert_array_equal(a, again.serve_trace(tr))
    np.testing.assert_array_equal(a, _want(index, tr))


def test_refresh_after_index_mutation(tmp_path_factory):
    # own tiny index in both packages: the §8.3 mutators change it in place
    n, src, dst, w = gen.er_graph(200, 3.0, seed=3)
    j_idx, idx = _load(tmp_path_factory, "er200", n, src, dst, w,
                       l_cap=128, label_chunk=64)
    srv = DistanceServer(idx, buckets=(16,), max_wait_ms=1.0,
                         cache_size=1024)
    j_srv = JServer(j_idx, buckets=(16,), max_wait_ms=1.0, cache_size=1024)
    tr = make_trace("repeated", n=n, num_requests=80, pool=30, seed=10)
    srv.serve_trace(tr)                      # populates the cache
    j_srv.serve_trace(tr)
    u = int(np.flatnonzero(idx.level < idx.k)[0])
    idx.delete_vertex(u)
    j_idx.delete_vertex(u)
    srv.refresh()
    j_srv.refresh()
    assert len(srv.cache) == 0
    np.testing.assert_array_equal(mu_exact_mask(idx), j_mu_exact_mask(j_idx))
    got = srv.serve_trace(tr)
    np.testing.assert_array_equal(got, _want(idx, tr))
    np.testing.assert_array_equal(got, j_srv.serve_trace(tr))


def test_wall_clock_pump_never_records_negative_latency(index):
    srv = DistanceServer(index, buckets=(8,), max_wait_ms=1.0,
                         cache_size=0)
    srv.submit(1, 2, now=0.0)
    srv.submit(3, 4, now=0.005)   # arrives after the oldest's deadline
    assert srv.pump(now=0.005, force=True) == 2
    assert all(lat >= 0 for lat in srv.metrics.latencies)


def test_not_ported_modes_raise(index):
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        DistanceServer(index, versioned=True, warmup=False)
    srv = DistanceServer(index, buckets=(8,), warmup=False)
    with pytest.raises(ValueError, match="not versioned"):
        srv.submit_mutation([MutationOp("delete", 3)], now=0.0)
    with pytest.raises(ValueError, match="versioned=True"):
        srv.serve_readwrite_trace(make_trace("uniform", n=index.n,
                                             num_requests=4))


# ------------------------------------------------------ host syncs
def test_one_counted_sync_per_distance_batch(index):
    """On the fused route (no relaxation loop on the host) and on the μ
    lane, a batch's only blocking read is its result read."""
    eng = index.engine
    rel = eng.relaxer
    saved = rel
    eng.relaxer = CoreRelaxer(rel.ce_src, rel.ce_dst, rel.ce_w, rel.n_core,
                              dense_threshold=2.0)
    try:
        assert eng.relaxer.mode == "fused"
        srv = DistanceServer(index, buckets=BUCKETS, max_wait_ms=1.0,
                             cache_size=0, backend="cuda")
        tr = make_trace("uniform", n=index.n, num_requests=200,
                        rate_qps=2e4, seed=11)
        with sync_span() as span:
            got = srv.serve_trace(tr)
        lanes = {b.lane for b in srv.metrics.batches}
        assert lanes == {"mu", "full"}
        assert span.count == len(srv.metrics.batches)
        np.testing.assert_array_equal(got, _want(index, tr))
    finally:
        eng.relaxer = saved


# ----------------------------------------------- parity with repro's server
def _lane_buckets(metrics) -> dict:
    out: dict = {}
    for b in metrics.batches:
        out[(b.lane, b.bucket)] = out.get((b.lane, b.bucket), 0) + 1
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_parity_with_repro_server(pair, scenario):
    j_idx, index = pair
    kw = dict(buckets=BUCKETS, max_wait_ms=1.0, cache_size=4096)
    srv, j_srv = DistanceServer(index, **kw), JServer(j_idx, **kw)
    tr = make_trace(scenario, n=index.n, num_requests=300, rate_qps=2e4,
                    seed=12)
    np.testing.assert_array_equal(srv.route(tr.s, tr.t),
                                  j_srv.route(tr.s, tr.t))
    got, want = srv.serve_trace(tr), j_srv.serve_trace(tr)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert _lane_buckets(srv.metrics) == _lane_buckets(j_srv.metrics)
    a, b = srv.metrics.snapshot(), j_srv.metrics.snapshot()
    for key in ("served", "cache_hits", "batches", "bucket_counts",
                "query_types"):
        assert a[key] == b[key], key
    assert ({k: v["rounds_per_batch"] for k, v in a["lanes"].items()}
            == {k: v["rounds_per_batch"] for k, v in b["lanes"].items()})


def test_path_lane_parity_with_repro_at_hop_caps_4_32(pair):
    j_idx, index = pair
    kw = dict(buckets=BUCKETS, max_wait_ms=1.0, cache_size=4096,
              path_hop_caps=(4, 32))
    srv, j_srv = DistanceServer(index, **kw), JServer(j_idx, **kw)
    assert set(srv.compile_cache_sizes()) == {"mu", "full", "path4",
                                              "path32"}
    tr = make_trace("hotspot", n=index.n, num_requests=240, rate_qps=2e4,
                    seed=13)
    with BuildWatcher() as w:
        dist, paths, valid = srv.serve_path_trace(tr)
    assert w.count("serve_path") == 0
    j_dist, j_paths, j_valid = j_srv.serve_path_trace(tr)
    np.testing.assert_array_equal(dist, np.asarray(j_dist, np.float32))
    assert paths == j_paths
    np.testing.assert_array_equal(valid, j_valid)
    assert valid.all()
    # hop_cap 4 overflows on this graph: the 32 tier (or the host
    # oracle) answered, as in repro
    assert srv.metrics.path_overflows == j_srv.metrics.path_overflows > 0
    assert _lane_buckets(srv.metrics) == _lane_buckets(j_srv.metrics)
    np.testing.assert_array_equal(dist, _want(index, tr))
    rid = srv.submit_path(int(tr.s[0]), int(tr.t[0]), now=1e3)
    ans = srv.take_result(rid)                 # a path-cache hit
    assert isinstance(ans, PathAnswer) and list(ans.path) == paths[0]


def test_compressed_index_serves_as_repro(tmp_path_factory):
    n, src, dst, w = gen.er_graph(300, 2.2, seed=5)
    j_idx, index = _load(tmp_path_factory, "er300c", n, src, dst, w,
                         l_cap=128, label_chunk=64,
                         label_dtype="compressed")
    assert index.engine.codec == "delta16"
    np.testing.assert_array_equal(mu_exact_mask(index),
                                  j_mu_exact_mask(j_idx))
    tr = make_trace("uniform", n=n, num_requests=160, rate_qps=2e4, seed=14)
    want = np.asarray(JServer(j_idx, buckets=BUCKETS, max_wait_ms=1.0)
                      .serve_trace(tr), np.float32)
    for backend in ("reference", "cuda"):
        srv = DistanceServer(index, buckets=BUCKETS, max_wait_ms=1.0,
                             backend=backend)
        np.testing.assert_array_equal(srv.serve_trace(tr), want)


# --------------------------- classify / query_types / query_host inputs
def _forms(x):
    """The same ids as a numpy array, a list and a CPU tensor."""
    return [np.asarray(x), list(np.asarray(x).tolist()),
            torch.as_tensor(np.asarray(x))]


def test_classify_accepts_scalars_and_tensors(pair):
    j_idx, index = pair
    s = np.array([0, 1, 17, 300, 699])
    t = np.array([2, 3, 5, 650, 0])
    want = j_idx.engine.classify(s, t, j_idx.level, j_idx.k)
    for fs, ft in zip(_forms(s), _forms(t)):
        for level in (index.level, torch.as_tensor(index.level)):
            got = index.engine.classify(fs, ft, level, index.k)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(index.query_types(fs, ft),
                                      j_idx.query_types(s, t))
    one = index.engine.classify(torch.tensor(0), 2, index.level, index.k)
    assert one.shape == (1,) and one[0] == want[0]
    assert index.query_types(0, 2)[0] == want[0]
    assert set(np.unique(want)) <= {1, 2, 3}


def test_query_host_accepts_scalars_and_tensors(pair):
    j_idx, index = pair
    s = np.array([0, 1, 17, 300, 699], np.int32)
    t = np.array([2, 3, 5, 650, 0], np.int32)
    want = np.asarray(j_idx.query_host(s, t))
    for fs, ft in zip(_forms(s), _forms(t)):
        got = index.query_host(fs, ft)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with sync_span() as span:
        one = index.query_host(torch.tensor(17), np.int32(5))
    np.testing.assert_array_equal(one, np.asarray(j_idx.query_host(17, 5)))
    assert one.shape == (1,) and span.count >= 1
