"""CPU tests of the benchmark harness, at tiny sizes through the plain
backend: cells resolve by name, both traffic kinds run and agree with
the reference, a run loads neither JAX nor the JAX package, the
stage-2 work count on a hand-built example, the idle arithmetic on
synthetic intervals, the frozen generators against the program's, the
control and the planted faults that the check must catch."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench, controls, graphs, reference, timeline, work
from portbench.named import load

ROOT = Path(__file__).resolve().parents[1]
SPEC = bench.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

TINY_GRAPH = {"generator": "er_graph",
              "args": {"n": 200, "avg_deg": 2.5, "max_w": 4096, "seed": 3}}
TINY_CONFIG = {"graph": TINY_GRAPH,
               "index": {"l_cap": 32, "label_chunk": 256}}
TRAFFIC = {"query": {"kind": "query", "batch": 16},
           "rebuild": {"kind": "rebuild"}}


def tiny_run(kind: str, trace: bool = False, seed: int = 2 ** 31 + 11):
    cell = {"name": f"tiny.{kind}", "chips": 1}
    metrics = [{"name": m, "unit": "x"} for m in (
        ("pairs_per_s", "latency_p95_ms", "setup_s", "host_syncs.query")
        if kind == "query" else ("build_s", "setup_s", "build.peel_s"))]
    return bench.run_cell(cell, TINY_CONFIG, TRAFFIC[kind], seed, 0.05,
                          trace, "cpu", time.perf_counter(), metrics)


def test_cells_resolve_by_name():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(x) for x in names)
    for cell in SPEC["workloads"]:
        got, config, traffic = bench.resolve(SPEC, cell["name"])
        assert got is cell and callable(load("kinds", traffic["kind"], "run"))
        assert config["name"] == cell["config"]
        e2e = bench.metrics_of(SPEC, cell, False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert bench.metrics_of(SPEC, cell, True)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    with pytest.raises(KeyError):
        bench.resolve(SPEC, "no_such.cell")


@pytest.mark.parametrize("kind", ["query", "rebuild"])
def test_traffic_runs_and_agrees_with_reference(kind):
    result, lines = tiny_run(kind)
    assert result["correct"], result
    assert result["checks"]["mismatched_pairs"]["value"] == 0
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["metrics"]["setup_s"]
    assert lines[0].startswith("check mismatched_pairs 0")


def test_traced_query_counts_stage2_work():
    result, _ = tiny_run("query", trace=True)
    wk = result["run"]["work"]
    assert wk["agree"] and wk["rounds"] == wk["program_rounds"] > 0
    assert wk["bytes"] > 0 and wk["ops"] > 0
    assert result["metrics"]["host_syncs.query"]["value"] > 0


def test_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time\n"
            f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from portbench import test_portbench as t\n"
            "r, _ = t.tiny_run('query')\n"
            "from portbench import bench\n"
            "print(bench.forbidden_modules(), r['correct'])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[-2] == "[] True"


def test_forbidden_modules_compare_whole_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "numpy"]) == []
    assert bench.forbidden_modules(["repro.core", "jaxlib.xla", "flax",
                                    "torch"]) == ["flax", "jaxlib", "repro"]


def test_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "btc_er2m.q1024",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                     "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout == ""


def test_stage2_work_on_three_rounds():
    """Path 0 - 1 - 2 (weights 1), s seeded at 0, t at 2; s also parks a
    non-core ancestor in the sentinel column 3 and has a padding entry.
    Round 1 reads 2 seeds and in-edges 0->1, 2->1 and improves s[1],
    t[1]; round 2 reads those, in-edges 1->0, 1->2 (4 pairs) and
    improves s[2], t[0]; round 3 reads those, in-edges 2->1, 0->1 and
    improves nothing."""
    src = np.array([0, 1, 1, 2])
    dst = np.array([1, 0, 2, 1])
    w = np.ones(4, np.float32)
    inf = float("inf")
    seeds_s = (torch.tensor([[0, 3, 3]]), torch.tensor([[0.0, 5.0, inf]]))
    seeds_t = (torch.tensor([[2, 3, 3]]), torch.tensor([[0.0, inf, inf]]))
    ds = torch.tensor([[0.0, 1.0, 2.0, 5.0]])
    dt = torch.tensor([[2.0, 1.0, 0.0, inf]])
    for chunk in (1, 2):
        got = work.replay(seeds_s, seeds_t, src, dst, w, 3, "cpu",
                          frontiers=(ds, dt), chunk=chunk)
        assert got == {"bytes": 4 * 6 + 8 * 6 + 4 * 4, "ops": 2 * 8,
                       "rounds": 3, "agree": True}
    wrong = work.replay(seeds_s, seeds_t, src, dst, w, 3, "cpu",
                        frontiers=(ds, dt + 1))
    assert wrong["agree"] is False
    assert work.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert work.bound_s(1.0, 67e12) == (1.0, "operations")


def test_idle_arithmetic_on_synthetic_intervals():
    spans = [(0, 10), (5, 20), (30, 40), (38, 45), (60, 70)]
    assert timeline.merge(spans) == [(0, 20), (30, 45), (60, 70)]
    assert timeline.union_length(spans) == 45
    assert timeline.union_length(timeline.clip(spans, 10, 35)) == 15
    assert timeline.gaps(spans, -5, 80) == [(-5, 0), (20, 30), (45, 60),
                                            (70, 80)]

    def ev(name, start, end, corr=0, device=False, annotation=False):
        return {"name": name, "start": start, "end": end, "corr": corr,
                "device": device, "annotation": annotation}

    ns = 10 ** 6
    events = [
        ev("window", 0, 100 * ns, annotation=True),
        ev("entry", 0, 50 * ns, annotation=True),
        ev("stage2", 10 * ns, 40 * ns, annotation=True),
        ev("entry", 50 * ns, 100 * ns, annotation=True),
        ev("entry", 1 * ns, 2 * ns, annotation=True, device=True),
        ev("cudaLaunchKernel", 5 * ns, 6 * ns, corr=1),     # stage 1
        ev("cudaLaunchKernel", 12 * ns, 13 * ns, corr=2),   # stage 2
        ev("cudaMemcpyAsync", 45 * ns, 46 * ns, corr=3),    # the copy
        ev("cudaLaunchKernel", 55 * ns, 56 * ns, corr=4),   # request 2
        ev("k1", 8 * ns, 14 * ns, corr=1, device=True),
        ev("void k2<int>(float*)", 14 * ns, 38 * ns, corr=2, device=True),
        ev("Memcpy DtoH", 46 * ns, 47 * ns, corr=3, device=True),
        ev("k1", 57 * ns, 60 * ns, corr=4, device=True),
        ev("k3", 90 * ns, 91 * ns, corr=99, device=True),   # unlinked
    ]
    got = timeline.analyse(events, 0, 100 * ns)
    assert got["busy_s"] == pytest.approx(0.035)
    assert got["window_s"] == pytest.approx(0.1)
    assert got["idle_share"] == pytest.approx(0.65)
    assert got["unlinked"] == 1 and got["device_events"] == 5
    assert got["stage2_ranges"] == 1
    assert got["requests"] == [pytest.approx([0.007, 0.024]),
                               pytest.approx([0.003, 0.0])]
    assert got["device_ops"][0] == ("k2<int>", pytest.approx(0.024))
    assert got["idle_gaps"][0] == ("entry", pytest.approx(0.030))
    assert ("stage2", pytest.approx(0.008)) in got["idle_gaps"]


@pytest.mark.parametrize("config", ["btc_er2m", "web_rmat17"])
def test_frozen_generators_match_the_program(config):
    from repro_torch.graphs import generators as gen
    spec = bench.load_json(ROOT / "portbench" / "configs" / f"{config}.json")
    args = dict(spec["graph"]["args"])
    if "n" in args:                   # the same code at a tenth of the size
        args["n"] //= 10
    ours = graphs.make_graph({"generator": spec["graph"]["generator"],
                              "args": args})
    theirs = getattr(gen, spec["graph"]["generator"])(**args)
    assert ours[0] == theirs[0]
    for a, b in zip(ours[1:], theirs[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    max_w = args["max_w"]
    w2 = graphs.reweighted(ours[3], 5, max_w)
    m = len(w2) // 2
    assert np.array_equal(w2[:m], w2[m:])
    assert w2.min() >= 1 and w2.max() <= max_w and w2.max() > 2 ** 11


def test_reference_matches_dijkstra(monkeypatch):
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    n, src, dst, w = graphs.make_graph(TINY_GRAPH)
    per_source = 4 * (2 * n + 2 * len(src))
    monkeypatch.setattr(reference, "HOST_BYTES", 8 * per_source)
    s = np.repeat(np.arange(0, n, 7), 3)
    t = np.random.default_rng(0).integers(0, n, len(s))
    full = csg.dijkstra(sp.csr_matrix((w, (src, dst)), shape=(n, n)),
                        indices=s).astype(np.float32)
    want = full[np.arange(len(s)), t]
    assert np.isinf(want).any() and np.isfinite(want).any()
    assert np.array_equal(
        reference.pair_distances(n, src, dst, w, s, t), want)
    assert reference.block_for(n, len(src), "cpu") == 8


@pytest.mark.parametrize("kind", ["query", "rebuild"])
def test_bf16_control_comes_out_not_correct(kind):
    """The program reads 0 mismatches; the bfloat16 reference in its
    place fails the same run's check, since the distances pass 2^8."""
    cell = {"name": f"tiny.{kind}", "chips": 1}
    recs = controls.readings(cell, TINY_CONFIG, TRAFFIC[kind], [1, 2],
                             "cpu", 0.05)
    prog = [r for r in recs if r["side"] == "program"]
    ctrl = [r for r in recs if r["side"] == "bf16"]
    assert all(r["correct"] and r["mismatched_pairs"] == 0 for r in prog)
    assert all(not r["correct"] and r["mismatched_pairs"] > 0 for r in ctrl)


def test_stage2_readers_read_nothing_without_stage2_ranges():
    """Where the traced window holds no ``stage2`` range (the wrapped
    call bypassed or renamed), the stage readers return nothing rather
    than 0, so the run fails instead of moving stage 2's time."""
    result, _ = tiny_run("query", trace=True)
    run = {"trace": {"device_events": 3, "requests": [[1e-3, 0.0]],
                     "stage2_ranges": 0},
           "work": result["run"]["work"]}
    names = ("stage1.device_ms", "stage2.device_ms", "stage2_roofline")
    assert [bench.reader(m)(run) for m in names] == [None] * 3
    run["trace"]["stage2_ranges"] = 1
    assert bench.reader("stage1.device_ms")(run) == pytest.approx(1.0)


def _stale(orig):
    last = {}

    def query_host(self, s, t):
        out = orig(self, s, t)
        prev = last.get("ans", out)
        last["ans"] = out
        return prev
    return query_host


def _half(orig):
    def query_host(self, s, t):
        h = (len(s) + 1) // 2
        out = orig(self, np.asarray(s)[:h], np.asarray(t)[:h])
        return np.resize(out, len(s))
    return query_host


def _altered(orig):
    def query(self, s, t, *a, **kw):
        out = orig(self, s, t, *a, **kw).clone()
        out[len(out) // 2] += 1
        return out
    return query


def _stale_build(orig):
    last = {}

    def build(*args, **kw):
        new = orig(*args, **kw)
        prev = last.get("idx", new)
        last["idx"] = new
        return prev
    return staticmethod(build)


def _half_graph(orig):
    def build(n, src, dst, w, *a, **kw):
        m = len(src) // 2
        keep = np.r_[np.arange(m // 2), m + np.arange(m // 2)]
        return orig(n, src[keep], dst[keep], w[keep], *a, **kw)
    return staticmethod(build)


@pytest.mark.parametrize("kind,target,fault", [
    ("query", "ISLabelIndex.query_host", _stale),
    ("query", "ISLabelIndex.query_host", _half),
    ("query", "QueryEngine.query", _altered),
    ("rebuild", "ISLabelIndex.build", _stale_build),
    ("rebuild", "ISLabelIndex.build", _half_graph),
    ("rebuild", "QueryEngine.query", _altered),
], ids=["query-stale", "query-half", "query-altered", "rebuild-stale",
        "rebuild-half", "rebuild-altered"])
def test_planted_faults_come_out_not_correct(monkeypatch, kind, target,
                                             fault):
    from repro_torch.core import index, query
    owner = {"ISLabelIndex": index.ISLabelIndex,
             "QueryEngine": query.QueryEngine}[target.split(".")[0]]
    attr = target.split(".")[1]
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    result, lines = tiny_run(kind)
    assert not result["correct"]
    assert result["checks"]["mismatched_pairs"]["value"] > 0, lines
    json.dumps(result)
