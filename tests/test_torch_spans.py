"""The program's spans and counters (``repro_torch.obs.trace``).

Under a CPU ``torch.profiler`` a tiny build and query record the named
spans, nested by layer. With spans off nothing is recorded, allocated
or launched, and with them on the answers, the index and the counted
blocking reads are the same. The counters count what they say:
``relax.changed`` the (tile, vertex) pairs with some bit set in each
counted round's input mask, ``relax.sectors`` its set bits,
``build.mis_rounds`` the rounds ``BuildStats`` records.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.core import sync
from repro_torch.core.dispatch import relax_csr_rounds, seed_vertex_major
from repro_torch.graphs import generators as gen
from repro_torch.kernels.spmv_relax.kernel import RelaxCSR
from repro_torch.kernels.spmv_relax.ops import coo_to_csr, spmv_relax
from repro_torch.obs import REGISTRY, profiler_session
from repro_torch.obs import trace as obs_trace

CFG = IndexConfig(l_cap=64, label_chunk=128)


@pytest.fixture(scope="module")
def graph():
    return gen.er_graph(300, 3.0, seed=4)


def _pairs(n, q=37, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, q), rng.integers(0, n, q)


def _annotations(prof):
    """(start, end, name) of the profiler's host ranges."""
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _parents(ranges):
    """name -> the set of names of the ranges directly around it."""
    out: dict = {}
    stack: list = []
    for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= start:
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][1] if stack else None)
        stack.append((end, name))
    return out


class _Ops(TorchDispatchMode):
    """The aten ops dispatched on this thread inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _traced(fn):
    """Run ``fn`` under a CPU profiler with program spans on, against an
    empty registry. Returns (fn's result, annotations, counter totals)."""
    with REGISTRY.isolated():
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                obs_trace.program_spans():
            out = fn()
        counters = {name: REGISTRY.get(name).total()
                    for name in REGISTRY.names()
                    if REGISTRY.get(name).kind == "counter"}
    return out, _annotations(prof), counters


def test_build_and_query_record_nested_spans(graph):
    n, src, dst, w = graph
    s, t = _pairs(n)

    def run():
        idx = ISLabelIndex.build(n, src, dst, w, CFG, device="cpu")
        return idx, idx.query_host(s, t)

    (idx, _), ranges, _ = _traced(run)
    parents = _parents(ranges)
    want = {"build": {None}, "build.graph": {"build"},
            "build.level": {"build"}, "build.mis": {"build.level"},
            "build.peel_level": {"build.level"},
            "build.dedup": {"build.peel_level"},
            "build.record": {"build.level"}, "build.pull": {"build"},
            "build.labels": {"build"},
            "build.label_level": {"build.labels"},
            "build.assemble": {"build"}, "query": {None},
            "query.mu": {"query"}, "query.seeds": {"query"},
            "query.relax": {"query"}, "relax.seed": {"query.relax"},
            "relax.round": {"query.relax"}}
    for name, around in want.items():
        assert parents.get(name) == around, (name, parents.get(name))
    assert {"build.level", "build.pull", "query.relax", None} \
        <= parents["sync.read"]
    assert "build.graph" in parents["sync.upload"]
    assert len([r for r in ranges if r[2] == "build.level"]) \
        == idx.stats.peel_iters


def test_spans_off_record_and_launch_nothing(graph):
    n, src, dst, w = graph
    assert not obs_trace.spans_on()
    assert obs_trace.span("query") is obs_trace.span("build")
    one = torch.ones((), dtype=torch.int64)
    with REGISTRY.isolated():
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                _Ops() as ops:
            with obs_trace.span("query"):
                obs_trace.count("relax.rounds", 3)
                obs_trace.count_device("relax.changed", one)
        assert REGISTRY.names() == []
    assert _annotations(prof) == [] and ops.ops == []
    assert obs_trace._PENDING == {}
    idx = ISLabelIndex.build(n, src, dst, w, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.query_host(*_pairs(n))
    assert _annotations(prof) == []


def test_answers_index_and_syncs_equal_with_spans_on_and_off(graph):
    n, src, dst, w = graph
    s, t = _pairs(n, seed=5)

    def run():
        c0 = sync.sync_count()
        idx = ISLabelIndex.build(n, src, dst, w, CFG, device="cpu")
        c1 = sync.sync_count()
        ans = idx.query_host(s, t)
        return idx, ans, (c1 - c0, sync.sync_count() - c1)

    off = run()
    on, _, counters = _traced(run)
    for name in ("lbl_ids", "lbl_d", "lbl_pred", "level", "up_ids"):
        a, b = getattr(off[0], name), getattr(on[0], name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b))
    assert np.array_equal(off[1], on[1]) and off[2] == on[2]
    assert counters["relax.rounds"] == on[0].engine._last_rounds > 0
    # the device counts fold with a read that core.sync does not count
    c0 = sync.sync_count()
    with REGISTRY.isolated(), obs_trace.program_spans():
        obs_trace.count_device("x.y", torch.tensor(3))
    assert sync.sync_count() == c0


def test_relax_changed_counts_each_counted_rounds_mask():
    """``relax_csr_rounds`` on CPU tensors against the same rounds run
    one by one: the pairs with some bit set in each round's input mask
    and its set bits, weighed by its input flag, and n_tiles x Vp slots
    a counted round."""
    rng = np.random.default_rng(3)
    v, e, q = 150, 600, 80
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.integers(1, 9, e).astype(np.float32)
    *layout, n_heavy = coo_to_csr(v, src, dst, w)
    csr = RelaxCSR(*(torch.from_numpy(x) for x in layout), n_heavy)
    seeds = [(torch.from_numpy(rng.integers(0, v, (q, 3))),
              torch.from_numpy(rng.integers(0, 5, (q, 3)).astype(
                  np.float32))) for _ in range(2)]
    rows = 2 * q
    cur, changed = seed_vertex_major(*seeds, v, rows)
    assert changed.shape[0] == 2
    want, sectors, flag, rounds = 0, 0, torch.ones(1, dtype=torch.int32), 0
    while int(flag):
        want += int((changed != 0).sum())
        word = changed.numpy().astype(np.int64) & 0xFFFF
        sectors += sum(int(((word >> j) & 1).sum()) for j in range(16))
        rounds += 1
        cur, changed, flag = spmv_relax(cur, csr, changed, flag_in=flag)
    (d, got_rounds), _, counters = _traced(
        lambda: relax_csr_rounds(*seed_vertex_major(*seeds, v, rows), csr,
                                 max_rounds=10 * v))
    assert torch.equal(d, cur) and int(got_rounds) == rounds > 2
    # rounds past the fixed point (up to the next multiple of 8) count 0
    assert counters["relax.changed"] == want
    assert counters["relax.sectors"] == sectors > want
    assert counters["relax.slots"] == rounds * changed.numel()


@pytest.mark.parametrize("builder", ["device", "host"])
def test_build_counters_match_build_stats(graph, builder):
    n, src, dst, w = graph
    cfg = IndexConfig(l_cap=64, label_chunk=128, builder=builder)
    idx, _, counters = _traced(
        lambda: ISLabelIndex.build(n, src, dst, w, cfg, device="cpu"))
    assert counters["build.mis_rounds"] == sum(idx.stats.mis_rounds) > 0
    assert counters["build.mis_launched"] >= counters["build.mis_rounds"]
    assert 0 < counters["build.dedup_live"] < counters["build.dedup_slots"]
    assert 0 < counters["build.label_live"] < counters["build.label_slots"]
    d_cap = idx.up_ids.shape[1]
    chunks = sum(-(-int((idx.level == i).sum()) // cfg.label_chunk)
                 for i in range(1, idx.k))
    assert counters["build.label_slots"] \
        == chunks * cfg.label_chunk * (d_cap * cfg.l_cap + 1)


def test_profiler_session_turns_the_spans_on(graph, tmp_path):
    n, src, dst, w = graph
    idx = ISLabelIndex.build(n, src, dst, w, CFG, device="cpu")
    with REGISTRY.isolated():
        with profiler_session(str(tmp_path)):
            assert obs_trace.spans_on()
            idx.query_host(*_pairs(n))
        assert REGISTRY.get("relax.rounds").total() \
            == idx.engine._last_rounds
    assert not obs_trace.spans_on()
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"query", "query.relax", "relax.round", "sync.read"} <= names
