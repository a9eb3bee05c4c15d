"""Sharded indexes of the PyTorch port (``repro_torch.shard``) against
``repro.shard`` and ``repro``'s unsharded engine, bitwise.

The port's index is built from ``repro``'s fixture graph
(``tests/test_shard.py``: ``er_graph(400, 2.5, seed=5)``, ``l_cap=128``)
with JAX's MIS permutations injected, so both hierarchies are equal.
``repro`` runs on its ``reference`` backend; the port's shards run the
kernels' plain versions (CPU tensors) on each stage-2 route. One
subprocess runs ``repro``'s two-shard mutations on two forced host
devices.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro.serve import DistanceServer as JServer
from repro.serve import MutationOp as JOp
from repro.serve import make_trace as j_make_trace
from repro.shard import ShardedIndex as JSharded
from repro.shard import assign_shards as j_assign
from repro.shard import partition_labels as j_partition
from repro.shard import unpartition_labels as j_unpartition
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.core.dispatch import CoreRelaxer
from repro_torch.obs import BuildWatcher
from repro_torch.serve import (DistanceServer, IndexRegistry, MutationOp,
                               make_trace)
from repro_torch.shard import (REPLICATED, ShardedIndex, assign_shards,
                               partition_labels, shard_devices,
                               unpartition_labels)
from test_torch_build import jax_perms

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG = dict(l_cap=128, label_chunk=128)
# endpoint ids outside [0, n], read as repro reads them
ODD = lambda n: [n, n + 3, -1, -2, -(n + 5)]          # noqa: E731
# stage-2 routes pinned through the relaxer's rule; the last reaches
# ell_loop because the fused working set exceeds a zero budget
ROUTES = {"dense": dict(), "fused": dict(dense_threshold=2.0),
          "ell_loop": dict(dense_threshold=2.0, fused=False),
          "ell_loop_budget": dict(dense_threshold=2.0, vmem_budget=0)}
FIELDS = ("dist", "verts", "weights", "lens", "ok", "rounds")


def _pair(n, src, dst, w):
    j_idx = JIndex.build(n, src, dst, w, JConfig(**CFG))
    t_idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**CFG),
                               device="cpu", perms=jax_perms(0, n))
    return j_idx, t_idx


@pytest.fixture(scope="module")
def pair():
    n, src, dst, w = gen.er_graph(400, 2.5, seed=5)
    j_idx, t_idx = _pair(n, src, dst, w)
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.integers(0, n, 64), ODD(n)]).astype(np.int32)
    t = np.concatenate([rng.integers(0, n, 64), ODD(n)[::-1]]).astype(
        np.int32)
    ans, rounds = j_idx.engine.batch_fn("reference")(s, t)
    mu = j_idx.engine.mu_batch_fn("reference")(s, t)
    return {"j": j_idx, "t": t_idx, "n": n, "s": s, "t_": t,
            "ans": np.asarray(ans), "rounds": int(rounds),
            "mu": np.asarray(mu)}


def _pin(sidx, route):
    """Every device's relaxer of ``sidx`` pinned to one route."""
    eng = sidx.engine
    for dev, rel in eng.relaxers.items():
        eng.relaxers[dev] = CoreRelaxer(rel.ce_src, rel.ce_dst, rel.ce_w,
                                        rel.n_core, device=dev,
                                        **ROUTES[route])
        assert eng.relaxers[dev].mode == route.split("_budget")[0]
    eng.relaxer = eng.relaxers[eng.device]


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("strategy", ["hash", "level"])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_partition_equals_repro(pair, strategy, num_shards):
    j_idx, t_idx = pair["j"], pair["t"]
    so = assign_shards(t_idx.level, t_idx.k, num_shards, strategy=strategy)
    want_so = j_assign(j_idx.level, j_idx.k, num_shards, strategy=strategy)
    np.testing.assert_array_equal(so, want_so)
    labels = [x.numpy() for x in (t_idx.lbl_ids, t_idx.lbl_d,
                                  t_idx.lbl_pred)]
    got = partition_labels(*labels, t_idx.n, so, num_shards)
    want = j_partition(j_idx.lbl_ids, j_idx.lbl_d, j_idx.lbl_pred, j_idx.n,
                       want_so, num_shards)
    for f in ("ids", "d", "pred", "entries"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    back = unpartition_labels(got, t_idx.n, CFG["l_cap"])
    for a, b, c in zip(back, j_unpartition(want, j_idx.n, CFG["l_cap"]),
                       labels):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("case", ["replicate_all", "zero_shards",
                                  "bad_strategy", "replicate_none"])
def test_assign_shards_edge_cases(pair, case):
    t_idx = pair["t"]
    if case == "replicate_all":
        so = assign_shards(t_idx.level, t_idx.k, 2, replicate_top=t_idx.k)
        assert np.all(so == REPLICATED)
        return
    kw = {"zero_shards": dict(num_shards=0),
          "bad_strategy": dict(num_shards=2, strategy="nope"),
          "replicate_none": dict(num_shards=2, replicate_top=0)}[case]
    with pytest.raises(ValueError):
        assign_shards(t_idx.level, t_idx.k, **kw)
    with pytest.raises(ValueError):
        j_assign(pair["j"].level, pair["j"].k, **kw)


# --------------------------------------------------------------- queries
@pytest.mark.parametrize("codec", ["fp32", "compressed"])
@pytest.mark.parametrize("strategy", ["hash", "level"])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_query_equals_repro_unsharded(pair, codec, strategy,
                                               num_shards):
    """Answers, rounds and μ equal repro's unsharded reference engine on
    every route, endpoint ids outside [0, n] included; every shard runs
    the same rounds and each batch makes one cross-shard reduction."""
    t_idx = copy.copy(pair["t"])
    t_idx.cfg = dataclasses.replace(t_idx.cfg, label_dtype=codec)
    sidx = ShardedIndex.from_index(t_idx, num_shards, strategy=strategy)
    assert sidx.engine.codec == ("none" if codec == "fp32" else "delta16")
    s, t = pair["s"], pair["t_"]
    for route in ROUTES:
        _pin(sidx, route)
        ans, rounds = sidx.engine.batch_fn("cuda")(s, t)
        np.testing.assert_array_equal(ans.numpy(), pair["ans"], route)
        assert int(rounds) == pair["rounds"], route
        assert {int(r) for r in sidx.engine.last_shard_rounds} == {
            pair["rounds"]}, route
    np.testing.assert_array_equal(
        sidx.engine.mu_batch_fn("cuda")(s, t).numpy(), pair["mu"])
    ans, rounds = sidx.engine.batch_fn("reference")(s, t)
    np.testing.assert_array_equal(ans.numpy(), pair["ans"])
    assert sidx.engine.collective_count(backend="cuda") == 1
    np.testing.assert_array_equal(sidx.query_host(s, t), pair["ans"])


def test_single_shard_equals_repro_sharded_in_process(pair):
    """P = 1 against ``repro``'s ShardedIndex on this process's one
    device: answers, rounds, μ, entries and the one collective."""
    j_sidx = JSharded.from_index(pair["j"], 1)
    sidx = ShardedIndex.from_index(pair["t"], 1)
    s, t = pair["s"], pair["t_"]
    want, want_rounds = j_sidx.engine.batch_fn("reference")(s, t)
    got, rounds = sidx.engine.batch_fn()(s, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(rounds) == int(want_rounds)
    np.testing.assert_array_equal(
        sidx.engine.mu_batch_fn()(s, t).numpy(),
        np.asarray(j_sidx.engine.mu_batch_fn("reference")(s, t)))
    np.testing.assert_array_equal(sidx.shard_entry_counts(),
                                  j_sidx.shard_entry_counts())
    assert sidx.engine.collective_count() == \
        j_sidx.engine.collective_count(backend="reference") == 1


@pytest.mark.parametrize("devices", [["cpu"] * 4,
                                     ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]])
def test_shard_devices_placement(pair, devices):
    """Four CPU devices: co-located shards share one stacked block
    tensor and one relaxer; distinct devices get a block and a relaxer
    each. Both answer as the unsharded engine."""
    sidx = ShardedIndex.from_index(pair["t"], 4, devices=devices)
    distinct = len(set(devices))
    assert len(sidx.engine.relaxers) == distinct
    assert isinstance(sidx.lbl_ids, torch.Tensor) == (distinct == 1)
    np.testing.assert_array_equal(
        sidx.engine.batch_fn("cuda")(pair["s"], pair["t_"])[0].numpy(),
        pair["ans"])


def test_shard_devices_rejects_bad_placement():
    with pytest.raises(ValueError, match="2 device"):
        shard_devices(4, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="does not exist"):
        shard_devices(2, ["cuda:0", f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError):
        shard_devices(0, "cpu")
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_build_and_load_default_to_the_card(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    n, src, dst, w = gen.er_graph(64, 2.0, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedIndex.build(n, src, dst, w, IndexConfig(l_cap=64),
                           num_shards=2)
    ShardedIndex.from_index(pair["t"], 2).save(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedIndex.load(tmp_path)
    sidx = ShardedIndex.build(n, src, dst, w, IndexConfig(l_cap=64),
                              num_shards=2, device="cpu")
    assert sidx.device.type == "cpu" and sidx.num_shards == 2


# ---------------------------------------------------------- save / load
def test_repro_save_loads_into_the_port(pair, tmp_path):
    JSharded.from_index(pair["j"], 1, strategy="hash").save(tmp_path)
    sidx = ShardedIndex.load(tmp_path, device="cpu")
    assert sidx.num_shards == 1 and sidx.strategy == "hash"
    np.testing.assert_array_equal(
        sidx.query_host(pair["s"], pair["t_"]), pair["ans"])


def test_port_save_round_trips_and_matches_repro_files(pair, tmp_path):
    sidx = ShardedIndex.from_index(pair["t"], 4)
    sidx.save(tmp_path / "p4")
    again = ShardedIndex.load(tmp_path / "p4", device="cpu")
    assert again.num_shards == 4 and again.strategy == "level"
    for a, b in zip(again.host_blocks(), sidx.host_blocks()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again.entries_per_shard,
                                  sidx.entries_per_shard)
    np.testing.assert_array_equal(
        again.query_host(pair["s"], pair["t_"]), pair["ans"])
    # P = 1: the same shards.npz arrays as repro's, and the same meta
    ShardedIndex.from_index(pair["t"], 1).save(tmp_path / "port")
    JSharded.from_index(pair["j"], 1).save(tmp_path / "repro")
    with np.load(tmp_path / "port" / "shards.npz") as a, \
            np.load(tmp_path / "repro" / "shards.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], f)
    meta = [json.loads((tmp_path / d / "meta.json").read_text())
            for d in ("port", "repro")]
    for key in ("n", "k", "num_shards", "strategy", "replicate_top", "cfg"):
        assert meta[0][key] == meta[1][key], key


# ------------------------------------------------------------- mutations
@pytest.fixture(scope="module")
def holdout():
    """``er_graph(400, 2.5, seed=5)`` built without vertex u's edges; the
    schedule inserts u with its real edges, deletes it, then deletes a
    build-time vertex below the core (a shard-owned ancestor)."""
    n, src, dst, w = gen.er_graph(400, 2.5, seed=5)
    u = int(np.flatnonzero(np.bincount(src, minlength=n) == 3)[-1])
    keep = (src != u) & (dst != u)
    j_idx, t_idx = _pair(n, src[keep], dst[keep], w[keep])
    below = np.flatnonzero((t_idx.level > 0) & (t_idx.level < t_idx.k))
    v = int(below[0])
    nbrs, ws = dst[src == u].tolist(), w[src == u].tolist()
    sched = [[("insert", u, nbrs, ws)], [("delete", u, (), ())],
             [("delete", v, (), ())]]
    rng = np.random.default_rng(3)
    s = np.concatenate([[u] * 8, rng.integers(0, n, 56)]).astype(np.int32)
    t = rng.integers(0, n, 64).astype(np.int32)
    return {"j": j_idx, "t": t_idx, "sched": sched, "s": s, "t_": t}


def _mutate_port(t_idx, sched, num_shards, s, t):
    sidx = ShardedIndex.from_index(t_idx, num_shards)
    steps = []
    for ops in sched:
        with BuildWatcher() as watch:
            sidx, info = sidx.apply_mutations(
                [MutationOp(k, u, tuple(a), tuple(b)) for k, u, a, b in ops])
        assert watch.count("serve_read") == 0
        assert watch.count("mutation") >= 1      # the new route layout
        ids, d = sidx.host_blocks()
        steps.append({"ids": ids, "d": d, "pred": sidx.lbl_pred,
                      "entries": sidx.entries_per_shard,
                      "rows": info["touched_rows"],
                      "shards": np.asarray(info["touched_shards"]),
                      "ans": sidx.query_host(s, t)})
    return steps


def _same_steps(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        for f in ("ids", "d", "pred", "entries", "rows", "shards", "ans"):
            np.testing.assert_array_equal(a[f], b[f], f"step {i}: {f}")


def test_apply_mutations_single_shard_equals_repro(holdout):
    s, t = holdout["s"], holdout["t_"]
    jsidx = JSharded.from_index(holdout["j"], 1)
    want = []
    for ops in holdout["sched"]:
        jsidx, info = jsidx.apply_mutations(
            [JOp(k, u, tuple(a), tuple(b)) for k, u, a, b in ops])
        want.append({"ids": np.asarray(jsidx.lbl_ids),
                     "d": np.asarray(jsidx.lbl_d), "pred": jsidx.lbl_pred,
                     "entries": jsidx.entries_per_shard,
                     "rows": info["touched_rows"],
                     "shards": np.asarray(info["touched_shards"]),
                     "ans": np.asarray(jsidx.query(s, t), np.float32)})
    _same_steps(_mutate_port(holdout["t"], holdout["sched"], 1, s, t), want)


def test_apply_mutations_two_shards_equals_repro(holdout, tmp_path):
    """P = 2: ``repro``'s side runs on two forced host devices in one
    subprocess, which writes its arrays to an npz."""
    out = tmp_path / "repro_p2.npz"
    graph = tmp_path / "graph.npz"
    j_idx = holdout["j"]
    j_idx.save(tmp_path / "index")
    np.savez(graph, s=holdout["s"], t=holdout["t_"])
    code = textwrap.dedent(f"""
        import json, numpy as np
        from repro.core import ISLabelIndex
        from repro.serve import MutationOp
        from repro.shard import ShardedIndex
        idx = ISLabelIndex.load({str(tmp_path / "index")!r})
        g = np.load({str(graph)!r})
        sched = json.loads({json.dumps(holdout["sched"])!r})
        sidx = ShardedIndex.from_index(idx, 2)
        arrays = {{}}
        for i, ops in enumerate(sched):
            sidx, info = sidx.apply_mutations(
                [MutationOp(k, u, tuple(a), tuple(b)) for k, u, a, b in ops])
            arrays.update({{
                f"ids{{i}}": np.asarray(sidx.lbl_ids),
                f"d{{i}}": np.asarray(sidx.lbl_d),
                f"pred{{i}}": sidx.lbl_pred,
                f"entries{{i}}": sidx.entries_per_shard,
                f"rows{{i}}": info["touched_rows"],
                f"shards{{i}}": np.asarray(info["touched_shards"]),
                f"ans{{i}}": np.asarray(sidx.query(g["s"], g["t"]),
                                        np.float32)}})
        np.savez({str(out)!r}, **arrays)
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(out) as z:
        want = [{f: z[f"{f}{i}"] for f in ("ids", "d", "pred", "entries",
                                           "rows", "shards", "ans")}
                for i in range(len(holdout["sched"]))]
    got = _mutate_port(holdout["t"], holdout["sched"], 2, holdout["s"],
                       holdout["t_"])
    _same_steps(got, want)
    # the shard-owned delete touches its owner's block alone
    assert len(want[2]["shards"]) == 1


# ----------------------------------------------------------------- paths
@pytest.mark.parametrize("hc", [16, 128])
def test_sharded_paths_equal_repro_unsharded(pair, hc):
    sidx = ShardedIndex.from_index(pair["t"], 4, strategy="hash")
    s, t = pair["s"][:64], pair["t_"][:64]
    got = sidx.path_engine().path_batch_fn(hc)(s, t)
    want = pair["j"].path_engine().path_batch_fn(hc, "reference")(s, t)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    dist, paths, _ = sidx.shortest_paths(s[:8], t[:8], hop_cap=hc)
    jd, jp, _ = pair["j"].shortest_paths(s[:8], t[:8], hop_cap=hc)
    np.testing.assert_array_equal(dist, np.asarray(jd))
    assert paths == [list(p) for p in jp]


# --------------------------------------------------------------- serving
def test_serving_four_shards_equals_repro_server(pair):
    sidx = ShardedIndex.from_index(pair["t"], 4)
    kw = dict(buckets=(8, 32), max_wait_ms=1.0, cache_size=4096)
    with BuildWatcher() as warm:
        srv = DistanceServer(sidx, **kw)
    assert warm.count("warmup") >= 1
    shapes = srv.compile_cache_sizes()
    n = pair["n"]
    tr = make_trace("hotspot", n=n, num_requests=300, rate_qps=2e4, seed=4)
    with BuildWatcher() as watch:
        got = srv.serve_trace(tr)
    assert watch.count() == 0
    assert srv.compile_cache_sizes() == shapes
    want = JServer(pair["j"], backend="reference", **kw).serve_trace(
        j_make_trace("hotspot", n=n, num_requests=300, rate_qps=2e4,
                     seed=4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pair["t"].query_host(tr.s, tr.t))
    assert srv.stats()["graph"]["shards"] == 4


def test_mixed_registry_and_versioned_rejects_sharded(pair):
    sidx = ShardedIndex.from_index(pair["t"], 2)
    reg = IndexRegistry()
    reg.register("flat", pair["t"], buckets=(8, 32), warmup=False)
    reg.register("sharded", sidx, buckets=(8, 32), warmup=False)
    tr = make_trace("uniform", n=pair["n"], num_requests=120, rate_qps=2e4,
                    seed=6)
    a = reg.get("flat").serve_trace(tr)
    b = reg.get("sharded").serve_trace(tr)
    np.testing.assert_array_equal(a, b)
    assert reg.stats()["sharded"]["graph"]["shards"] == 2
    assert reg.stats()["flat"]["graph"]["shards"] == 1
    with pytest.raises(ValueError, match="unsharded-only"):
        DistanceServer(sidx, versioned=True, warmup=False)


def test_launcher_serves_shards_on_cpu(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as stop:
        main(["--device", "cpu", "--mode", "distance", "--graph", "er",
              "--n", "256", "--l-cap", "128", "--queries", "256",
              "--buckets", "16,64", "--shards", "2", "--audit", "index"])
    out = capsys.readouterr().out
    assert stop.value.code == 0, out
    assert "2 shard(s)" in out and "AUDIT FAIL" not in out
    assert "256/256 served answers bitwise-equal" in out
