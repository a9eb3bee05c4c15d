#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --label-sweep SRC   # stage-1 sweep of SRC's port

Phases, one JSON line each (with its seconds):

1. device   — the card's name and power limit (``nvidia-smi``).
2. build    — compile the hand-written CUDA kernels from ``kernels/csrc``,
   then hold each against its plain PyTorch version (``torch.equal``)
   on small random inputs at ragged shapes; the label kernels both on
   gathered rows and reading rows in place by endpoint id (rows ending
   on and one past a 32-slot chunk, duplicate ids, the all-pad row,
   repeated endpoints, endpoint ids n, n+3, -1, -2 and -(n+5), int32
   and float32 distance planes).
3. main path, one real build per path, with the launch counters set to
   0 before each path and read after it; each path must launch exactly
   its own kernels:
   - ``ell_loop``: ``ISLabelIndex.build`` on ``er:1000000:2.2@1``
     (``l_cap=64``, ``label_chunk=8192``), then ``query`` on 1024 seeded
     random pairs (two calls, then ``QUERY_REPEATS`` timed ones); the
     first 16 sources are checked bitwise against Dijkstra;
   - ``fused``: the same on ``er:10000:2.2@1``;
   - ``dense``: the same on ``rmat:12:24@1`` (a small dense core);
   - ``compressed``: the same on ``rmat:15:8@1`` with
     ``label_dtype="compressed"`` (delta16 ids, int32 distances), whose
     stage 1 runs the packed kernel and stage 2 the ``ell_loop`` route.
   Builds and queries run under ``torch.cuda.set_sync_debug_mode
   ("error")``: any device sync outside ``host_read`` raises.
4. paths_<path> — the path lane (§8.1, ``path_batch_fn(256)``) on each
   main path's index and 1024 pairs, launch counters zeroed around it:
   it must launch exactly the route's stage-2 kernel, give the query's
   distances bitwise and its round count, and every path must pass
   ``check_path_batch`` against the generated edges; on ``fused`` and
   ``dense`` the host oracle ``shortest_path`` is checked on 8 pairs.
5. serving_<path> — the serving engine (``repro_torch.serve``) on each
   main path's index at ``launch/serve.py``'s defaults (buckets 64, 256,
   1024; 2 ms; cache 65,536): a ``hotspot`` and a ``uniform`` trace of
   4,096 requests (1,024 on ``ell_loop``) at 50,000 req/s on the trace
   clock, under sync debug mode "error". Every answer equal to
   ``idx.query`` bitwise (a Dijkstra sample of 256 on ``fused`` and
   ``dense``); each lane launching exactly its kernels (``mu``: the
   label kernel; ``full``: it and the route's stage-2 kernel); no
   first-use build after warmup and the shape counts unchanged; one
   counted sync a batch beyond the entry points' own exit-flag reads.
   Then a profiled replay (device idle share), ``classify`` and
   ``query_host`` on CUDA tensors, and on ``fused`` and ``dense`` a
   path-lane replay of 512 requests at hop caps 64 and 256 whose paths
   all pass the launcher's audit.
6. mutation — §8.3 on a hold-out build of ``er:10000:2.2@1``: insert
   the held-out vertex (its distances equal to Dijkstra's on the full
   graph, its paths checked), then delete it (answers restored, the
   conservative rule); insert and delete ms over three cycles.
7. builders — ``er:10000:2.2@1`` built with ``builder="host"`` and
   ``builder="device"`` from one seed must give the same hierarchy and
   labels, bitwise; then whether the 10^6 graph's labels fit delta16.
8. kernels  — each kernel on the card against its plain PyTorch version
   (``torch.equal``) on the inputs the main path gave it, with
   CUDA-event times and the bound of the same work. The label kernels
   also run at ``repro``'s serving batches (Q = 64, 256, 1024) beside
   the launch floor (a one-element ``fill_``), on gathered rows too, and
   with the whole μ-only lane (``query_mu_only``) timed at each Q on the
   ``ell_loop`` and ``compressed`` indexes (``label_sweep``).
   ``spmv_relax_kernel``
   is replayed round by round on both ``ell_loop`` queries (output, mask
   and flag of every round), and its replayed round count must equal
   the route's. ``fused_relax_kernel`` is timed in both variants on the
   fused core, ``minplus_matmul_kernel`` with its instruction-issue bound
   at the SM clock read under its load. Each path's query is profiled
   once (device idle share).

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits nonzero and prints no result. It needs one CUDA card and the
repository's ``src/`` beside it.

``--label-sweep SRC`` builds the four paths' indexes with the port
under ``SRC`` (for instance an older commit unpacked with ``git
archive``) and prints ``label_sweep``'s line with each path's query
times, so two trees' stage 1 and queries can be timed in turns in one
call.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAIN_QUERIES = 1024
QUERY_REPEATS = 10       # timed query calls after the first two
# the serving buckets of repro's batcher (src/repro/serve/batcher.py:52)
SWEEP_QS = (64, 256, 1024)
KERNELS = {
    "label_intersect_kernel": (
        "src/repro_torch/kernels/csrc/label_intersect.cu",
        "src/repro/kernels/label_intersect/kernel.py:59"),
    "spmv_relax_kernel": (
        "src/repro_torch/kernels/csrc/spmv_relax.cu",
        "src/repro/kernels/spmv_relax/kernel.py:55"),
    "fused_relax_kernel": (
        "src/repro_torch/kernels/csrc/fused_relax.cu",
        "src/repro/kernels/spmv_relax/kernel.py:107"),
    "minplus_matmul_kernel": (
        "src/repro_torch/kernels/csrc/minplus_matmul.cu",
        "src/repro/kernels/minplus_matmul/kernel.py:38"),
    "label_intersect_packed_kernel": (
        "src/repro_torch/kernels/csrc/label_intersect_packed.cu",
        "src/repro/kernels/label_intersect/kernel.py:95"),
}
# (path, stage-2 route, graph spec, generator call, IndexConfig overrides,
#  the kernels the path launches)
PATHS = [
    ("ell_loop", "ell_loop", "er:1000000:2.2@1",
     ("er_graph", (1_000_000, 2.2), 1), dict(l_cap=64, label_chunk=8192),
     {"label_intersect_kernel", "spmv_relax_kernel"}),
    ("fused", "fused", "er:10000:2.2@1", ("er_graph", (10_000, 2.2), 1),
     dict(l_cap=64, label_chunk=4096),
     {"label_intersect_kernel", "fused_relax_kernel"}),
    ("dense", "dense", "rmat:12:24@1", ("rmat_graph", (12, 24.0), 1),
     dict(l_cap=512, label_chunk=1024),
     {"label_intersect_kernel", "minplus_matmul_kernel"}),
    # the query preset of benchmarks/bench_query.py (_compressed_row);
    # n <= 32768, so no id gap can overflow int16
    ("compressed", "ell_loop", "rmat:15:8@1", ("rmat_graph", (15, 8.0), 1),
     dict(l_cap=1024, label_chunk=2048, label_dtype="compressed"),
     {"label_intersect_packed_kernel", "spmv_relax_kernel"}),
]
BUILDER_GRAPH = ("er:10000:2.2@1", ("er_graph", (10_000, 2.2), 1),
                 dict(l_cap=64, label_chunk=4096))
# the path lane on each main path's index: the kernel its stage 2
# launches (its μ and meet come from the plain label intersection)
PATH_LANE_KERNELS = {"ell_loop": {"spmv_relax_kernel"},
                     "fused": {"fused_relax_kernel"},
                     "dense": {"minplus_matmul_kernel"},
                     "compressed": {"spmv_relax_kernel"}}
PATH_HOP_CAP = 256       # repro's DEFAULT_HOP_CAP
PATH_REPEATS = 5         # timed path batches after the first two
ORACLE_PATHS = ("fused", "dense")   # host path oracle checked on 8 pairs
# §8.3 on a hold-out build of the fused path's graph; insert and delete
# through the index's entry points, queries and paths on the fused route
MUTATION_GRAPH = BUILDER_GRAPH
MUTATION_CYCLES = 3      # timed insert/delete pairs
MUTATION_KERNELS = {"label_intersect_kernel", "fused_relax_kernel"}
# the serving engine on each main path's index, at launch/serve.py's
# defaults (buckets: repro's batcher, src/repro/serve/batcher.py:52)
SERVE_BUCKETS = (64, 256, 1024)
SERVE_WAIT_MS = 2.0
SERVE_CACHE = 65_536
SERVE_RATE = 50_000.0    # requests/s on the trace clock
SERVE_SCENARIOS = ("hotspot", "uniform")
SERVE_REQUESTS = {"ell_loop": 1024}   # 4096 elsewhere
SERVE_ORACLE = {"fused": 256, "dense": 256}   # Dijkstra sample
SERVE_PATH_REQUESTS = {"fused": 512, "dense": 512}
SERVE_HOP_CAPS = (64, 256)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


# timings whose device ms may hold host gaps (see cuda_ms)
UNCOVERED = [0]


def cuda_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, wall ms) of one call of ``fn``, means over ``iters``
    calls after one warm-up call.

    Device ms: the calls are queued behind a device-side sleep long
    enough to cover their host-side launch cost, and CUDA events around
    them time the device alone. If the sleep ended before the last call
    was queued (the start event had completed by then), the device may
    have waited on the host: the run is repeated behind a longer sleep,
    up to 2 s, and counted in ``UNCOVERED`` if it still was. Wall ms:
    the same calls back to back on the host clock, ending in a
    synchronize, launch cost included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()                       # the queue is empty: this times the enqueue
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = min(2 * enqueue_s * iters, 2.0)
    for _ in range(3):
        # at most 2e9 SM cycles a second on an H100
        torch.cuda._sleep(int(sleep_s * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered or sleep_s >= 2.0:
            break
        sleep_s = min(4 * sleep_s, 2.0)
    UNCOVERED[0] += not covered
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(end) / iters, wall


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    if smi.returncode or not lines:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "--id=0"], capture_output=True, text=True, timeout=60)
    if clk.returncode:
        fail(f"nvidia-smi failed: {clk.stderr.strip()}")
    return {"name": torch.cuda.get_device_name(0), "smi": lines,
            "clock_max_mhz": float(clk.stdout.split()[0]),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = (lib.parent / "ptxas.log").read_text().splitlines()
    usage = [ln.split("ptxas info    :")[-1].strip() for ln in log
             if "registers" in ln or "spill" in ln]
    return {"seconds": time.perf_counter() - t0, "library": str(lib),
            "ptxas": usage}


def drive_route(route, spec, gen_call, overrides, device):
    """Build and query one graph on the card; returns (record, index,
    s, t, graph) and checks answers against Dijkstra (and, for a
    compressed index, that the codec is delta16 with an int32 distance
    plane). ``graph`` is the generated (n, src, dst, w)."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, ref, sync
    from repro_torch.graphs import generators as gen

    t0 = time.perf_counter()
    fn, args, seed = gen_call
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(**overrides),
                                 device=device)
        mode = idx.engine.relaxer.mode if idx.engine.relaxer else "none"
        rng = np.random.default_rng(0)
        s = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        t = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
        times, syncs = [], []
        build_peak = torch.cuda.max_memory_allocated()
        for _ in range(2):       # first call builds the core layouts
            torch.cuda.reset_peak_memory_stats()
            with sync.sync_span() as span:
                t1 = time.perf_counter()
                ans = idx.query(s, t)   # ends on a blocking read of rounds
                times.append((time.perf_counter() - t1) * 1e3)
            syncs.append(span.count)
        repeats = []
        for _ in range(QUERY_REPEATS):
            t1 = time.perf_counter()
            idx.query(s, t)
            repeats.append((time.perf_counter() - t1) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if mode != route:
        fail(f"{spec}: expected route {route}, took {mode}")
    eng = idx.engine
    if overrides.get("label_dtype", "fp32") != "fp32" and (
            eng.codec != "delta16" or eng.enc_d.dtype != torch.int32):
        fail(f"{spec}: codec {eng.codec} with a {eng.enc_d.dtype} distance "
             f"plane, expected delta16 with int32")
    got = ans.cpu().numpy()
    n_check = min(MAIN_QUERIES, 16 if n > 100_000 else 128)
    oracle = ref.dijkstra_oracle(n, src, dst, w, s[:n_check])
    want = oracle[np.arange(n_check), t[:n_check]].astype(np.float32)
    if got.shape != (MAIN_QUERIES,) or not np.array_equal(got[:n_check], want):
        fail(f"{spec}: answers differ from Dijkstra on the first {n_check} "
             f"sources")
    if np.isnan(got).any():
        fail(f"{spec}: NaN answers")
    st = idx.stats
    rec = {"route": mode, "graph": spec, "n": n, "m": len(src) // 2,
           "k": st.k, "n_core": st.n_core, "m_core": st.m_core // 2,
           "gen_s": gen_s, "build_s": st.build_seconds,
           "peel_s": st.peel_seconds, "label_s": st.label_seconds,
           "mis_rounds": st.mis_rounds, "peel_iters": st.peel_iters,
           "peel_loop_syncs": st.peel_loop_syncs,
           "syncs_per_level": st.peel_loop_syncs / max(1, st.peel_iters),
           "build_syncs": st.host_syncs,
           "rounds": idx.engine._last_rounds,
           "query_ms_first": times[0], "query_ms": times[1],
           "query_ms_median": statistics.median(repeats),
           "query_ms_repeats": repeats,
           "query_syncs": syncs[1], "queries": MAIN_QUERIES,
           "dijkstra_checked": n_check,
           "peak_device_bytes_build": build_peak,
           "peak_device_bytes_query": torch.cuda.max_memory_allocated(),
           "label_entries": st.label_entries, "codec": eng.codec}
    if eng.codec == "delta16":
        from repro_torch.core.labels import encoded_nbytes
        rec["label_plane_bytes_fp32"] = (eng.lbl_ids.numel() * 4
                                         + eng.lbl_d.numel() * 4)
        rec["label_plane_bytes_encoded"] = encoded_nbytes(
            eng.enc_ids, eng.enc_base, eng.enc_d)
        rec["enc_d_dtype"] = str(eng.enc_d.dtype)
    return rec, idx, s, t, (n, src, dst, w)


def phase_builders(fp32_1e6) -> dict:
    """Host and device builders on one graph and seed: the same
    hierarchy and labels, bitwise; then whether the labels of the 10^6
    graph (``fp32_1e6``, an fp32 index) would fit the delta16 codec."""
    import numpy as np
    import torch
    from repro_torch.core import ISLabelIndex, IndexConfig, sync
    from repro_torch.core.labels import LabelCompressionError, encode_labels
    from repro_torch.graphs import generators as gen

    spec, (fn, args, seed), overrides = BUILDER_GRAPH
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    built, rec = {}, {"graph": spec, "n": n}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for builder in ("host", "device"):
            idx = ISLabelIndex.build(
                n, src, dst, w, IndexConfig(builder=builder, **overrides),
                device="cuda")
            st = idx.stats
            rec[builder] = {"build_s": st.build_seconds,
                            "peel_s": st.peel_seconds, "k": st.k,
                            "peel_iters": st.peel_iters,
                            "peel_loop_syncs": st.peel_loop_syncs,
                            "syncs_per_level":
                                st.peel_loop_syncs / max(1, st.peel_iters)}
            labels = sync.host_read((idx.lbl_ids, idx.lbl_d, idx.lbl_pred))
            built[builder] = (idx.level, idx.up_ids, idx.up_w, idx.up_via,
                              idx.core_src, idx.core_dst, idx.core_w,
                              idx.core_via, *labels)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fields = ("level", "up_ids", "up_w", "up_via", "core_src", "core_dst",
              "core_w", "core_via", "lbl_ids", "lbl_d", "lbl_pred")
    differ = [f for f, a, b in zip(fields, built["host"], built["device"])
              if a.dtype != b.dtype or not np.array_equal(a, b)]
    if differ:
        fail(f"{spec}: host and device builders differ in {differ}")
    rec["bitwise_equal"] = list(fields)

    # outside any timed region: one host copy of the 10^6 labels
    ids, d = sync.host_read((fp32_1e6.lbl_ids, fp32_1e6.lbl_d))
    try:
        encode_labels(ids, d, fp32_1e6.n)
        rec["delta16_fits_1e6"] = {"fits": True}
    except LabelCompressionError as err:
        rec["delta16_fits_1e6"] = {"fits": False, "reason": str(err)}
    return rec


def zero(tables) -> None:
    for tab in tables:
        for key in tab:
            tab[key] = 0


def launches_of(tables) -> dict:
    return {k: v for tab in tables for k, v in tab.items()}


def check_launches(what, launches, kernels) -> None:
    launched = {k for k, v in launches.items() if v}
    if launched != kernels:
        fail(f"{what} launched {sorted(launched)}, expected "
             f"{sorted(kernels)}")


def host_batch(out):
    """A ``PathBatch`` of numpy arrays (one blocking read)."""
    from repro_torch.core.sync import host_read
    return type(out)(*host_read(tuple(out)))


def phase_paths(path, idx, s, t, graph, tables) -> dict:
    """The path lane on one main path's index: ``path_batch_fn(256)`` on
    the path's 1024 pairs (two calls, then ``PATH_REPEATS`` timed ones,
    each ending on the blocking read of the batch), under sync debug
    mode "error", with the launch counters zeroed around it. ``dist``
    must equal the query's answers bitwise and ``rounds`` the query's
    count; every path must pass ``check_path_batch`` against the
    generated edge list (after escalating ``hop_cap`` as ``paths()``
    does, where one overflowed); on ``ORACLE_PATHS`` the host oracle
    ``shortest_path`` must give the query's distance and a valid path on
    8 pairs."""
    import numpy as np
    import torch
    from repro_torch.core import sync
    from repro_torch.paths import (check_path_batch, check_vertex_path,
                                   edge_weight_map)
    zero(tables)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        eng = idx.path_engine()
        engine_ms = (time.perf_counter() - t0) * 1e3
        fn = eng.path_batch_fn(PATH_HOP_CAP)
        times, syncs = [], []
        for _ in range(2):
            with sync.sync_span() as span:
                t1 = time.perf_counter()
                batch = host_batch(fn(s, t))
                times.append((time.perf_counter() - t1) * 1e3)
            syncs.append(span.count)
        repeats = []
        for _ in range(PATH_REPEATS):
            t1 = time.perf_counter()
            host_batch(fn(s, t))
            repeats.append((time.perf_counter() - t1) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launches_of(tables)
    check_launches(f"path lane on {path}", launches, PATH_LANE_KERNELS[path])
    peak = torch.cuda.max_memory_allocated()
    want = sync.host_read(idx.query(s, t))
    if not np.array_equal(batch.dist, want):
        fail(f"{path}: path-lane distances differ from the query's")
    if int(batch.rounds) != idx.engine._last_rounds:
        fail(f"{path}: path lane ran {int(batch.rounds)} rounds, the query "
             f"{idx.engine._last_rounds}")
    n, src, dst, w = graph
    edges = edge_weight_map(src, dst, w)
    hc, escalations, checked = PATH_HOP_CAP, 0, batch
    overflowed = int((~batch.ok).sum())
    while not checked.ok.all() and escalations < 4:
        hc, escalations = 2 * hc, escalations + 1
        checked = host_batch(eng.path_batch_fn(hc)(s, t))
    rep = check_path_batch(edges, s, t, checked)
    if rep["violations"] or rep["overflowed"]:
        fail(f"{path}: path check failed at hop_cap {hc}: "
             f"{rep['overflowed']} overflowed, {rep['violations'][:3]}")
    rec = {"hop_cap": PATH_HOP_CAP, "queries": len(s),
           "path_ms_first": times[0], "path_ms": times[1],
           "path_ms_median": statistics.median(repeats),
           "path_ms_repeats": repeats, "path_syncs": syncs[1],
           "engine_ms": engine_ms, "rounds": int(batch.rounds),
           "overflowed": overflowed, "escalations": escalations,
           "lens_max": int(checked.lens.max()),
           "lens_mean": float(checked.lens[checked.lens > 0].mean()),
           "reachable": int(np.isfinite(batch.dist).sum()),
           "checked": rep["checked"], "launches": launches,
           "chase_width": int(eng.ell_ids.shape[1]),
           "peak_device_bytes_path": peak}
    if path in ORACLE_PATHS:
        for i in range(8):
            d, p = idx.shortest_path(int(s[i]), int(t[i]))
            bad = check_vertex_path(edges, int(s[i]), int(t[i]), d, p)
            if np.float32(d) != want[i] or bad:
                fail(f"{path}: shortest_path({s[i]}, {t[i]}) gave {d} "
                     f"(query {want[i]}) {bad[:2]}")
        rec["oracle_pairs"] = 8
    return rec


def phase_mutation(tables, device="cuda") -> dict:
    """§8.3 on a hold-out build of ``MUTATION_GRAPH``: u is the last
    vertex of degree 2–6 in the graph's largest component; the index is
    built without u's edges. Then ``MUTATION_CYCLES`` times
    ``insert_vertex(u, ...)`` and ``delete_vertex(u)``, each timed on
    the host clock (the engine rebuild included), under sync debug mode
    "error". After the first insert, u's distances to every vertex are
    never shorter than Dijkstra's on the full graph and finite only
    where u reaches (the lazy insert is exact where u attaches to the
    core, and otherwise reaches only its neighbours' descendants), and
    u's paths to 1024 vertices and to every vertex it reaches pass
    ``check_path_batch`` against the full graph's edges with ``dist``
    equal to the query's (paths through an entry pushed into a non-core
    neighbour come back ``ok=False``, as in the JAX package, and are
    counted). After the last delete (the exact
    inverse of the insert), answers on 1024 pairs equal the hold-out
    index's before the first insert, and on 256 of them are never
    shorter than Dijkstra's without u (the rule of
    ``tests/test_paths_updates.py::test_delete_vertex``)."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import connected_components
    from repro_torch.core import ISLabelIndex, IndexConfig, ref, sync
    from repro_torch.graphs import generators as gen
    from repro_torch.paths import check_path_batch, edge_weight_map

    spec, (fn, args, seed), overrides = MUTATION_GRAPH
    n, src, dst, w = getattr(gen, fn)(*args, seed=seed)
    deg = np.bincount(src, minlength=n)
    _, comp = connected_components(ref.build_csr(n, src, dst, w))
    giant = comp == np.bincount(comp).argmax()
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
    t = rng.integers(0, n, MAIN_QUERIES).astype(np.int32)
    u = int(np.flatnonzero(giant & (deg >= 2) & (deg <= 6))[-1])
    keep = (src != u) & (dst != u)
    nbrs, ws = dst[src == u].tolist(), w[src == u].tolist()
    zero(tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = ISLabelIndex.build(n, src[keep], dst[keep], w[keep],
                                 IndexConfig(**overrides), device=device)
        level_u = int(idx.level[u])
        nbrs_core = int((idx.level[nbrs] == idx.k).sum())
        before = sync.host_read(idx.query(s, t))
        insert_ms, delete_ms = [], []
        for cycle in range(MUTATION_CYCLES):
            t0 = time.perf_counter()
            touched = idx.insert_vertex(u, nbrs, ws)
            insert_ms.append((time.perf_counter() - t0) * 1e3)
            if cycle == 0:
                touched_ins = touched
                row = sync.host_read(idx.query(np.full(n, u, np.int32),
                                               np.arange(n, dtype=np.int32)))
                # 1024 random targets, then every vertex u reaches
                ends = np.concatenate([t, np.flatnonzero(np.isfinite(row))])
                ends = ends.astype(np.int32)
                us = np.full(len(ends), u, np.int32)
                batch = host_batch(
                    idx.path_engine().path_batch_fn(PATH_HOP_CAP)(us, ends))
            t0 = time.perf_counter()
            touched_del = idx.delete_vertex(u)
            delete_ms.append((time.perf_counter() - t0) * 1e3)
        after = sync.host_read(idx.query(s, t))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = launches_of(tables)
    check_launches("mutation", launches, MUTATION_KERNELS)
    full = ref.dijkstra_oracle(n, src, dst, w, [u])[0].astype(np.float32)
    fin = np.isfinite(row)
    if not (np.isfinite(full[fin]).all() and (row[fin] >= full[fin]).all()):
        fail(f"{spec}: after inserting {u} a distance is shorter than "
             f"Dijkstra's, or finite where {u} does not reach")
    if not np.array_equal(batch.dist, row[ends]):
        fail(f"{spec}: paths of {u} differ in distance from its queries")
    # a path through an entry the insert pushed into a non-core
    # neighbour v cannot be chased (its pred is v itself, as in the JAX
    # package): ok drops there, and only there may a path be missing
    rep = check_path_batch(edge_weight_map(src, dst, w), us, ends, batch)
    if rep["violations"]:
        fail(f"{spec}: paths of {u}: {rep['violations'][:3]}")
    if not np.array_equal(after, before):
        fail(f"{spec}: deleting {u} did not restore the answers")
    m = 256
    mask = (s[:m] != u) & (t[:m] != u)
    want = ref.dijkstra_oracle(n, src[keep], dst[keep], w[keep], s[:m][mask])[
        np.arange(mask.sum()), t[:m][mask]].astype(np.float32)
    got = after[:m][mask]
    ok = np.isfinite(got)
    cover = ok & np.isfinite(want)
    if not ((got[ok] >= want[ok]).all()
            and (got[cover] == want[cover]).mean() > 0.8):
        fail(f"{spec}: answers after deleting {u} break the conservative "
             f"rule")
    return {"graph": spec, "n": n, "u": u, "degree": int(deg[u]),
            "neighbours_in_core": nbrs_core, "level_before": level_u,
            "k": idx.k,
            "insert_ms": insert_ms, "delete_ms": delete_ms,
            "insert_ms_median": statistics.median(insert_ms),
            "delete_ms_median": statistics.median(delete_ms),
            "touched_insert": len(touched_ins),
            "touched_delete": len(touched_del),
            "row_reachable": int(fin.sum()),
            "dijkstra_reachable": int(np.isfinite(full).sum()),
            "row_exact": int((row[fin] == full[fin]).sum()),
            "paths_checked": rep["checked"], "paths_not_ok": rep["overflowed"],
            "paths_reachable": int(np.isfinite(batch.dist).sum()),
            "delete_exact_share": float((got[cover] == want[cover]).mean()),
            "launches": launches}


def profile_idle(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: host wall ms, the time
    the device was busy (the union of the kernels' and copies'
    intervals in the trace), and the device's idle share of the wall
    time; repeated up to three times while the trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "attempts": attempt,
            "idle_share": (1 - busy_us / 1e3 / wall_ms) if spans else None,
            "device_events": len(spans),
            "top": [{"name": k[:80], "device_ms": ms, "count": c}
                    for k, (ms, c) in top]}


class LaneMeter:
    """Instruments one ``DistanceServer``'s lanes for the serving phase:
    the kernel launches and the counted syncs inside each lane's entry
    point, and the wall time of each executed batch (``_execute`` /
    ``_execute_path``, whose timed ``exec_s`` the metrics hold). The
    entry points keep their ``shapes``, so ``compile_cache_sizes``
    reads through."""

    def __init__(self, srv, tables):
        from repro_torch.core import sync
        self.tables = tables
        self.launches: dict = {}
        self.inner_syncs: dict = {}
        self.exec_wall_s: dict = {}

        def entry(fn, lane):
            def run(s, t):
                before = launches_of(tables)
                with sync.sync_span() as span:
                    out = fn(s, t)
                after = launches_of(tables)
                tab = self.launches.setdefault(lane, {})
                for k, v in after.items():
                    tab[k] = tab.get(k, 0) + v - before[k]
                self.inner_syncs[lane] = (self.inner_syncs.get(lane, 0)
                                          + span.count)
                return out
            run.shapes = fn.shapes
            return run

        def timed(fn, lane_of):
            def run(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                lane = lane_of(args)
                self.exec_wall_s[lane] = (self.exec_wall_s.get(lane, 0.0)
                                          + time.perf_counter() - t0)
                return out
            return run

        srv._fns = {lane: entry(fn, lane) for lane, fn in srv._fns.items()}
        srv._path_fns = {h: entry(fn, "path")
                         for h, fn in srv._path_fns.items()}
        srv._execute = timed(srv._execute, lambda a: a[0])
        srv._execute_path = timed(srv._execute_path, lambda a: "path")

    def reset(self) -> None:
        self.launches.clear()
        self.inner_syncs.clear()
        self.exec_wall_s.clear()


def lane_batches(batches) -> dict:
    """{lane: {bucket: batches}} of a list of ``BatchRecord``s."""
    out: dict = {}
    for b in batches:
        tab = out.setdefault(b.lane, {})
        tab[str(b.bucket)] = tab.get(str(b.bucket), 0) + 1
    return out


def check_lanes(what, meter, batches, kernels) -> None:
    """Each lane that ran a batch launched exactly its kernels; a lane
    that ran none launched nothing."""
    ran = {b.lane for b in batches}
    for lane, want in kernels.items():
        got = {k for k, v in meter.launches.get(lane, {}).items() if v}
        if got != (want if lane in ran else set()):
            fail(f"{what}: lane {lane} launched {sorted(got)}, expected "
                 f"{sorted(want) if lane in ran else []}")


def replay_record(srv, meter, batches, wall_s, syncs) -> dict:
    """The serving numbers of one replay: the metrics of its batches
    (``batches``, this replay's ``BatchRecord``s) and the host share of
    a batch (``_execute`` wall time minus the timed ``exec_s``)."""
    import numpy as np
    exec_s = sum(b.exec_s for b in batches)
    wall_exec = sum(meter.exec_wall_s.values())
    per_lane = {}
    for lane in sorted({b.lane for b in batches}):
        bs = [b for b in batches if b.lane == lane]
        lane_exec = sum(b.exec_s for b in bs)
        per_lane[lane] = {
            "batches": len(bs), "requests": sum(b.n_real for b in bs),
            "exec_ms_mean": lane_exec / len(bs) * 1e3,
            "host_ms_per_batch": (meter.exec_wall_s[lane] - lane_exec)
            / len(bs) * 1e3,
            "fill": float(np.mean([b.fill for b in bs])),
            "rounds_mean": float(np.mean([b.rounds for b in bs])),
            "launches": dict(meter.launches.get(lane, {})),
            "entry_syncs": meter.inner_syncs.get(lane, 0)}
    return {"batches": len(batches), "replay_wall_s": wall_s,
            "exec_s": exec_s, "batch_wall_s": wall_exec,
            "host_ms_per_batch": (wall_exec - exec_s) / len(batches) * 1e3,
            "host_share_of_batch": (wall_exec - exec_s) / wall_exec,
            "syncs": syncs, "lanes": per_lane,
            "by_lane_bucket": lane_batches(batches)}


def phase_serving(path, route, idx, graph, tables, kernels) -> dict:
    """The serving engine (``repro_torch.serve.DistanceServer``) on one
    main path's index: buckets 64/256/1024, a 2 ms deadline and a
    65,536-entry cache. A ``hotspot`` and a ``uniform`` trace
    (``make_trace``, seed 0, 50,000 req/s on the trace clock) replayed
    under sync debug mode "error": every served answer equal to
    ``idx.query`` bitwise (and, on ``SERVE_ORACLE``, a Dijkstra sample);
    each lane launching exactly its kernels (``mu``: the label kernel;
    ``full``: that and the route's stage-2 kernel); no first-use build
    in ``serve_read`` and ``compile_cache_sizes`` unchanged; exactly one
    counted sync a batch beyond the entry points' own exit-flag reads
    (none on the fused route). Then one more ``uniform`` replay, cache
    cleared, under ``torch.profiler`` (the device's idle share); the
    section-0 check (``classify`` and ``query_host`` on CUDA tensors
    equal to the same calls on numpy arrays, ``classify`` in one
    ``host_read``); and on ``SERVE_PATH_REQUESTS`` a path-lane replay at
    hop caps 64 and 256 whose paths all pass the launcher's
    ``_audit_paths``. Returns the record and the launches of the served
    batches."""
    import numpy as np
    import torch
    from repro_torch.core import ref, sync
    from repro_torch.launch.serve import _audit_paths
    from repro_torch.obs import BuildWatcher
    from repro_torch.serve import DistanceServer, make_trace

    stage2 = PATH_LANE_KERNELS[path]
    lane_kernels = {"mu": kernels - stage2, "full": kernels}
    n, src, dst, w = graph
    n_req = SERVE_REQUESTS.get(path, 4096)
    kw = dict(buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS,
              cache_size=SERVE_CACHE)
    zero(tables)
    with BuildWatcher() as builds:
        srv = DistanceServer(idx, name=path, **kw)
    rec = {"buckets": list(SERVE_BUCKETS), "max_wait_ms": SERVE_WAIT_MS,
           "cache_size": SERVE_CACHE, "rate_qps": SERVE_RATE,
           "requests": n_req, "warmup_seconds": srv.warmup_seconds,
           "warmup_builds": builds.snapshot(), "replays": {}}
    meter = LaneMeter(srv, tables)
    served_launches: dict = {}
    for scenario in SERVE_SCENARIOS:
        trace = make_trace(scenario, n=n, num_requests=n_req,
                           rate_qps=SERVE_RATE, seed=0)
        shapes = srv.compile_cache_sizes()
        first = len(srv.metrics.batches)
        hits0 = srv.metrics.cache_hits
        meter.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with BuildWatcher() as watch, sync.sync_span() as span:
                t0 = time.perf_counter()
                served = srv.serve_trace(trace)
                wall_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        batches = srv.metrics.batches[first:]
        what = f"serving {scenario} on {path}"
        if watch.count("serve_read") or watch.count():
            fail(f"{what}: first-use builds after warmup "
                 f"{watch.snapshot()}")
        if srv.compile_cache_sizes() != shapes:
            fail(f"{what}: shapes {shapes} -> {srv.compile_cache_sizes()}")
        inner = sum(meter.inner_syncs.values())
        if span.count - inner != len(batches) or (
                route == "fused" and inner):
            fail(f"{what}: {span.count} syncs for {len(batches)} batches "
                 f"({inner} inside the entry points)")
        check_lanes(what, meter, batches, lane_kernels)
        for tab in meter.launches.values():
            for k, v in tab.items():
                served_launches[k] = served_launches.get(k, 0) + v
        want = sync.host_read(idx.query(trace.s, trace.t))
        if served.shape != want.shape or not np.array_equal(served, want):
            fail(f"{what}: {int((served != want).sum())} answers differ "
                 f"from idx.query")
        one = replay_record(srv, meter, batches, wall_s, span.count)
        one.update(cache_hits=srv.metrics.cache_hits - hits0,
                   cache_hit_rate=(srv.metrics.cache_hits - hits0) / n_req)
        if path in SERVE_ORACLE:
            k = SERVE_ORACLE[path]
            srcs, inv = np.unique(trace.s[:k], return_inverse=True)
            oracle = ref.dijkstra_oracle(n, src, dst, w, srcs)
            if not np.array_equal(served[:k], oracle[inv, trace.t[:k]]
                                  .astype(np.float32)):
                fail(f"{what}: answers differ from Dijkstra")
            one["dijkstra_checked"] = k
        # the per-request routing cost (route of one pair, as submit
        # without a lane does it)
        t0 = time.perf_counter()
        for i in range(256):
            srv.route(int(trace.s[i]), int(trace.t[i]))
        one["route_us_per_request"] = (time.perf_counter() - t0) / 256 * 1e6
        t0 = time.perf_counter()
        srv.route(trace.s, trace.t)
        one["route_s"] = time.perf_counter() - t0
        rec["replays"][scenario] = one
    snap = srv.metrics.snapshot()
    rec.update({k: snap[k] for k in (
        "served", "qps_compute", "qps_offered", "latency_ms",
        "batch_fill_ratio", "cache_hit_rate", "bucket_counts",
        "query_types")})
    rec["by_lane_bucket"] = lane_batches(srv.metrics.batches)
    rec["compiled_shapes"] = srv.compile_cache_sizes()

    # the device's idle share of one replay (cache cleared)
    trace = make_trace("uniform", n=n, num_requests=n_req,
                       rate_qps=SERVE_RATE, seed=0)
    srv.cache.clear()
    rec["profile"] = profile_idle(lambda: srv.serve_trace(trace))

    # section 0: classify and query_host take CUDA tensors
    s_np, t_np = trace.s[:256], trace.t[:256]
    s_cu, t_cu, lev_cu = (torch.as_tensor(x, device=idx.device)
                          for x in (s_np, t_np, idx.level))
    with sync.sync_span() as span:
        cls = idx.engine.classify(s_cu, t_cu, lev_cu, idx.k)
    if span.count != 1 or not np.array_equal(
            cls, idx.engine.classify(s_np, t_np, idx.level, idx.k)):
        fail(f"{path}: classify on CUDA tensors ({span.count} syncs) "
             f"differs from classify on numpy arrays")
    if not (np.array_equal(idx.query_types(s_cu, t_cu),
                           idx.query_types(s_np, t_np))
            and np.array_equal(idx.query_host(s_cu, t_cu),
                               idx.query_host(s_np, t_np))):
        fail(f"{path}: query_types or query_host differ on CUDA tensors")
    rec["cuda_tensor_inputs"] = "equal"

    if path in SERVE_PATH_REQUESTS:
        with BuildWatcher() as builds:
            psrv = DistanceServer(idx, name=f"{path}-paths",
                                  path_hop_caps=SERVE_HOP_CAPS, **kw)
        pmeter = LaneMeter(psrv, tables)
        trace = make_trace("hotspot", n=n,
                           num_requests=SERVE_PATH_REQUESTS[path],
                           rate_qps=SERVE_RATE, seed=0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with BuildWatcher() as watch:
                t0 = time.perf_counter()
                dist, paths, valid = psrv.serve_path_trace(trace)
                wall_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        what = f"path lane serving on {path}"
        if watch.count():
            fail(f"{what}: first-use builds after warmup "
                 f"{watch.snapshot()}")
        batches = psrv.metrics.batches
        check_lanes(what, pmeter, batches, {"path": stage2})
        for k, v in pmeter.launches.get("path", {}).items():
            served_launches[k] = served_launches.get(k, 0) + v
        if _audit_paths(src, dst, w, trace, dist, paths, valid):
            fail(f"{what}: a served path failed the audit")
        want = sync.host_read(idx.query(trace.s, trace.t))
        if not np.array_equal(dist, want):
            fail(f"{what}: distances differ from idx.query")
        psnap = psrv.metrics.snapshot()
        one = replay_record(psrv, pmeter, batches, wall_s, None)
        one.update(requests=len(trace), hop_caps=list(SERVE_HOP_CAPS),
                   warmup_seconds=psrv.warmup_seconds,
                   warmup_builds=builds.snapshot(),
                   path_overflows=psnap["path_overflows"],
                   qps_compute=psnap["qps_compute"],
                   latency_ms=psnap["latency_ms"],
                   cache_hit_rate=psnap["cache_hit_rate"],
                   path_vertices_max=max(len(p) for p in paths))
        rec["path_lane"] = one
    rec["launches"] = served_launches
    return rec


def label_seeds(idx, s, t):
    """The stage-2 label seeds of one query batch, as ``QueryEngine``
    hands them to ``CoreRelaxer.run``, and the gathered label rows."""
    import torch
    from repro_torch.core.labels import decode_rows
    eng = idx.engine
    rs, rt = (eng._rows(torch.as_tensor(x, device=idx.device))
              for x in (s, t))
    seeds = [eng._label_seeds(*decode_rows(r, idx.n, eng.codec))
             for r in (rs, rt)]
    return seeds, rs, rt


def frontier(idx, s, t, vp: int):
    """The stacked, padded [2Q, Vp] row-major stage-2 seeds of one query
    batch (the fused and dense routes' layout)."""
    from repro_torch.core.dispatch import seed_rows, stack_frontiers
    seeds, rs, rt = label_seeds(idx, s, t)
    v = idx.engine.n_core + 1
    return stack_frontiers(*(seed_rows(x, v) for x in seeds), vp, 8), rs, rt


def _fns():
    """name -> (CUDA kernel binding, plain PyTorch version)."""
    from repro_torch.kernels.label_intersect.kernel import (
        label_intersect_kernel, label_intersect_packed_kernel)
    from repro_torch.kernels.label_intersect.ref import (
        label_intersect_packed_ref, label_intersect_ref)
    from repro_torch.kernels.minplus_matmul.kernel import \
        minplus_matmul_kernel
    from repro_torch.kernels.minplus_matmul.ref import minplus_matmul_ref
    from repro_torch.kernels.spmv_relax.kernel import (fused_relax_kernel,
                                                       spmv_relax_kernel)
    from repro_torch.kernels.spmv_relax.ref import (fused_relax_ref,
                                                    spmv_relax_ref)
    return {
        "label_intersect_kernel": (label_intersect_kernel,
                                   label_intersect_ref),
        "spmv_relax_kernel": (spmv_relax_kernel, spmv_relax_ref),
        # the last argument picks the kernel's variant; the plain version
        # has none
        "fused_relax_kernel": (
            lambda d, edges, r, var: fused_relax_kernel(
                d, edges, max_rounds=r, variant=var),
            lambda d, edges, r, var: fused_relax_ref(d, edges, r)),
        "minplus_matmul_kernel": (minplus_matmul_kernel, minplus_matmul_ref),
        "label_intersect_packed_kernel": (label_intersect_packed_kernel,
                                          label_intersect_packed_ref),
    }


def fused_variants(v: int) -> list:
    """The fused kernel's variants that take a core of ``v`` vertices:
    the global one always, the shared one where the route picks it."""
    from repro_torch.kernels.spmv_relax.kernel import fused_variant
    return sorted({"global", fused_variant(v)})


def fused_work(d0, edges, blk_rounds, bq: int = 8) -> int:
    """Operations the fused route's rounds need on this input: per block
    and round, an add and a min for each (row, in-edge) whose source
    changed in the block's previous round (any row finite before the
    first), and a min per entry."""
    import torch
    from repro_torch.kernels.spmv_relax.ref import _edge_round, sliced_dst
    live = torch.isfinite(edges.w)
    src = edges.src.long()[live]
    dst = sliced_dst(edges)[live]
    q, v = d0.shape
    nb = q // bq
    d = d0
    changed = torch.isfinite(d).view(nb, bq, v).any(1)
    pairs = 0
    for r in range(int(blk_rounds.max())):
        on = blk_rounds > r
        pairs += int((changed[:, src].sum(1) * on).sum()) * bq
        d2 = _edge_round(d, src, dst, edges.w[live])
        changed = (d2 < d).view(nb, bq, v).any(1)
        d = d2
    return 2 * pairs + int(blk_rounds.sum()) * bq * v


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# spmv_relax_kernel's operands that it writes (out, changed_out, flag_out)
OUTPUT_ARGS = {"spmv_relax_kernel": (4, 5, 6)}


def _own_outputs(name, args):
    """``args`` with copies of the operands that the kernel writes, so
    kernel and plain version start from the same contents and leave the
    caller's buffers alone."""
    outs = OUTPUT_ARGS.get(name, ())
    return tuple(a.clone() if i in outs else a for i, a in enumerate(args))


def compare(name, args) -> float:
    """Run kernel and plain version on ``args``; fail unless every output
    is ``torch.equal``. Returns the max abs error (0.0)."""
    import torch
    kernel, plain = _fns()[name]
    outs = _as_tuple(kernel(*_own_outputs(name, args)))
    refs = _as_tuple(plain(*_own_outputs(name, args)))
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        if not torch.equal(a, b):
            shapes = [tuple(x.shape) for x in args if hasattr(x, "shape")]
            fail(f"{name}: kernel differs from its plain version at "
                 f"{shapes} (max abs err {max_abs_err(a, b)})")
    return max(max_abs_err(a, b) for a, b in zip(outs, refs))


def phase_ragged(dev="cuda") -> dict:
    """Each kernel against its plain version on small random inputs off
    every block multiple — before the main path leans on them."""
    import numpy as np
    import torch
    from repro_torch.core.labels import encode_labels
    from repro_torch.kernels.spmv_relax.kernel import (HEAVY_DEGREE,
                                                       ROW_TILE, RelaxCSR,
                                                       SlicedEdges)
    from repro_torch.kernels.spmv_relax.ops import coo_to_csr, coo_to_sliced
    g = torch.Generator(device=dev).manual_seed(0)
    r = np.random.default_rng(0)
    inf = float("inf")

    def packed_rows(q, l, n_sent, d_dtype):
        """Encoded s and t rows: t shares about half of each s row's ids;
        rows of every fill, a fully padded row, a row whose slot 0 is a
        pad with stray deltas after it, and a gap of exactly 32767. The
        ids of a row lie in one window of 2**15, so every gap fits."""
        ids = np.full((2, q, l), n_sent, np.int64)
        span = min(n_sent, 2 ** 15)
        for i in range(q):
            lo = 7 if i == 2 else int(r.integers(0, n_sent - span + 1))
            row = np.unique(r.integers(lo, lo + span,
                                       int(r.integers(0, l + 1))))
            if i == 2:
                row = np.array([lo, lo + span - 1])
            shared = row[r.random(len(row)) < 0.5]
            other = np.unique(r.integers(lo, lo + span, l - len(shared)))
            t_row = np.union1d(shared, other)[:l]
            ids[0, i, :len(row)] = row
            ids[1, i, :len(t_row)] = t_row
        d = np.where(ids < n_sent, r.integers(0, 90, ids.shape), inf)
        out = []
        for side in range(2):
            delta, base, d_enc = encode_labels(ids[side], d[side], n_sent,
                                               d_dtype)
            if q > 1:
                delta[0] = -1                               # all pad
                delta[1] = r.integers(0, 50, l)             # slot 0 pad,
                delta[1, 0] = -1                            # stray after it
            out += [torch.from_numpy(x).to(dev) for x in (delta, base, d_enc)]
        return (*out, n_sent)

    def rows(q, l, n_sent):
        ids = torch.randint(0, n_sent + 1, (q, l), generator=g, device=dev,
                            dtype=torch.int64).sort(1).values.to(torch.int32)
        dup = torch.zeros_like(ids, dtype=torch.bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        ids = torch.where(dup, n_sent, ids).sort(1).values
        d = torch.randint(0, 9, (q, l), generator=g, device=dev).float()
        return ids, torch.where(ids < n_sent, d, inf)

    def plane_cases(n, l, q, dup, d_dtype=None):
        """Label planes [n+1, L] read in place by endpoint id, and the
        same rows gathered (null index): rows of 0, 1, 31, 32, 33, 63,
        64, 65, 96 and 97 real ids (cut to L), then random counts; with
        ``dup`` every third row has repeated ids (any distances); row n
        all pad. Endpoints (the last Q of): those rows against each other
        and themselves, repeated ids, random ids, and n on either side and
        both; then the in-place case again with ids n, n+3, -1, -2 and
        -(n+5) among the endpoints. ``d_dtype`` encodes the planes as
        delta16 with that distance plane."""
        counts = (0, 1, 31, 32, 33, 63, 64, 65, 96, 97)
        ids = np.full((n + 1, l), n, np.int64)
        d = np.full((n + 1, l), inf)
        for v in range(n):
            k = min(l, counts[v] if v < len(counts)
                    else int(r.integers(0, l + 1)))
            ids[v, :k] = np.sort(r.choice(n, k, replace=dup and v % 3 == 0))
            d[v, :k] = r.integers(0, 90, k)
        if d_dtype is None:
            planes = (ids.astype(np.int32), d.astype(np.float32))
        else:
            planes = encode_labels(ids, d, n, d_dtype)
        planes = [torch.from_numpy(x).to(dev) for x in planes]
        k = len(counts)
        s, t = (r.integers(0, n + 1, max(q, 2 * k + 8)) for _ in range(2))
        s[:2 * k] = np.tile(np.arange(k), 2)
        t[:2 * k] = np.concatenate([np.arange(k), np.roll(np.arange(k), 1)])
        s[2 * k:2 * k + 4] = s[2 * k + 4]
        s[-3:-1], t[-2:] = n, n
        s, t = (torch.from_numpy(x[-q:].astype(np.int32)).to(dev)
                for x in (s, t))
        gathered = [p[e.long()] for e in (s, t) for p in planes]
        # endpoint ids n, n+3, -1, -2 and -(n+5) on either side and both:
        # rows as the JAX package gathers them (row_index)
        odd = torch.tensor([n, n + 3, -1, -2, -(n + 5)], dtype=torch.int32,
                           device=dev)[torch.arange(q, device=dev) % 5]
        s_odd, t_odd = s.clone(), t.clone()
        s_odd[::3], t_odd[1::3] = odd[::3], odd.flip(0)[1::3]
        return [(*planes, *planes, n, s, t), (*gathered, n),
                (*planes, *planes, n, s_odd, t_odd)]

    def fused_cases(q, v, deg, max_rounds):
        """fused_relax operands, one case per variant that takes ``v``
        (``fused_variants``): about ``deg`` random in-edges a vertex into
        the first half of the vertices, a hub of in-degree 3 deg, one
        zero a row, the last block without seeds."""
        e = deg * v // 2
        src = np.concatenate([r.integers(0, v, e), r.integers(0, v, 3 * deg)])
        dst = np.concatenate([r.integers(0, max(1, v // 2), e),
                              np.full(3 * deg, v // 3)])
        w = r.integers(1, 5, len(src)).astype(np.float32)
        dist = torch.full((q, v), inf, device=dev)
        dist[torch.arange(q, device=dev),
             torch.randint(0, v, (q,), generator=g, device=dev)] = 0.0
        if q > 8:
            dist[q - 8:] = inf
        edges = SlicedEdges(*(torch.from_numpy(x).to(dev)
                              for x in coo_to_sliced(v, src, dst, w)))
        return [(dist, edges, max_rounds, var) for var in fused_variants(v)]

    def csr_case(vp, rows, e, hubs, mask, flag_in=1):
        """spmv_relax operands: e random edges into the first half of the
        vertices (the rest have no in-edges) plus one hub for each
        in-degree in ``hubs``, a frontier about 10% finite, a mask "all",
        "none" or "random", and outputs filled with garbage."""
        src = r.integers(0, vp, e)
        dst = r.integers(0, max(1, vp // 2), e)
        for hub, deg in enumerate(hubs):
            src = np.concatenate([src, r.integers(0, vp, deg)])
            dst = np.concatenate([dst, np.full(deg, 7 + hub)])
        w = r.integers(1, 9, len(src)).astype(np.float32)
        indptr, s_, w_, order, n_heavy = coo_to_csr(vp, src, dst, w)
        csr = RelaxCSR(*(torch.from_numpy(x).to(dev)
                         for x in (indptr, s_, w_, order)), n_heavy)
        dist = torch.randint(0, 30, (vp, rows), generator=g,
                             device=dev).float()
        dist[torch.rand((vp, rows), generator=g, device=dev) < 0.9] = inf
        n_tiles = -(-rows // ROW_TILE)
        changed = {"all": torch.ones, "none": torch.zeros}.get(mask)
        changed = (changed((n_tiles, vp), dtype=torch.bool, device=dev)
                   if changed else torch.rand((n_tiles, vp), generator=g,
                                              device=dev) < 0.3)
        flag = torch.full((1,), flag_in, dtype=torch.int32, device=dev)
        out = torch.full_like(dist, 5.0)
        chg_out = torch.rand((n_tiles, vp), generator=g, device=dev) < 0.5
        return (dist, csr, changed, flag, out, chg_out,
                torch.zeros(1, dtype=torch.int32, device=dev))

    def mat(m, k, p_inf):
        x = torch.randint(0, 20, (m, k), generator=g, device=dev).float()
        return torch.where(torch.rand((m, k), generator=g, device=dev)
                           < p_inf, inf, x)

    def inf_lines(m, k, n):
        """A [m, k] x [k, n] pair with all-inf rows of A and columns of B."""
        a, b = mat(m, k, 0.2), mat(k, n, 0.2)
        a[::7] = inf
        b[:, 3::5] = inf
        return a, b

    minplus = [(mat(37, 100, 0.3), mat(100, 70, 0.3)),
               (torch.full((65, 3), inf, device=dev),
                torch.ones((3, 129), device=dev)),
               (mat(130, 260, 0.5), mat(260, 5, 0.0)),
               (mat(200, 5, 0.1), mat(5, 131, 0.1)),      # K < one slice
               (mat(129, 1, 0.0), mat(1, 257, 0.3)),
               (mat(5, 0, 0.0), mat(0, 7, 0.0)),          # K = 0: all inf
               (mat(100, 40, 0.2), mat(40, 132, 0.2)),    # N % 4 == 0
               (mat(128, 48, 0.2), mat(48, 128, 0.2)),    # whole tiles
               inf_lines(257, 33, 190), inf_lines(300, 161, 260)]

    # (n, L, Q, duplicate ids) of the planes read in place; L on and off
    # the 32-slot chunks
    planes = ((1000, 45, 77, False), (1000, 64, 130, True),
              (300, 70, 41, True), (2000, 129, 200, False),
              (300, 257, 64, True), (400, 97, 5, False))
    cases = {
        "label_intersect_packed_kernel": [
            packed_rows(q, l, n_sent, d_dtype)
            for d_dtype in ("int32", "float32")
            for q, l, n_sent in ((13, 100, 100_000), (1, 1, 5),
                                 (40, 257, 300_000), (37, 33, 70_000))] + [
            case for d_dtype in ("int32", "float32") for n, l, q, dup in planes
            for case in plane_cases(n, l, q, dup, d_dtype)],
        "label_intersect_kernel": [
            (*rows(13, 100, 1000), *rows(13, 100, 1000), 1000),
            (*rows(1, 1, 5), *rows(1, 1, 5), 5),
            (*rows(40, 257, 300), *rows(40, 257, 300), 300)] + [
            case for n, l, q, dup in planes
            for case in plane_cases(n, l, q, dup)],
        "spmv_relax_kernel": [
            csr_case(1001, 40, 5000, (HEAVY_DEGREE + 1, HEAVY_DEGREE),
                     "random"),
            csr_case(77, 8, 200, (), "all"),
            csr_case(130, 16, 400, (HEAVY_DEGREE * 3,), "none"),
            csr_case(5003, 136, 30000, (2512,), "random"),
            csr_case(300, 48, 900, (600,), "all"),
            csr_case(700, 264, 3000, (300,), "random"),
            csr_case(1001, 256, 5000, (HEAVY_DEGREE + 1, 3 * HEAVY_DEGREE),
                     "random"),
            csr_case(500, 24, 2000, (), "all", flag_in=0)],
        # V on both sides of the shared variant's limit (3,521 vertices),
        # none a multiple of the 1024 threads
        "fused_relax_kernel": [
            case for q, v, deg, mr in (
                (24, 1000, 16, 10000), (8, 77, 32, 3), (16, 300, 16, 0),
                (16, 2047, 12, 1), (16, 2049, 12, 7), (24, 3521, 8, 7),
                (16, 3522, 8, 10000), (16, 5001, 6, 1),
                (32, 1920, 17, 10000))
            for case in fused_cases(q, v, deg, mr)],
        "minplus_matmul_kernel": minplus,
    }
    for name, args_list in cases.items():
        for args in args_list:
            compare(name, args)
    return {name: len(v) for name, v in cases.items()}


def time_kernel(name, args, n_bytes, n_ops, iters) -> dict:
    """Check the kernel on the main path's inputs, then time it and its
    plain version there; the bound is of the same work."""
    kernel, plain = _fns()[name]
    err = compare(name, args)
    ms, wall_ms = cuda_ms(lambda: kernel(*args), iters)
    plain_ms, _ = cuda_ms(lambda: plain(*args), max(1, iters // 10))
    b_ms, b_by = bound(n_bytes, n_ops)
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "wall_ms": wall_ms,
            "shape": [list(x.shape) for x in args if hasattr(x, "shape")]}


def label_case(idx, s, t, d_plane=None) -> dict:
    """Stage 1 of the pairs (s, t) on ``idx``: the kernel's name, its
    arguments reading the rows in place (the label planes for each side,
    then the endpoint ids; ``None`` where the tree's kernels take only
    gathered rows) and on rows gathered first, and the work: the bytes
    the in-place form needs (each row's ids up to and including its first
    pad, the bases, the distances of the hits, the endpoint ids and μ),
    the same with the full [Q, L] rows, the real entries and the hits.
    ``d_plane`` replaces the distance plane (``lbl_d``: a delta16 index
    with a float32 one; 4 bytes a distance either way)."""
    import inspect
    import torch
    from repro_torch.core.labels import decode_rows
    from repro_torch.core.sync import host_read
    eng = idx.engine
    sq, tq = (torch.as_tensor(x, dtype=torch.int32, device=idx.device)
              for x in (s, t))
    if eng.codec == "none":
        name, slot_bytes, base_bytes = "label_intersect_kernel", 4, 0
        planes = (eng.lbl_ids, eng.lbl_d if d_plane is None else d_plane)
    else:
        name, slot_bytes, base_bytes = "label_intersect_packed_kernel", 2, 4
        planes = (eng.enc_ids, eng.enc_base,
                  eng.enc_d if d_plane is None else d_plane)
    gathered = (*(p[e.long()] for e in (sq, tq) for p in planes), idx.n)
    in_place = "idx_s" in inspect.signature(_fns()[name][0]).parameters
    indexed = (*planes, *planes, idx.n, sq, tq) if in_place else None
    (ids_s, _), (ids_t, _) = (decode_rows(eng._rows(e), idx.n, eng.codec)
                              for e in (sq, tq))
    q, l = ids_s.shape
    real_rows = torch.stack([(x < idx.n).sum(1) for x in (ids_s, ids_t)])
    pos = torch.searchsorted(ids_t, ids_s).clamp(max=l - 1)
    hits = ((ids_t.gather(1, pos) == ids_s) & (ids_s < idx.n)).sum()
    real, slots, hits = (int(x) for x in host_read(
        (real_rows.sum(), (real_rows + 1).clamp(max=l).sum(), hits)))
    ends = 2 * q * (base_bytes + 4) + q * 4     # bases, endpoint ids, μ
    return {"name": name, "indexed": indexed, "gathered": gathered,
            "bytes": slots * slot_bytes + hits * 2 * 4 + ends,
            "bytes_full": 2 * q * l * (slot_bytes + 4) + ends,
            "ops": 2 * real, "real_entries": real, "hits": hits}


def launch_floor() -> dict:
    """Device and wall ms of the smallest launch, a one-element
    ``fill_``, under the same timing as the kernels (``cuda_ms``)."""
    import torch
    x = torch.zeros(1, device="cuda")
    ms, wall_ms = cuda_ms(lambda: x.fill_(1.0), 200)
    return {"ms": ms, "wall_ms": wall_ms}


def label_sweep(indexes) -> dict:
    """Stage 1 at ``repro``'s serving batches (SWEEP_QS) on the
    ``ell_loop`` index (fp32 rows, 10^6 vertices) and the ``compressed``
    one (delta16), on the first Q pairs of the main path: the kernel
    reading rows in place (where the tree's kernels can) and on gathered
    rows, each held ``torch.equal`` to the plain version; the plain
    version's ms; both byte bounds; and the whole μ-only lane
    (``query_mu_only`` on int32 endpoint ids on the card), device and
    wall ms a call. Runs on any tree of the port (``--label-sweep``)."""
    import torch
    out = {"floor": launch_floor(), "paths": {}}
    for path in ("ell_loop", "compressed"):
        idx, s, t = indexes[path]
        eng = idx.engine
        recs = []
        for q in SWEEP_QS:
            case = label_case(idx, s[:q], t[:q])
            kernel, plain = _fns()[case["name"]]
            rec = {"q": q, "real_entries": case["real_entries"],
                   "hits": case["hits"],
                   "bound_ms": bound(case["bytes"], case["ops"])[0],
                   "bound_ms_full_rows": bound(case["bytes_full"], 0)[0]}
            if case["indexed"] is not None:
                compare(case["name"], case["indexed"])
                rec["ms"], rec["wall_ms"] = cuda_ms(
                    lambda: kernel(*case["indexed"]), 200)
            compare(case["name"], case["gathered"])
            rec["gathered_ms"], rec["gathered_wall_ms"] = cuda_ms(
                lambda: kernel(*case["gathered"]), 200)
            rec["plain_ms"], _ = cuda_ms(lambda: plain(*case["gathered"]), 20)
            sq, tq = (torch.as_tensor(x, dtype=torch.int32, device=idx.device)
                      for x in (s[:q], t[:q]))
            if not torch.equal(eng.query_mu_only(sq, tq),
                               plain(*case["gathered"])):
                fail(f"{path}: query_mu_only differs from the plain "
                     f"intersect at Q = {q}")
            # 50 calls: a lane that gathers rows launches about nine
            # kernels a call, and more than the launch queue holds would
            # let the device wait on the host
            rec["lane_ms"], rec["lane_wall_ms"] = cuda_ms(
                lambda: eng.query_mu_only(sq, tq), 50)
            recs.append(rec)
        out["paths"][path] = {"kernel": case["name"], "batches": recs}
    return out


def csr_round_work(csr, changed, rows: int):
    """(bytes, operations) one spmv_relax round must move and do on these
    inputs: one read and one write of the [Vp, R] frontier, each real
    in-edge (id and weight), indptr, order and both masks once; an add
    and a min for each (edge, row) whose source is marked changed, and a
    min per frontier entry."""
    import torch
    from repro_torch.core.sync import host_read
    from repro_torch.kernels.spmv_relax.kernel import ROW_TILE
    vp = csr.order.shape[0]
    n_tiles = changed.shape[0]
    tile_rows = torch.full((n_tiles,), ROW_TILE, dtype=torch.int64,
                           device=changed.device)
    tile_rows[-1] = rows - ROW_TILE * (n_tiles - 1)
    live = changed[:, csr.src.long()].sum(1)
    pairs = int(host_read((live * tile_rows).sum()))
    n_bytes = (2 * vp * rows * 4 + csr.src.numel() * 8 + (vp + 1) * 4
               + vp * 4 + 2 * n_tiles * vp)
    return n_bytes, 2 * pairs + vp * rows


def replay_csr(idx, s, t) -> dict:
    """Replay the query's ell_loop relaxation round by round: each
    round's output, mask and flag from the kernel against the plain
    version (``torch.equal``), until the first round that improves
    nothing; the count must equal the route's ``rounds``. Times the
    first round (at the seed frontier) with its plain version, every
    round's kernel, a quiet launch (flag in 0) and the whole
    ``relax_csr_rounds`` loop on the host clock."""
    import torch
    from repro_torch.core.dispatch import relax_csr_rounds, seed_vertex_major
    from repro_torch.core.sync import host_read
    from repro_torch.kernels.spmv_relax.kernel import spmv_relax_kernel
    eng = idx.engine
    idx.query(s, t)              # the route's round count of these pairs
    csr = eng.relaxer.csr()
    seeds, rs, _ = label_seeds(idx, s, t)
    vp = csr.order.shape[0]
    bq = eng.relaxer.bq          # the route's row rounding
    rows = -(-2 * rs.ids.shape[0] // bq) * bq
    del rs

    def round_args(cur, changed, flag_in):
        return (cur, csr, changed, flag_in, torch.empty_like(cur),
                torch.empty_like(changed),
                torch.zeros(1, dtype=torch.int32, device=cur.device))

    def loop_ms():
        d0, c0 = seed_vertex_major(*seeds, vp, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r = relax_csr_rounds(d0, c0, csr, eng.max_rounds)
        host_read(r)
        return (time.perf_counter() - t0) * 1e3

    cur, changed = seed_vertex_major(*seeds, vp, rows)
    flag_in = torch.ones(1, dtype=torch.int32, device=cur.device)
    args = round_args(cur, changed, flag_in)
    n_bytes, n_ops = csr_round_work(csr, changed, rows)
    rec = time_kernel("spmv_relax_kernel", args, n_bytes, n_ops, iters=10)
    quiet = round_args(cur, changed, torch.zeros_like(flag_in))
    rec["quiet_ms"], rec["quiet_wall_ms"] = cuda_ms(
        lambda: spmv_relax_kernel(*quiet), 50)
    rounds, all_ms, all_bound, per_round = 0, 0.0, 0.0, []
    while rounds < eng.max_rounds:
        if rounds:
            args = round_args(cur, changed, flag_in)
            n_bytes, n_ops = csr_round_work(csr, changed, rows)
            compare("spmv_relax_kernel", args)
        ms, _ = cuda_ms(lambda: spmv_relax_kernel(*args), 3)
        b_ms, _ = bound(n_bytes, n_ops)
        spmv_relax_kernel(*args)
        cur, changed, flag_in = args[4], args[5], args[6]
        rounds += 1
        all_ms += ms
        all_bound += b_ms
        per_round.append(ms)
        if not host_read(flag_in)[0]:
            break
    if rounds != eng._last_rounds:
        fail(f"replay ran {rounds} rounds, the route counted "
             f"{eng._last_rounds}")
    del cur, changed, args, quiet
    rec.update(
        rounds=rounds, all_rounds_ms=all_ms, all_rounds_bound_ms=all_bound,
        per_round_ms=per_round, all_rounds_wall_ms=loop_ms(), vp=vp,
        rows=rows, edges=csr.src.numel(), n_heavy=csr.n_heavy,
        max_in_degree=int(torch.diff(csr.indptr).max()))
    return rec


def profile_query(idx, s, t) -> dict:
    """One more call of the path's query under ``torch.profiler``
    (``profile_idle``): host wall time, device busy time and idle
    share, and the kernels that took most of the busy time."""
    return profile_idle(lambda: idx.query(s, t))


def clock_under_load(fn, seconds: float = 1.0) -> dict:
    """The SM clock and power draw (``nvidia-smi``) read while ``fn``
    runs back to back on the card for about ``seconds``."""
    import threading
    import torch
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    th = threading.Thread(target=spin)
    th.start()
    try:
        time.sleep(seconds / 2)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=60)
        time.sleep(seconds / 2)
    finally:
        stop.set()
        th.join()
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    clk, watts = (float(x) for x in smi.stdout.split(","))
    return {"clock_sm_mhz": clk, "power_draw_w": watts}


def phase_kernels(indexes, clock_max_hz: float) -> list:
    """Each kernel on the inputs its route gave it in the main path;
    ``clock_max_hz`` is the card's highest SM clock."""
    import torch
    from repro_torch.kernels.minplus_matmul.kernel import \
        minplus_matmul_kernel
    from repro_torch.kernels.spmv_relax.kernel import fused_variant
    from repro_torch.kernels.spmv_relax.ops import ell_width
    from repro_torch.kernels.spmv_relax.ref import fused_relax_ref
    out = []
    # stage 1 of the compressed and the 10^6 graph's 1024-pair queries,
    # rows read in place as the engine reads them; the sweep over the
    # serving batches beside the launch floor
    sweep = label_sweep(indexes)
    for path in ("compressed", "ell_loop"):
        idx, s, t = indexes[path]
        case = label_case(idx, s, t)
        rec = time_kernel(case["name"], case["indexed"], n_bytes=case["bytes"],
                          n_ops=case["ops"], iters=200)
        at_main = sweep["paths"][path]["batches"][-1]
        rec.update(floor_ms=sweep["floor"]["ms"],
                   floor_wall_ms=sweep["floor"]["wall_ms"],
                   bound_ms_full_rows=bound(case["bytes_full"], 0)[0],
                   real_entries=case["real_entries"], hits=case["hits"],
                   gathered_ms=at_main["gathered_ms"],
                   gathered_wall_ms=at_main["gathered_wall_ms"],
                   sweep=sweep["paths"][path]["batches"])
        if path == "compressed":
            f32 = label_case(idx, s, t, d_plane=idx.engine.lbl_d)
            f32 = time_kernel(f32["name"], f32["indexed"], n_bytes=f32["bytes"],
                              n_ops=f32["ops"], iters=200)
            rec["float32_plane"] = {k: f32[k] for k in (
                "ms", "wall_ms", "plain_ms", "bound_ms", "max_abs_err")}
        out.append(rec)

    # every ell_loop round of both ell_loop paths' queries
    out.append(replay_csr(*indexes["ell_loop"]))
    out[-1]["profile"] = profile_query(*indexes["ell_loop"])
    out[-1]["compressed_path"] = replay_csr(*indexes["compressed"])
    out[-1]["compressed_path"]["profile"] = profile_query(
        *indexes["compressed"])
    for key in ("name", "route", "source", "replaces", "launches",
                "library_ms"):
        out[-1]["compressed_path"].pop(key)

    # all rounds of the fused route's query, in every variant that takes
    # its core
    idx, s, t = indexes["fused"]
    relaxer = idx.engine.relaxer
    edges = relaxer.sliced()
    d0, _, _ = frontier(idx, s, t, edges.order.shape[0])
    mr = idx.engine.max_rounds
    _, blk = fused_relax_ref(d0, edges, mr)
    rows, v = d0.shape
    nnz = int(torch.isfinite(edges.w).sum())
    all_edges_ops = int(blk.sum()) * 8 * (2 * nnz + v)
    work = dict(n_bytes=2 * rows * v * 4 + nnz * 8 + (2 * v + 1) * 4,
                n_ops=fused_work(d0, edges, blk))
    variant = fused_variant(v)
    out.append(time_kernel("fused_relax_kernel", (d0, edges, mr, variant),
                           **work, iters=20))
    out[-1]["variants"] = {variant: out[-1]["ms"]}
    for other in fused_variants(v):
        if other != variant:
            out[-1]["variants"][other] = time_kernel(
                "fused_relax_kernel", (d0, edges, mr, other), **work,
                iters=20)["ms"]
    out[-1].update(variant=variant, block_rounds_max=int(blk.max()),
                   block_rounds_sum=int(blk.sum()), edges=nnz,
                   slots=edges.src.numel(), ops=work["n_ops"],
                   bound_ms_all_edges=bound(work["n_bytes"],
                                            all_edges_ops)[0],
                   ell_width=ell_width(v, relaxer.ce_dst, relaxer.d_width),
                   profile=profile_query(idx, s, t))

    # one round of the dense route's query
    idx, s, t = indexes["dense"]
    adj = idx.engine.relaxer.dense_adj()
    d0, _, _ = frontier(idx, s, t, adj.shape[0])
    m, k = d0.shape
    out.append(time_kernel(
        "minplus_matmul_kernel", (d0, adj),
        n_bytes=(2 * m * k + k * k) * 4, n_ops=2 * m * k * k, iters=50))
    # issue bound: an FADD and an FMNMX a term, two of the four issue
    # slots an SM has a clock (FMNMX also runs 64 a clock an SM), so 64
    # terms per SM and clock, at the clock read under this kernel's load
    load = clock_under_load(lambda: minplus_matmul_kernel(d0, adj))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = load["clock_sm_mhz"] * 1e6
    issue_ms = m * k * k / (64 * sms * clock_hz) * 1e3
    out[-1].update(issue_bound_ms=issue_ms, sms=sms,
                   issue_bound_ms_at_max_clock=m * k * k / (
                       64 * sms * clock_max_hz) * 1e3,
                   clock_max_hz=clock_max_hz, under_load=load,
                   share_of_bound=out[-1]["bound_ms"] / out[-1]["ms"],
                   share_of_issue_bound=issue_ms / out[-1]["ms"],
                   profile=profile_query(idx, s, t))
    return out


def sweep_main(src: Path) -> int:
    """``--label-sweep SRC``: build the four paths' indexes with the port
    found under ``SRC`` (this tree's ``src`` or an unpacked older
    commit's), run ``label_sweep`` and print it as one line with each
    path's query times, so two trees' label kernels, μ-only lanes and
    queries can be timed in one call on one card."""
    dev = phase_device()
    emit({"phase": "build", **phase_build()})
    indexes, queries = {}, {}
    for path, route, spec, gen_call, overrides, _ in PATHS:
        rec, idx, s, t, _ = drive_route(route, spec, gen_call, overrides,
                                        "cuda")
        indexes[path] = (idx, s, t)
        queries[path] = {k: rec[k] for k in ("rounds", "query_ms",
                                             "query_ms_median",
                                             "query_ms_repeats")}
    emit({"label_sweep": label_sweep(indexes), "queries": queries,
          "src": str(src),
          "uncovered_timings": UNCOVERED[0], "power_limit": dev["smi"]})
    return 0


def main(argv) -> int:
    src = ROOT / "src"
    if argv[:1] == ["--label-sweep"] and len(argv) == 2:
        src = Path(argv[1]).resolve()
    elif argv:
        print("usage: chip_smoke.py [--label-sweep SRC]", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if argv:
        return sweep_main(src)
    from repro_torch.kernels.label_intersect import ops as li_ops
    from repro_torch.kernels.minplus_matmul import ops as mp_ops
    from repro_torch.kernels.spmv_relax import ops as sp_ops
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    dev = phase_device()
    emit({"phase": "device", "seconds": time.perf_counter() - t0, **dev})
    emit({"phase": "build", **phase_build()})
    t0 = time.perf_counter()
    emit({"phase": "ragged_checks", "cases": phase_ragged(),
          "seconds": time.perf_counter() - t0})

    tables = (li_ops.LAUNCHES, sp_ops.LAUNCHES, mp_ops.LAUNCHES)
    counters = {k: 0 for tab in tables for k in tab}
    indexes, graphs = {}, {}
    for path, route, spec, gen_call, overrides, kernels in PATHS:
        zero(tables)              # each path starts from zero
        t0 = time.perf_counter()
        rec, idx, s, t, graphs[path] = drive_route(route, spec, gen_call,
                                                   overrides, "cuda")
        launches = launches_of(tables)
        rec["launches"] = launches
        emit({"phase": f"route_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        check_launches(f"path {path}", launches, kernels)
        for k, v in launches.items():
            counters[k] += v
        indexes[path] = (idx, s, t)

    # the path lane (§8.1) on each path's index, the serving engine,
    # then §8.3 mutation
    for path, *_ in PATHS:
        t0 = time.perf_counter()
        rec = phase_paths(path, *indexes[path], graphs[path], tables)
        emit({"phase": f"paths_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    for path, route, _, _, _, kernels in PATHS:
        t0 = time.perf_counter()
        rec = phase_serving(path, route, indexes[path][0], graphs.pop(path),
                            tables, kernels)
        emit({"phase": f"serving_{path}", "seconds": time.perf_counter() - t0,
              **rec})
        for k, v in rec["launches"].items():
            counters[k] += v
    t0 = time.perf_counter()
    rec = phase_mutation(tables)
    emit({"phase": "mutation", "seconds": time.perf_counter() - t0, **rec})
    for k, v in rec["launches"].items():
        counters[k] += v

    t0 = time.perf_counter()
    emit({"phase": "builders", **phase_builders(indexes["ell_loop"][0]),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    kernels = phase_kernels(indexes, dev["clock_max_mhz"] * 1e6)
    for rec in kernels:
        rec["launches"] = counters[rec["name"]]
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "uncovered_timings": UNCOVERED[0], "power_limit": dev["smi"]})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    for line in dev["smi"]:
        print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
