"""Serving launcher of the port, the counterpart of ``repro.launch.serve``
in its two index modes:

* ``--mode distance``: build (or ``--load``) an IS-LABEL index on
  ``--device`` (the card by default), register it, replay a scenario
  trace from the load generator through the micro-batching / routing /
  caching engine (``repro_torch.serve``), audit every served answer,
  and print the metrics snapshot as JSON.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode distance \\
      --scenario hotspot --n 4096 --queries 4096 --buckets 64,256,1024

  ``--audit index`` (default) checks bitwise equality of every served
  answer against a direct ``ISLabelIndex.query`` pass; ``--audit
  dijkstra`` also checks a sample against the host Dijkstra oracle
  (``core/ref.py``). The process exits nonzero on any mismatch, on
  zero QPS, or on a first-use build counted on the serving path after
  warmup (``obs.profiler``).

* ``--mode path``: the same replay served through the path lane
  (``--hop-caps`` tiers). Every served path is validated edge by edge
  against the original graph — correct endpoints, real edges, weight
  sum equal to the served distance — and the distances are audited as
  in ``--mode distance``.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode path \\
      --graph er --n 512 --queries 512 --audit dijkstra

``--device cpu`` runs the index on the CPU (the kernels' plain
versions). The LM, mutation and HTTP modes, and sharded indexes, are
not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


class _ObsSession:
    """Observability wiring shared by the serving modes: request tracing
    (``--trace-out``), the first-use build watcher (always on — it is
    the exported form of the no-build-after-warmup guarantee), a
    JSON-lines event log (``--events-out``) and the registry dump
    (``--metrics-out``). Construct *before* the server so warmup builds
    are attributed to the warmup region."""

    def __init__(self, args, mode: str):
        from repro_torch.obs import BuildWatcher, EventLog, NULL_TRACER, Tracer
        self.args = args
        self.mode = mode
        self.tracer = (Tracer(f"repro_torch.serve[{mode}]") if args.trace_out
                       else NULL_TRACER)
        self.watcher = BuildWatcher().start()
        self.log = EventLog(args.events_out or None)
        self.log.log("start", mode=mode, graph=args.graph, n=args.n,
                     queries=args.queries, scenario=args.scenario,
                     device=args.device)

    def profiled(self):
        """``torch.profiler`` session over the replay (``--profile-dir``);
        no-op without the flag."""
        from repro_torch.obs import profiler_session
        return profiler_session(self.args.profile_dir or None)

    def finish(self, server) -> int:
        """Write every requested sink; returns audit failures (a
        first-use build counted in ``serve_read`` or ``serve_path``, or
        trace coverage below 99%)."""
        from repro_torch.obs import (device_memory_gauges, write_chrome_trace,
                                     write_metrics)
        args = self.args
        failures = 0
        self.watcher.stop()
        device_memory_gauges()
        print(f"  first-use builds by region: {self.watcher.snapshot()}")
        served = {r: self.watcher.count(r) for r in ("serve_read",
                                                     "serve_path")}
        if any(served.values()):
            print(f"  AUDIT FAIL: first-use builds on the serving path "
                  f"after warmup: {served}")
            failures += 1
        else:
            print("  audit[first-use builds]: 0 in regions serve_read and "
                  "serve_path across the replay")
        if self.tracer.enabled:
            cov = self.tracer.request_coverage()
            print(f"  trace: {len(self.tracer.finished())} spans; request "
                  f"coverage min={cov['min']:.4f} mean={cov['mean']:.4f} "
                  f"over {cov['requests']} request(s)")
            p = write_chrome_trace(args.trace_out, self.tracer)
            print(f"  trace written to {p} (chrome://tracing / "
                  f"ui.perfetto.dev)")
            if cov["requests"] and cov["min"] < 0.99:
                print("  AUDIT FAIL: request spans cover <99% of measured "
                      "request time")
                failures += 1
            self.log.log("trace_written", path=str(p), **cov)
        if args.metrics_out:
            p = write_metrics(args.metrics_out, mode=self.mode,
                              server=server.name)
            print(f"  metrics registry written to {p}")
        self.log.log("finish", mode=self.mode, failures=failures)
        self.log.close()
        return failures


def _build_graph(args):
    from repro_torch.graphs import generators as gen
    if args.graph == "rmat":
        return gen.rmat_graph(int(np.log2(args.n)), avg_deg=6.0, seed=1)
    if args.graph == "er":
        return gen.er_graph(args.n, avg_deg=2.2, seed=1)
    return gen.grid_graph(int(np.sqrt(args.n)), seed=1)


def _audit_paths(src, dst, w, trace, served, path_list, valid) -> int:
    """Validate every served path through the shared exactness gate
    (``repro_torch.paths.validate``); returns the failure count (0 =
    ok)."""
    from repro_torch.paths import (check_vertex_path, edge_weight_map,
                                   integral_weights)
    failures = 0
    if not valid.all():
        print(f"  AUDIT FAIL: {int((~valid).sum())} served paths invalid "
              f"(hop_cap overflow unresolved)")
        failures += 1
    if src is None:
        print("  audit[paths]: edge validation SKIPPED — no edge list "
              "with --load (distance audits below still run)")
        return failures
    edges = edge_weight_map(src, dst, w)
    exact = integral_weights(edges)
    violations = []
    for i, p in enumerate(path_list):
        violations += check_vertex_path(edges, int(trace.s[i]),
                                        int(trace.t[i]), float(served[i]),
                                        p, exact=exact)
    if violations:
        print(f"  AUDIT FAIL: {len(violations)} path violations, e.g. "
              f"{violations[:3]}")
        failures += 1
    else:
        print(f"  audit[paths]: {len(path_list)}/{len(path_list)} served "
              f"paths valid (edges, endpoints, weight sum == distance)")
    return failures


def serve_distance(args, paths: bool = False) -> int:
    from repro_torch.core import ISLabelIndex, IndexConfig, ref
    from repro_torch.core.sync import host_read
    from repro_torch.serve import IndexRegistry, make_trace

    obs = _ObsSession(args, "path" if paths else "distance")
    if args.load:
        idx = ISLabelIndex.load(args.load, device=args.device)
        n = idx.n
        src = dst = w = None
        print(f"[serve-distance] loaded index: {idx.stats.summary()}")
    else:
        n, src, dst, w = _build_graph(args)
        print(f"[serve-distance] graph {args.graph} n={n} m={len(src)}")
        t0 = time.time()
        idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(l_cap=args.l_cap),
                                 device=args.device)
        print(f"  index built on {idx.device} in {time.time() - t0:.1f}s: "
              f"{idx.stats.summary()}")
        if args.save:
            idx.save(args.save)

    registry = IndexRegistry()
    server = registry.register(
        args.index_name, idx,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_wait_ms=args.max_wait_ms, cache_size=args.cache,
        backend=args.backend or None,
        path_hop_caps=(tuple(int(h) for h in args.hop_caps.split(","))
                       if paths else None),
        tracer=obs.tracer)
    print(f"  warmed {server.compile_cache_sizes()} shapes "
          f"in {server.warmup_seconds:.1f}s")

    trace = make_trace(args.scenario, n=n, num_requests=args.queries,
                       rate_qps=args.rate, seed=args.seed)
    failures = 0
    with obs.profiled():
        if paths:
            served, path_list, valid = server.serve_path_trace(trace)
        else:
            served = server.serve_trace(trace)
    if paths:
        failures += _audit_paths(src, dst, w, trace, served, path_list,
                                 valid)
    stats = server.stats()
    print(json.dumps(stats, indent=2, sort_keys=True))

    if args.audit in ("index", "dijkstra"):
        want = host_read(idx.query(trace.s, trace.t))
        bad = int((~((served == want)
                     | (np.isnan(served) & np.isnan(want)))).sum())
        if bad:
            print(f"  AUDIT FAIL: {bad} served answers differ from "
                  f"ISLabelIndex.query")
            failures += 1
        else:
            print(f"  audit[index]: {len(trace)}/{len(trace)} served answers "
                  f"bitwise-equal to ISLabelIndex.query")
    if args.audit == "dijkstra" and src is None:
        print("  audit[dijkstra]: SKIPPED — no edge list with --load "
              "(index-equality audit above still ran)")
    if args.audit == "dijkstra" and src is not None:
        k = min(len(trace), args.audit_sample)
        srcs, inv = np.unique(trace.s[:k], return_inverse=True)
        oracle = ref.dijkstra_oracle(n, src, dst, w, srcs)
        want = oracle[inv, trace.t[:k]].astype(np.float32)
        ok = np.isfinite(want)
        if not (np.allclose(served[:k][ok], want[ok])
                and np.all(~np.isfinite(served[:k][~ok]))):
            print("  AUDIT FAIL: served answers differ from Dijkstra oracle")
            failures += 1
        else:
            print(f"  audit[dijkstra]: {k} answers match the oracle")
    if stats["qps_compute"] <= 0:
        print("  AUDIT FAIL: zero QPS")
        failures += 1
    failures += obs.finish(server)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["distance", "path"],
                    default="distance")
    ap.add_argument("--device", default="cuda",
                    help="where the index lives: cuda (the kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--graph", choices=["rmat", "er", "grid"], default="rmat")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--l-cap", type=int, default=512)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--scenario", default="uniform",
                    help="uniform | hotspot | bursty | repeated")
    ap.add_argument("--rate", type=float, default=50000.0,
                    help="offered load, requests/s on the trace clock")
    ap.add_argument("--buckets", default="64,256,1024")
    ap.add_argument("--hop-caps", default="64,256",
                    help="path-lane hop_cap tiers (--mode path): escalate "
                         "through these pre-warmed shapes on overflow")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache", type=int, default=65536)
    ap.add_argument("--backend", default="",
                    help="kernel backend override: cuda | reference (auto "
                         "if empty)")
    ap.add_argument("--audit", choices=["index", "dijkstra", "none"],
                    default="index")
    ap.add_argument("--audit-sample", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--index-name", default="default")
    ap.add_argument("--save", default="")
    ap.add_argument("--load", default="")
    # -- observability sinks ---------------------------------------------
    ap.add_argument("--trace-out", default="",
                    help="write request-lifecycle spans as Chrome "
                         "trace-event JSON (open in Perfetto)")
    ap.add_argument("--metrics-out", default="",
                    help="dump the process metric registry (every "
                         "labeled series) as JSON after the replay")
    ap.add_argument("--events-out", default="",
                    help="append JSON-lines structured events here")
    ap.add_argument("--profile-dir", default="",
                    help="wrap the replay in torch.profiler, writing a "
                         "Chrome trace into this directory")
    args = ap.parse_args(argv)
    raise SystemExit(serve_distance(args, paths=args.mode == "path"))


if __name__ == "__main__":
    main()
