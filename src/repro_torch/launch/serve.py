"""Serving launcher of the port, the counterpart of ``repro.launch.serve``
in its five modes:

* ``--mode lm``: prefill + greedy decode loop for an LM's smoke config
  (``repro``'s ``serve_lm``): ``--batch`` random prompts of 16 tokens,
  ``--gen-len`` tokens each by argmax, one tokens/s line. ``--arch`` is
  any of the five LM ids. The run exits nonzero on a non-finite logit.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
      --arch qwen2-moe-a2.7b --batch 256 --gen-len 32

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

  ``--shards N`` serves a ``repro_torch.shard.ShardedIndex`` instead:
  the label table is cut into N blocks, all on ``--device`` (one card
  hosts every shard), and every batch runs the per-shard stages and
  one cross-shard reduction. The audit then checks the sharded serving
  path against the *unsharded* index, end to end.

* ``--mode path``: the same replay served through the path lane
  (``--hop-caps`` tiers). Every served path is validated edge by edge
  against the original graph — correct endpoints, real edges, weight
  sum equal to the served distance — and the distances are audited as
  in ``--mode distance``.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode path \\
      --graph er --n 512 --queries 512 --audit dijkstra

* ``--mode mutate``: live §8.3 mutation under traffic: a *versioned*
  server replays a ``readwrite`` trace — reads micro-batch as usual,
  write rows apply insert/delete batches copy-on-write and hot-swap the
  published index version between micro-batches. The run fails if the
  shape counts grew across the replay, if a first-use build is counted
  in ``serve_read``, or on zero QPS. ``--audit rebuild`` replays the
  mutation log against from-scratch builds of the port on the same
  device and demands every served read be bitwise-equal to the rebuilt
  index's answer for the exact version that served it.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode mutate \\
      --graph er --n 256 --queries 512 --write-ratio 0.06 \\
      --spares 12 --audit rebuild

* ``--mode http``: the same workloads served over the wire through
  the asyncio front end (``repro_torch.serve.frontend``) and audited on
  the answers that crossed the network. ``--replicas N`` puts a
  ``ReplicaSet`` behind it; ``--scenario straggler`` charges a
  synthetic stall to one replica's batches and the run asserts the
  latency SLO burn-rate alert *fired* (and the replica was evicted),
  while every clean scenario asserts the alerts stayed *quiet*;
  ``--scenario readwrite`` serves a versioned index and audits every
  read against the in-process versioned replay. ``--sse-out`` captures
  the live ``/events`` stream and ``--prom-out`` the final ``/metrics``
  exposition.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode http \\
      --graph er --n 10000 --l-cap 64 --replicas 2 \\
      --scenario straggler --audit index

``--device cpu`` runs the index (or the LM) on the CPU (the kernels'
plain versions).
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
        from repro_torch.obs import (device_memory_gauges,
                                     version_family_gauges,
                                     write_chrome_trace, write_metrics)
        args = self.args
        failures = 0
        self.watcher.stop()
        device_memory_gauges()
        if server.versions is not None:
            print(f"  version family: "
                  f"{version_family_gauges(server.versions, server=server.name)}")
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


def lm_generate(spec, batch: int, gen_len: int, device, prompt_len: int = 16,
                seed: int = 0) -> dict:
    """``repro``'s ``serve_lm`` loop on ``spec``'s config: parameters from
    ``init_lm(cfg, seed)`` in ``spec.param_dtype``, ``batch`` prompts of
    ``prompt_len`` tokens from ``np.random.default_rng(seed)``, a prefill
    into a cache of ``prompt_len + gen_len``, then greedy decode steps.
    The tokens are read to the host once, at the end. Returns the
    ``params``, the ``prompt``, the greedy ``tokens`` [batch, gen_len],
    whether every logit was ``finite``, and the wall ``seconds``."""
    import torch

    from repro_torch.core.sync import host_read, upload
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    cfg = spec.model_cfg
    params = init_lm(cfg, seed, device, getattr(torch, spec.param_dtype))
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, cfg, upload(prompt, device),
                                prompt_len + gen_len)
        finite = torch.isfinite(logits).all()
        out = [torch.argmax(logits[:, -1:], -1).to(torch.int32)]
        for _ in range(gen_len - 1):
            logits, cache = decode_step(params, cfg, cache, out[-1])
            finite = finite & torch.isfinite(logits).all()
            out.append(torch.argmax(logits, -1).to(torch.int32))
    tokens, finite = host_read((torch.cat(out, 1), finite))
    return {"params": params, "prompt": prompt, "tokens": tokens,
            "finite": bool(finite), "seconds": time.perf_counter() - t0}


def serve_lm(args) -> int:
    from repro_torch.configs import registry
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.train import smoke_spec
    device = resolve_device(args.device)
    spec = smoke_spec(registry.get_spec(args.arch))
    res = lm_generate(spec, args.batch, args.gen_len, device, seed=args.seed)
    total = args.batch * args.gen_len
    dt = res["seconds"]
    print(f"[serve-lm {spec.arch_id}] {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. first calls) on {device}")
    if not res["finite"]:
        print("  FAIL: non-finite logits")
        return 1
    return 0


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

    serve_idx = idx
    if args.shards:
        from repro_torch.shard import ShardedIndex
        serve_idx = ShardedIndex.from_index(idx, args.shards,
                                            strategy=args.shard_strategy)
        print(f"[serve-distance] {args.shards} shard(s) on "
              f"{serve_idx.device}, strategy={args.shard_strategy}, "
              f"entries/shard={serve_idx.shard_entry_counts().tolist()}, "
              f"partitioned in {serve_idx.partition_seconds:.2f}s")

    registry = IndexRegistry()
    server = registry.register(
        args.index_name, serve_idx,
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


def _audit_rebuild(args, n, src, dst, w, trace, served, vids) -> int:
    """Differential rebuild audit for ``--mode mutate``: walk the trace
    in order, mirror every write batch into an edge-list model of the
    evolving graph, and for each version segment that served reads,
    rebuild an index from scratch (the port, on ``--device``) on the
    mirrored graph and demand bitwise equality with the served
    answers."""
    from repro_torch.core import ISLabelIndex, IndexConfig
    from repro_torch.core.sync import host_read
    cur_src = [int(a) for a in src]
    cur_dst = [int(b) for b in dst]
    cur_w = [float(x) for x in w]
    bad = rebuilds = audited = 0
    seg: list[int] = []

    def flush(seg):
        nonlocal bad, rebuilds, audited
        if not seg:
            return
        rebuilds += 1
        ref_idx = ISLabelIndex.build(
            n, np.asarray(cur_src, np.int32), np.asarray(cur_dst, np.int32),
            np.asarray(cur_w, np.float32),
            IndexConfig(l_cap=args.l_cap, label_chunk=args.label_chunk),
            device=args.device)
        s = trace.s[seg]
        t = trace.t[seg]
        want = host_read(ref_idx.engine.query(
            s, t, backend=args.backend or None))
        got = served[seg]
        bad += int((~((got == want)
                      | (np.isinf(got) & np.isinf(want)))).sum())
        audited += len(seg)

    for i in range(len(trace)):
        if trace.writes[i] is None:
            seg.append(i)
            continue
        flush(seg)
        seg = []
        for op in trace.writes[i]:
            u = int(op.u)
            if op.kind == "insert":
                for v, wv in zip(op.nbrs, op.ws):
                    cur_src += [u, int(v)]
                    cur_dst += [int(v), u]
                    cur_w += [float(wv), float(wv)]
            else:
                keep = [j for j in range(len(cur_src))
                        if cur_src[j] != u and cur_dst[j] != u]
                cur_src = [cur_src[j] for j in keep]
                cur_dst = [cur_dst[j] for j in keep]
                cur_w = [cur_w[j] for j in keep]
    flush(seg)
    if bad:
        print(f"  AUDIT FAIL: {bad}/{audited} served reads differ from "
              f"the from-scratch rebuild of their version")
        return 1
    print(f"  audit[rebuild]: {audited} served reads bitwise-equal to "
          f"{rebuilds} from-scratch rebuilds across "
          f"{int(vids.max()) + 1} versions")
    return 0


def serve_mutate(args) -> int:
    from repro_torch.core import ISLabelIndex, IndexConfig
    from repro_torch.serve import IndexRegistry, make_trace

    obs = _ObsSession(args, "mutate")
    n_base, src, dst, w = _build_graph(args)
    n = n_base + args.spares
    print(f"[serve-mutate] graph {args.graph} n={n_base} "
          f"(+{args.spares} spares) m={len(src)}")
    t0 = time.time()
    idx = ISLabelIndex.build(
        n, src, dst, w,
        IndexConfig(l_cap=args.l_cap, label_chunk=args.label_chunk),
        device=args.device)
    print(f"  index built on {idx.device} in {time.time() - t0:.1f}s: "
          f"{idx.stats.summary()}")

    registry = IndexRegistry()
    server = registry.register(
        args.index_name, idx,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_wait_ms=args.max_wait_ms, cache_size=args.cache,
        backend=args.backend or None, versioned=True,
        tracer=obs.tracer)
    print(f"  warmed {server.compile_cache_sizes()} shapes "
          f"in {server.warmup_seconds:.1f}s; route "
          f"{server.versions.family.relax_mode}")

    trace = make_trace("readwrite", n=n, num_requests=args.queries,
                       rate_qps=args.rate, seed=args.seed,
                       write_ratio=args.write_ratio, n_read=n_base,
                       spares=range(n_base, n), attach_to=idx.core_ids)
    print(f"  trace: {trace.meta}")
    shapes_before = server.compile_cache_sizes()
    with obs.profiled():
        served, vids = server.serve_readwrite_trace(trace)
    shapes_after = server.compile_cache_sizes()
    stats = server.stats()
    print(json.dumps(stats, indent=2, sort_keys=True))

    failures = 0
    if shapes_after != shapes_before:
        print(f"  AUDIT FAIL: batch shapes grew under writes: "
              f"{shapes_before} -> {shapes_after}")
        failures += 1
    else:
        print(f"  audit[shapes]: no new batch shape across "
              f"{stats['mutations']} version swaps")
    if args.audit == "rebuild":
        failures += _audit_rebuild(args, n, src, dst, w, trace, served,
                                   vids)
    if stats["qps_compute"] <= 0:
        print("  AUDIT FAIL: zero QPS")
        failures += 1
    # the build watcher is the exported twin of the shape audit: no
    # first-use build may be counted in serve_read
    failures += obs.finish(server)
    return failures


def serve_http(args) -> int:
    """Serve over the asyncio HTTP front end and audit the answers that
    crossed the wire."""
    import threading
    from pathlib import Path

    from repro_torch.core import ISLabelIndex, IndexConfig
    from repro_torch.core.sync import host_read
    from repro_torch.obs import (SLOEngine, compiles_source,
                                 default_serving_slos, latency_source)
    from repro_torch.serve import (DistanceServer, HttpClient, IndexRegistry,
                                   ReplicaSet, SSEReader, ServiceFrontend,
                                   make_trace, replay_http)

    obs = _ObsSession(args, "http")
    readwrite = args.scenario == "readwrite"
    straggler = args.scenario == "straggler"
    replicas = args.replicas
    if straggler and replicas < 2:
        replicas = 2
        print("[serve-http] straggler scenario: forcing --replicas 2")
    n_base, src, dst, w = _build_graph(args)
    n = n_base + (args.spares if readwrite else 0)
    print(f"[serve-http] graph {args.graph} n={n_base}"
          + (f" (+{args.spares} spares)" if readwrite else "")
          + f" m={len(src)}")
    t0 = time.time()
    idx = ISLabelIndex.build(
        n, src, dst, w,
        IndexConfig(l_cap=args.l_cap, label_chunk=args.label_chunk),
        device=args.device)
    print(f"  index built on {idx.device} in {time.time() - t0:.1f}s: "
          f"{idx.stats.summary()}")

    # every server warms up here, on this thread, before the front end's
    # loop thread takes over all index work
    registry = IndexRegistry()
    common = dict(buckets=tuple(int(b) for b in args.buckets.split(",")),
                  max_wait_ms=args.max_wait_ms, cache_size=args.cache,
                  backend=args.backend or None)
    if readwrite:
        holder = registry.register(args.index_name, idx, versioned=True,
                                   tracer=obs.tracer, **common)
        server_names = [args.index_name]
    elif replicas > 1:
        holder = ReplicaSet(idx, replicas, name=args.index_name, **common)
        registry.install(args.index_name, holder)
        server_names = holder.server_names
    else:
        holder = registry.register(args.index_name, idx,
                                   tracer=obs.tracer, **common)
        server_names = [args.index_name]
    print(f"  serving {args.index_name!r}"
          + (f" over {replicas} replicas" if replicas > 1 else ""))

    slo_thresh_s = args.slo_latency_ms * 1e-3
    slo = SLOEngine(default_serving_slos(latency_threshold_s=slo_thresh_s),
                    log=obs.log)
    slo.attach("latency", latency_source(slo_thresh_s, servers=server_names))
    slo.attach("read_compiles", compiles_source(obs.watcher))

    fe = ServiceFrontend(registry, slo=slo, log=obs.log)
    host, port = fe.start_background()
    print(f"  front end listening on http://{host}:{port}")

    # live /events capture
    sse_records: list = []
    sse_stop = threading.Event()

    def _pump_sse():
        reader = SSEReader(host, port, timeout_s=1.0)
        while not sse_stop.is_set():
            sse_records.extend(reader.read_events(max_events=256,
                                                  max_s=0.5))
        reader.close()

    sse_thread = None
    if args.sse_out:
        sse_thread = threading.Thread(target=_pump_sse, daemon=True)
        sse_thread.start()

    if readwrite:
        trace = make_trace("readwrite", n=n, num_requests=args.queries,
                           rate_qps=args.rate, seed=args.seed,
                           write_ratio=args.write_ratio, n_read=n_base,
                           spares=range(n_base, n),
                           attach_to=idx.core_ids)
    elif straggler:
        trace = make_trace("straggler", n=n, num_requests=args.queries,
                           rate_qps=args.rate, seed=args.seed,
                           stall_replica=args.stall_replica,
                           stall_s=args.stall_s)
        holder.apply_injection(trace.meta)
        print(f"  injected: replica {args.stall_replica} stalls "
              f"{args.stall_s}s per batch (accounting-only)")
    else:
        trace = make_trace(args.scenario, n=n, num_requests=args.queries,
                           rate_qps=args.rate, seed=args.seed)

    client = HttpClient(host, port, graph=args.index_name)
    t0 = time.time()
    with obs.profiled():
        if readwrite:
            served, vids = replay_http(client, trace)
        else:
            served = replay_http(client, trace, batch=args.http_batch)
    wire_s = time.time() - t0
    print(f"  replayed {len(trace)} requests over HTTP in {wire_s:.2f}s "
          f"({len(trace) / wire_s:.0f} req/s on the wire)")

    failures = 0
    if readwrite:
        # the COW lane never mutates the original index, so a second
        # versioned server over the same idx replays the identical
        # version sequence in-process for the differential audit (on
        # this thread, once the wire replay has finished)
        ref_srv = DistanceServer(idx, versioned=True, **common)
        want, want_vids = ref_srv.serve_readwrite_trace(trace)
        ref_srv.drain()
        reads = ~np.isnan(want)
        n_bad = int((served[reads] != want[reads]).sum())
        n_bad += int((vids[reads] != want_vids[reads]).sum())
        if n_bad:
            print(f"  AUDIT FAIL: {n_bad} HTTP-served reads differ from "
                  f"the in-process versioned replay (answers or versions)")
            failures += 1
        else:
            print(f"  audit[http-readwrite]: {int(reads.sum())} reads over "
                  f"{int(vids.max()) + 1} versions bitwise-equal to the "
                  f"in-process replay")
        slo.record("exactness", fe._now(), good=int(reads.sum()) - n_bad,
                   bad=n_bad)
    else:
        want = host_read(idx.query(trace.s, trace.t))
        n_bad = int((~((served == want)
                       | (np.isnan(served) & np.isnan(want)))).sum())
        if n_bad:
            print(f"  AUDIT FAIL: {n_bad} HTTP-served answers differ from "
                  f"ISLabelIndex.query")
            failures += 1
        else:
            print(f"  audit[http-index]: {len(trace)}/{len(trace)} answers "
                  f"that crossed the wire bitwise-equal to "
                  f"ISLabelIndex.query")
        slo.record("exactness", fe._now(), good=len(trace) - n_bad,
                   bad=n_bad)

    time.sleep(4 * fe.slo_interval_s)      # let the pump task step the SLO
    breaches = slo.breach_summary()
    fired = set(breaches["fired"])
    print(f"  slo: fired={sorted(fired)} "
          f"burns={json.dumps(breaches['slos'], sort_keys=True)}")
    if straggler:
        if "latency" not in fired:
            print("  AUDIT FAIL: straggler injection did not fire the "
                  "latency burn-rate alert")
            failures += 1
        else:
            print("  audit[slo-fire]: latency burn-rate alert fired under "
                  "straggler injection")
        evicted = [name for name, r in holder.stats()["replicas"].items()
                   if not r["healthy"]]
        print(f"  evicted replicas: {evicted}")
    else:
        noisy = fired & {"latency", "availability", "exactness",
                         "read_compiles"}
        if noisy:
            print(f"  AUDIT FAIL: alerts fired on a clean run: "
                  f"{sorted(noisy)}")
            failures += 1
        else:
            print("  audit[slo-quiet]: no alert fired on the clean run")

    stats = client.stats()
    g = stats["graphs"][args.index_name]
    print(f"  served={g['served']} p50={g['latency_ms']['p50']:.3f}ms "
          f"p99={g['latency_ms']['p99']:.3f}ms cache_hits={g['cache_hits']}")
    if args.prom_out:
        text = client.metrics_text()
        p = Path(args.prom_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
        print(f"  prometheus exposition ({len(text.splitlines())} lines) "
              f"written to {p}")
    client.close()
    if sse_thread is not None:
        sse_stop.set()
        sse_thread.join(timeout=10)
        p = Path(args.sse_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w", encoding="utf-8") as fh:
            for event, data in sse_records:
                fh.write(json.dumps({"event": event, "data": data}) + "\n")
        n_alerts = sum(1 for e, _ in sse_records if e == "slo_alert")
        print(f"  sse stream ({len(sse_records)} frames, {n_alerts} "
              f"alert(s)) written to {p}")
        if straggler and not n_alerts:
            print("  AUDIT FAIL: no slo_alert frame crossed the /events "
                  "stream")
            failures += 1
    fe.stop()
    n_reads = (len(trace) if trace.writes is None
               else sum(1 for ops in trace.writes if ops is None))
    if g["served"] < n_reads:
        print(f"  AUDIT FAIL: front end served {g['served']} < "
              f"{n_reads} offered reads")
        failures += 1
    failures += obs.finish(holder)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "distance", "path", "mutate",
                                       "http"],
                    default="distance")
    ap.add_argument("--device", default="cuda",
                    help="where the index (or the LM) lives: cuda (the "
                         "kernels) or cpu (their plain versions)")
    # -- LM serving (--mode lm) -------------------------------------------
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--gen-len", type=int, default=32)
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
    ap.add_argument("--audit", choices=["index", "dijkstra", "rebuild",
                                        "none"],
                    default="index",
                    help="rebuild (--mode mutate): per-version "
                         "from-scratch rebuild differential audit")
    ap.add_argument("--write-ratio", type=float, default=0.05,
                    help="--mode mutate: fraction of requests that are "
                         "§8.3 write batches")
    ap.add_argument("--spares", type=int, default=16,
                    help="--mode mutate: preallocated vertex ids for "
                         "live inserts")
    ap.add_argument("--label-chunk", type=int, default=128,
                    help="--mode mutate and http: IndexConfig.label_chunk "
                         "for the served index and the rebuild-audit "
                         "indexes")
    ap.add_argument("--audit-sample", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0,
                    help=">0: serve a repro_torch.shard.ShardedIndex of "
                         "this many shards, all on --device")
    ap.add_argument("--shard-strategy", choices=["level", "hash"],
                    default="level")
    ap.add_argument("--index-name", default="default")
    # -- http front end (--mode http) -----------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="--mode http: DistanceServer replicas behind the "
                         "front end (straggler health needs >= 2)")
    ap.add_argument("--slo-latency-ms", type=float, default=1000.0,
                    help="--mode http: latency SLO good-event threshold")
    ap.add_argument("--stall-s", type=float, default=5.0,
                    help="--scenario straggler: synthetic per-batch stall "
                         "charged to the injected replica")
    ap.add_argument("--stall-replica", type=int, default=0)
    ap.add_argument("--http-batch", type=int, default=16,
                    help="--mode http: pairs per /query request for "
                         "read-only replays (readwrite is always "
                         "sequential single-pair)")
    ap.add_argument("--sse-out", default="",
                    help="--mode http: capture the /events SSE stream "
                         "as JSON lines")
    ap.add_argument("--prom-out", default="",
                    help="--mode http: write the final /metrics "
                         "Prometheus exposition here")
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
    if args.mode == "lm":
        raise SystemExit(serve_lm(args))
    if args.mode == "mutate":
        raise SystemExit(serve_mutate(args))
    if args.mode == "http":
        raise SystemExit(serve_http(args))
    raise SystemExit(serve_distance(args, paths=args.mode == "path"))


if __name__ == "__main__":
    main()
