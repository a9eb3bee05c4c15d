"""`DistanceServer` — the serving engine over one `ISLabelIndex`, the
counterpart of ``repro.serve.engine``.

Pipeline (request → answer):

  submit ──► LRU cache probe ──hit──► answer (zero latency)
     │ miss
     ▼
  routing: μ-exact pairs → "mu" lane, everything else → "full" lane
     ▼
  per-lane MicroBatcher (shape buckets + max-wait deadline)
     ▼
  pump: drained batches padded to their bucket, uploaded as int32 to
  the index's device and run through the pre-warmed entry points
  (QueryEngine.batch_fn / mu_batch_fn)
     ▼
  answers + metrics (+ cache fill)

Routing soundness. The full answer is ``min(μ, min_v DS[v] + DT[v])``
(Algorithm 1). A pair goes to the Equation-1-only lane only when the
core term is *provably* +inf: at least one endpoint's label contains no
finite-distance core vertex, so its stage-2 seeds are all +inf and the
core search cannot contribute. ``classify`` (§5.2) alone cannot certify
this, so it feeds the served type-mix metric while the label mask
(``mu_exact_mask``) decides the lane. Every served answer therefore
equals ``ISLabelIndex.query`` bitwise, whichever lane it took.

Sharded lane. The server accepts a ``repro_torch.shard.ShardedIndex``
wherever it accepts an ``ISLabelIndex``: the same pre-warmed per-bucket
entry points then run the sharded query (per-shard stages, one
cross-shard reduction a batch), and every guarantee above — bitwise
equality with the unsharded index, μ-routing soundness, no first-use
build after warmup — holds unchanged. A registry can host sharded and
unsharded graphs side by side.

On the card each lane runs the ported kernels: the ``mu`` lane the
index's label kernel (``label_intersect_kernel``, or the packed kernel
on a delta16 index), the ``full`` lane the label kernel and the route's
stage-2 kernel, the ``path`` lane the route's stage-2 kernel. A server
over an index built with ``device="cpu"`` runs their plain versions;
nothing here moves work to the CPU or catches a kernel's error.

Host syncs. A distance batch ends in one ``host_read`` of its answers
and round count, inside the timed window; the only other syncs are the
relaxation loop's own exit-flag reads (none on the ``fused`` route and
on the ``mu`` lane). A path batch reads its ``PathBatch`` once a
hop_cap tier and decides the escalation from that read. The routing
mask comes to the host once, at construction and at ``refresh`` (in
versioned mode, once per version, inside ``apply``).

Path lane. Constructing with ``path_hop_caps=(h1, h2, ...)`` opens a
third lane serving shortest *paths*: ``submit_path``/``serve_path_trace``
micro-batch into the same buckets, run the pre-warmed ``PathEngine``
entry points, and escalate through the hop_cap tiers when a path
overflows — falling back to the host oracle (``index.shortest_path``)
for a path longer than every tier. Path answers have their own cache.

First-use builds. ``warmup`` runs every (lane, bucket) entry point
inside ``compile_region("warmup")``, which builds the kernel library,
the route's layout and the chase planes; after it no first-use build
is counted in ``serve_read`` or ``serve_path`` (``obs.profiler``).
``compile_cache_sizes`` counts the distinct batch shapes each lane's
entry point has run, the counterpart of ``repro``'s jit cache sizes.

Mutation lane (versioned mode). Constructing with ``versioned=True``
routes the entry points through a ``VersionFamily``
(``serve/versions.py``): they take the index state as an argument
instead of closing over it, so ``submit_mutation`` applies a §8.3
insert/delete batch copy-on-write, hot-swaps the published version
between micro-batches, and the pre-warmed entry points survive — no
first-use build and no new batch shape under concurrent read/write
traffic (the new version's route layout is built inside
``compile_region("mutation")``). Pending read batches are
force-flushed before the swap (they complete on the version current
when they were submitted), the LRU cache and routing mask are
per-version (cleared/replaced on swap), and old versions are
refcount-drained before release. Versioned mode serves distances of an
unsharded index only: with ``path_hop_caps`` or a sharded index it
raises ``ValueError`` (mutate a sharded index through
``ShardedIndex.apply_mutations`` and re-register it).

The engine is clock-driven and deterministic: callers pass ``now``
(simulated or wall time) to ``submit``/``pump``. ``serve_trace`` replays
a loadgen trace on its own clock — queue waits come from the trace
timeline, execution times from the device.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sync import host_read, upload
from repro_torch.obs.profiler import compile_region
from repro_torch.obs.registry import REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.batcher import MicroBatcher, PendingRequest
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.metrics import ServeMetrics

LANES = ("mu", "full")
PATH_LANE = "path"


class PathAnswer(NamedTuple):
    """One served path request: exact distance, vertex list (empty when
    unreachable), and whether the path itself is trustworthy (False
    only if every hop_cap tier and the host fallback failed)."""
    dist: float
    path: tuple
    valid: bool


def mu_exact_mask(index) -> np.ndarray:
    """bool[n+1]: vertex v's label has no finite-distance core entry.

    For such v, stage 2's seeds are all +inf, so for any pair with
    ``mask[s] or mask[t]`` the core term is +inf and μ alone is the
    exact (bitwise-identical) answer. Computed on the index's device
    from the fp32 label planes (a delta16 index keeps them beside the
    encoded ones); one ``host_read`` of the mask.

    Accepts both label layouts: unsharded ``[n+1, l_cap]`` planes and a
    ``ShardedIndex``'s ``[P, n+1, cap_s]`` blocks (core entries are
    replicated into every block, so reducing over the shard axis too
    gives the same mask). Blocks on several devices are reduced on
    each and combined on the index's device."""
    n, k = index.n, index.k
    lev = np.append(index.level, k + 1).astype(np.int32)
    planes = (list(zip(index.lbl_ids, index.lbl_d))
              if isinstance(index.lbl_ids, list)
              else [(index.lbl_ids, index.lbl_d)])
    has_core = None
    for ids, d in planes:
        lev_pad = upload(lev, ids.device)
        entry_core = ((ids < n) & (lev_pad[ids.clamp(max=n).long()] == k)
                      & torch.isfinite(d))
        part = entry_core.any(-1)
        if part.dim() == 2:                  # [P, n+1] of stacked blocks
            part = part.any(0)
        part = part.to(index.device, non_blocking=True)
        has_core = part if has_core is None else has_core | part
    return ~host_read(has_core)


class DistanceServer:
    """Micro-batching, routing, caching distance server for one index."""

    def __init__(self, index, *, name: str = "default",
                 buckets=(64, 256, 1024), max_wait_ms: float = 2.0,
                 cache_size: int = 65536, cache_symmetric: bool = False,
                 backend: str | None = None, warmup: bool = True,
                 path_hop_caps=None, versioned: bool = False,
                 version_kwargs: dict | None = None,
                 tracer=None, registry=None):
        if versioned:
            if path_hop_caps:
                raise ValueError(
                    "versioned serving does not cover the path lane; "
                    "serve paths from a non-versioned server")
            if hasattr(index, "num_shards"):
                raise ValueError(
                    "versioned serving is unsharded-only; mutate a "
                    "ShardedIndex via apply_mutations and re-register")
        self.index = index
        self.name = name
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.backend = backend
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None else REGISTRY
        self.metrics = ServeMetrics(server=name, registry=self.registry)
        self.cache = LRUCache(cache_size, symmetric=cache_symmetric)
        self.lanes = {lane: MicroBatcher(self.buckets, self.max_wait_s)
                      for lane in LANES}
        self.versions = None
        if versioned:
            from repro_torch.serve.versions import VersionManager
            with compile_region("warmup"):
                self.versions = VersionManager.from_index(
                    index, **(version_kwargs or {}))
        self.path_hop_caps = (tuple(sorted(int(h) for h in path_hop_caps))
                              if path_hop_caps else ())
        if self.path_hop_caps:
            # never symmetric: a path vertex list is directional — a
            # (t, s) hit would serve the (s, t) list reversed
            self.path_cache = LRUCache(cache_size, symmetric=False)
            self.lanes[PATH_LANE] = MicroBatcher(self.buckets,
                                                 self.max_wait_s)
        self._bind()
        self._results: dict[int, object] = {}
        self._next_rid = 0
        self.warmup_seconds = 0.0
        # synthetic stall added to every distance batch's charged
        # execution time (accounting only; ReplicaSet.set_stall)
        self.exec_delay_s = 0.0
        if warmup:
            self.warmup()

    def _bind(self) -> None:
        """Routing mask and entry points of the index as it is now (of
        the version family in versioned mode)."""
        if self.versions is not None:
            family = self.versions.family
            self._no_core_entry = self.versions.current.mu_mask
            self._fns = {"mu": family.mu_fn(self.backend),
                         "full": family.full_fn(self.backend)}
            self._path_fns = {}
            return
        with compile_region("warmup"):
            self._no_core_entry = mu_exact_mask(self.index)
            self._fns = {"mu": self.index.engine.mu_batch_fn(self.backend),
                         "full": self.index.engine.batch_fn(self.backend)}
            self._path_fns = {}
            if self.path_hop_caps:
                engine = self.index.path_engine()
                self._path_fns = {h: engine.path_batch_fn(h, self.backend)
                                  for h in self.path_hop_caps}

    def refresh(self, warmup: bool = True) -> None:
        """Re-sync with the index after an in-place mutation (§8.3
        ``insert_vertex``/``delete_vertex``): drops every cached
        answer, recomputes the routing mask, and rebinds (and by
        default re-warms) the entry points — the mutators install a
        fresh ``QueryEngine``."""
        if self.versions is not None:
            raise ValueError("versioned server: mutate through "
                             "submit_mutation(ops, now) instead")
        self.cache.clear()
        if self.path_hop_caps:
            self.path_cache.clear()
        self._bind()
        if warmup:
            self.warmup()

    # ----------------------------------------------------------- warmup
    def warmup(self) -> dict:
        """Run every (lane, bucket) entry point once, so no first-use
        build and no new batch shape happens on the serving path. With
        a path lane, every (bucket, hop_cap) tier too."""
        t0 = time.perf_counter()
        with compile_region("warmup"):
            if self.versions is not None:
                timings = self.versions.warmup(self.buckets, self.backend)
            else:
                timings = self.index.engine.warmup(self.buckets,
                                                   self.backend)
            if self.path_hop_caps:
                timings.update(self.index.path_engine().warmup(
                    self.buckets, self.path_hop_caps, self.backend))
        self.warmup_seconds = time.perf_counter() - t0
        return timings

    def compile_cache_sizes(self) -> dict:
        """Per lane, the distinct batch shapes its entry point has run
        (the counterpart of ``repro``'s jit cache entries).

        The entry points are memoized per (index engine, backend) and
        therefore *shared* by every server over the same index, so
        another server's warmup can grow these counts. The guarantee is
        the delta: the counts do not change across any amount of
        serving."""
        out = {lane: len(fn.shapes) for lane, fn in self._fns.items()}
        for h, fn in self._path_fns.items():
            out[f"path{h}"] = len(fn.shapes)
        return out

    # ---------------------------------------------------------- routing
    def route(self, s, t) -> np.ndarray:
        """Lane per pair: "mu" where Equation 1 is provably exact.

        Also tallies the paper's §5.2 endpoint classes (``classify``:
        1 = both core, 2 = one, 3 = neither) into the metrics — class 1
        pairs are never μ-eligible (each core endpoint holds itself as
        a core label entry), class 2/3 only when the mask proves the
        core term is +inf."""
        s = np.atleast_1d(np.asarray(s, np.int64))
        t = np.atleast_1d(np.asarray(t, np.int64))
        cls = self.index.engine.classify(s, t, self.index.level, self.index.k)
        self.metrics.record_types(cls)
        eligible = self._no_core_entry[s] | self._no_core_entry[t]
        return np.where(eligible, "mu", "full")

    # ------------------------------------------------------ request path
    def submit(self, s: int, t: int, now: float,
               lane: str | None = None) -> int:
        """Enqueue one query; returns its request id. Cache hits are
        answered immediately (the rid is already resolved)."""
        rid = self._next_rid
        self._next_rid += 1
        hit = self.cache.get(s, t)
        if hit is not None:
            self._results[rid] = hit
            self.metrics.record_cache_hit()
            self.tracer.event("cache_hit", now, cat="request",
                              trace_id=rid, track="lane:cache",
                              s=int(s), t=int(t))
            return rid
        if lane is None:
            lane = str(self.route(s, t)[0])
        self.lanes[lane].add(PendingRequest(rid, int(s), int(t), float(now)))
        return rid

    def submit_path(self, s: int, t: int, now: float) -> int:
        """Enqueue one shortest-path request on the path lane (requires
        ``path_hop_caps``); returns its request id. The resolved value
        is a ``PathAnswer``. Cache hits resolve immediately."""
        if not self.path_hop_caps:
            raise ValueError("server built without path_hop_caps; "
                             "path lane is disabled")
        rid = self._next_rid
        self._next_rid += 1
        hit = self.path_cache.get(s, t)
        if hit is not None:
            self._results[rid] = hit
            self.metrics.record_cache_hit()
            self.tracer.event("cache_hit", now, cat="request",
                              trace_id=rid, track="lane:cache",
                              s=int(s), t=int(t), lane="path")
            return rid
        self.lanes[PATH_LANE].add(
            PendingRequest(rid, int(s), int(t), float(now)))
        return rid

    def pump(self, now: float, force: bool = False) -> int:
        """Execute every batch that is ready at ``now`` (bucket filled,
        deadline expired, or ``force``). Returns requests completed."""
        done = 0
        for lane_name, lane in self.lanes.items():
            while (batch := lane.drain(now, force=force)) is not None:
                if lane_name == PATH_LANE:
                    done += self._execute_path(batch)
                else:
                    done += self._execute(lane_name, batch)
        return done

    def take_result(self, rid: int):
        return self._results.pop(rid, None)

    def _batch_arrays(self, batch):
        """Shared batch prologue: int32 endpoint arrays edge-padded up to
        the bucket shape (padding replays the last request, so
        escalation and routing decisions see only real endpoints),
        uploaded to the index's device without a blocking copy."""
        reqs = batch.requests
        p = len(reqs)
        s = np.fromiter((r.s for r in reqs), np.int32, p)
        t = np.fromiter((r.t for r in reqs), np.int32, p)
        pad = batch.bucket - p
        dev = self.index.device
        return (reqs, p, upload(np.pad(s, (0, pad), mode="edge"), dev),
                upload(np.pad(t, (0, pad), mode="edge"), dev))

    def _trace_batch(self, lane: str, batch, reqs, exec_s: float,
                     **exec_args) -> None:
        """Emit the request-lifecycle spans for one executed batch.
        Sits entirely outside the timed execution window, so tracing
        cost never lands in ``exec_s`` (and thus never in qps_compute).

        Timeline: queue waits live on the serving clock, the measured
        device execution is charged as an interval starting at the
        flush instant — so every request span's duration equals its
        recorded latency exactly, and its queue_wait + device_exec
        children cover all of it."""
        tr = self.tracer
        if not tr.enabled:
            return
        track = f"lane:{lane}"
        for r in reqs:
            flush = max(r.t_arrival, batch.t_flush)
            sp = tr.start("request", r.t_arrival, cat="request",
                          trace_id=r.rid, track=track, lane=lane,
                          s=r.s, t=r.t, bucket=batch.bucket)
            tr.add("queue_wait", r.t_arrival, flush, cat="wait",
                   trace_id=r.rid, parent=sp, track=track)
            tr.add("device_exec", flush, flush + exec_s, cat="exec",
                   trace_id=r.rid, parent=sp, track=track, **exec_args)
            tr.end(sp, flush + exec_s)

    def _execute(self, lane: str, batch) -> int:
        reqs, p, s_pad, t_pad = self._batch_arrays(batch)
        version = None if self.versions is None else self.versions.acquire()
        with compile_region("serve_read"):
            t0 = time.perf_counter()
            if version is not None:
                out = self._fns[lane](version.state, s_pad, t_pad)
            else:
                out = self._fns[lane](s_pad, t_pad)
            # one blocking read of the batch's results
            if lane == "full":
                ans, rounds = host_read(out)
                rounds = int(rounds)
            else:
                ans, rounds = host_read(out), 0
            exec_s = time.perf_counter() - t0 + self.exec_delay_s
        if version is not None:
            self.versions.release(version)
        for i, r in enumerate(reqs):
            val = float(ans[i])
            self._results[r.rid] = val
            self.cache.put(r.s, r.t, val)
            # clamp: with sparse wall-clock pumps a request can arrive
            # after the oldest's deadline (the stamped flush instant)
            wait = max(0.0, batch.t_flush - r.t_arrival)
            self.metrics.record_latency(wait + exec_s)
        self.metrics.record_batch(lane, batch.bucket, p, exec_s, rounds)
        self._trace_batch(lane, batch, reqs, exec_s, rounds=rounds,
                          vid=None if version is None else version.vid)
        return p

    def _execute_path(self, batch) -> int:
        """Run one path-lane batch: lowest hop_cap tier first, escalate
        to the next pre-warmed tier while any path overflows, host
        oracle for anything longer than every tier (its cost charged to
        the batch's execution time). Each tier's results come to the
        host in one read, which decides the escalation."""
        reqs, p, s_pad, t_pad = self._batch_arrays(batch)
        tr = self.tracer
        exec_s = 0.0
        for hop_cap in self.path_hop_caps:
            with compile_region("serve_path"):
                t0 = time.perf_counter()
                out = self._path_fns[hop_cap](s_pad, t_pad)
                dist, verts, lens, ok, rounds = host_read(
                    (out.dist, out.verts, out.lens, out.ok, out.rounds))
                tier_s = time.perf_counter() - t0
            tr.add(f"tier:h{hop_cap}", batch.t_flush + exec_s,
                   batch.t_flush + exec_s + tier_s, cat="batch",
                   track="lane:path", hop_cap=hop_cap, bucket=batch.bucket)
            exec_s += tier_s
            if bool(ok[:p].all()):
                break
            self.metrics.record_path_overflow()
            tr.event("escalate", batch.t_flush + exec_s, cat="batch",
                     track="lane:path", hop_cap=hop_cap)
        answers = {}
        n_fallback = 0
        t0 = time.perf_counter()
        with compile_region("serve_path"):
            for i, r in enumerate(reqs):
                if ok[i]:
                    answers[i] = PathAnswer(
                        float(dist[i]), tuple(verts[i, :lens[i]].tolist()),
                        True)
                else:
                    # longer than every warmed tier: exact host oracle;
                    # a finite distance with an empty path is never
                    # reported as a trustworthy path
                    n_fallback += 1
                    d_host, path = self.index.shortest_path(r.s, r.t)
                    answers[i] = PathAnswer(
                        float(d_host), tuple(path),
                        bool(path) or not np.isfinite(d_host))
        host_s = time.perf_counter() - t0
        if n_fallback:
            tr.add("host_fallback", batch.t_flush + exec_s,
                   batch.t_flush + exec_s + host_s, cat="batch",
                   track="lane:path", requests=n_fallback)
        exec_s += host_s
        for i, r in enumerate(reqs):
            self._results[r.rid] = answers[i]
            self.path_cache.put(r.s, r.t, answers[i])
            wait = max(0.0, batch.t_flush - r.t_arrival)
            self.metrics.record_latency(wait + exec_s)
        self.metrics.record_batch(PATH_LANE, batch.bucket, p, exec_s,
                                  int(rounds))
        self._trace_batch(PATH_LANE, batch, reqs, exec_s, rounds=int(rounds))
        return p

    # ----------------------------------------------------- mutation lane
    def submit_mutation(self, ops, now: float):
        """Apply a §8.3 insert/delete batch between micro-batches.

        Pending read batches are force-flushed first, so every already-
        submitted request completes on the version that was current at
        its submit time (hot-swap atomicity). Then the batch applies
        copy-on-write inside ``compile_region("mutation")``, the new
        version publishes atomically, the per-version caches (LRU
        answers, routing mask, the host oracle the audits read via
        ``self.index``) move to the new version, and the old version is
        retired — dropped now if no reader pins it, else when the last
        in-flight ``release`` lands. The entry points are untouched:
        same family, same shapes. Returns the new ``IndexVersion``."""
        if self.versions is None:
            raise ValueError("server not versioned: pass versioned=True "
                             "(or use ISLabelIndex.insert_vertex + "
                             "refresh())")
        tr = self.tracer
        t0 = time.perf_counter()
        self.pump(now, force=True)
        flush_s = time.perf_counter() - t0
        old = self.versions.current
        with compile_region("mutation"):
            version = self.versions.apply(ops)
        t1 = time.perf_counter()
        self.index = version.index
        self._no_core_entry = version.mu_mask
        self.cache.clear()
        self.versions.retire(old)
        retire_s = time.perf_counter() - t1
        self.metrics.record_mutation(len(ops), version.swap_seconds)
        if tr.enabled:
            # mutation-lane spans on the serving clock: wall-clock stage
            # durations laid out end to end from the submit instant
            msp = tr.start("mutation", now, cat="mutation",
                           track="lane:mutation", trace_id=version.vid,
                           ops=len(ops), vid=version.vid)
            cursor = now
            stages = [("flush_pending", flush_s)]
            stages += [(k, version.stage_seconds.get(k, 0.0))
                       for k in ("cow_apply", "device_update", "publish")]
            stages.append(("retire", retire_s))
            for sname, dur in stages:
                tr.add(sname, cursor, cursor + dur, cat="mutation",
                       trace_id=version.vid, parent=msp,
                       track="lane:mutation")
                cursor += dur
            tr.end(msp, cursor)
        return version

    def drain(self, now: float | None = None) -> int:
        """Flush every pending batch and retire all non-current
        versions. Returns requests completed; raises if a retired
        version is still pinned (a reader leaked an ``acquire``)."""
        done = self.pump(float("inf") if now is None else now, force=True)
        if self.versions is not None:
            leftover = self.versions.drain()
            if leftover:
                raise RuntimeError(
                    f"versions {leftover} still pinned after drain")
        return done

    def serve_readwrite_trace(self, trace):
        """Replay a ``readwrite`` loadgen trace: reads micro-batch as
        usual, write rows apply through ``submit_mutation`` on the
        trace clock. Returns ``(answers float32[R], vids int64[R])`` —
        NaN answers on write rows, and per row the version id the
        request was served under (write rows report the version they
        published), so a differential audit can replay every read
        against the exact snapshot that answered it."""
        if self.versions is None:
            raise ValueError("serve_readwrite_trace needs versioned=True")
        if trace.writes is None:
            raise ValueError("trace has no writes; use serve_trace")
        n_req = len(trace)
        rids = np.full(n_req, -1, np.int64)
        vids = np.zeros(n_req, np.int64)
        for i in range(n_req):
            now = float(trace.arrival_s[i])
            self.pump(now)
            if trace.writes[i] is not None:
                vids[i] = self.submit_mutation(trace.writes[i], now).vid
            else:
                vids[i] = self.versions.current.vid
                rids[i] = self.submit(int(trace.s[i]), int(trace.t[i]), now)
            self.pump(now)
        self.pump(trace.span_s, force=True)
        self.metrics.trace_span_s += trace.span_s
        answers = np.full(n_req, np.nan, np.float32)
        for i in range(n_req):
            if rids[i] >= 0:
                answers[i] = self._results.pop(int(rids[i]))
        return answers, vids

    # ------------------------------------------------------ trace replay
    def _replay(self, trace, submit_fn) -> np.ndarray:
        """Shared replay loop: drive the batcher on the trace's
        simulated clock, submitting each request via ``submit_fn(i, s,
        t, now)``. Returns the request ids."""
        n_req = len(trace)
        rids = np.empty(n_req, np.int64)
        for i in range(n_req):
            now = float(trace.arrival_s[i])
            self.pump(now)
            rids[i] = submit_fn(i, int(trace.s[i]), int(trace.t[i]), now)
            self.pump(now)
        self.pump(trace.span_s, force=True)
        self.metrics.trace_span_s += trace.span_s
        return rids

    def serve_trace(self, trace) -> np.ndarray:
        """Replay a loadgen trace on its simulated clock. Returns
        float32 answers aligned with the trace; metrics accumulate on
        ``self.metrics``."""
        lanes = self.route(trace.s, trace.t)
        rids = self._replay(
            trace, lambda i, s, t, now: self.submit(s, t, now,
                                                    lane=str(lanes[i])))
        answers = np.empty(len(trace), np.float32)
        for i in range(len(trace)):
            answers[i] = self._results.pop(int(rids[i]))
        return answers

    def serve_path_trace(self, trace):
        """Replay a loadgen trace as shortest-*path* requests. Returns
        ``(dist float32[R], paths list of vertex lists, valid bool[R])``
        aligned with the trace; metrics accumulate under the "path"
        lane."""
        rids = self._replay(
            trace, lambda i, s, t, now: self.submit_path(s, t, now))
        n_req = len(trace)
        dist = np.empty(n_req, np.float32)
        paths, valid = [], np.empty(n_req, bool)
        for i in range(n_req):
            ans = self._results.pop(int(rids[i]))
            dist[i] = ans.dist
            paths.append(list(ans.path))
            valid[i] = ans.valid
        return dist, paths, valid

    # ----------------------------------------------------------- status
    def stats(self) -> dict:
        return {
            "name": self.name,
            "graph": {"n": self.index.n, "k": self.index.k,
                      "n_core": int(self.index.stats.n_core),
                      "shards": int(getattr(self.index, "num_shards", 1))},
            "buckets": list(self.buckets),
            "path_hop_caps": list(self.path_hop_caps),
            "max_wait_ms": self.max_wait_s * 1e3,
            "backend": self.backend or "auto",
            "warmup_seconds": self.warmup_seconds,
            "compiled_shapes": self.compile_cache_sizes(),
            "versions": (None if self.versions is None else {
                "current": self.versions.current.vid,
                "live": self.versions.live_versions(),
                "core_cap": self.versions.family.core_cap,
                "edge_cap": self.versions.family.edge_cap,
            }),
            # process-wide registry sections (fault counters where a
            # component reports them, and the first-use build and
            # allocator gauges of obs.profiler)
            "fault": self.registry.section("fault.") or None,
            "obs": self.registry.section("obs.") or None,
            **self.metrics.snapshot(),
        }
