"""Scenario load generator: synthetic request traces for the serving
subsystem and its benchmarks.

A trace is (arrival_s, s, t) arrays sorted by arrival time; the server
replays it on a simulated clock (`DistanceServer.serve_trace`), so the
same trace is exactly reproducible across runs, backends, and saved /
loaded indexes.

Scenarios (endpoint distribution × arrival process):

  * ``uniform``  — endpoints uniform over V, Poisson arrivals. The
    paper's random-query evaluation regime (Table 4/5).
  * ``hotspot``  — endpoints Zipf-distributed over a random permutation
    of V (a small hot set receives most traffic), Poisson arrivals.
    Social/web traffic shape; exercises the result cache and skewed
    label rows.
  * ``bursty``   — uniform endpoints, arrivals in on/off bursts: a
    burst of B requests back-to-back, then an idle gap. Exercises both
    batcher regimes (full buckets inside a burst, deadline flushes at
    the gap edges).
  * ``repeated`` — requests drawn from a small fixed pool of (s, t)
    pairs, Poisson arrivals. Dashboard/monitoring shape; upper-bounds
    cache effectiveness.
  * ``straggler`` — uniform endpoints and arrivals, plus a
    failure-injection plan in ``meta["inject"]``: one replica of a
    ``ReplicaSet`` is given a synthetic per-batch stall
    (``DistanceServer.exec_delay_s``), so replaying the same trace with
    and without injection is the clean/degraded pair the SLO burn-rate
    alert tests and the CI http-serving smoke compare. Answers stay
    bitwise exact — only timing degrades.
  * ``readwrite`` — uniform reads with §8.3 mutation batches mixed in
    at ``write_ratio``: inserts draw a vertex from a spare pool and
    attach it to core vertices (initial core + live inserted — the
    rebuild-exact domain), deletes remove a live
    inserted vertex back into the pool. Reads never target a dead
    spare, so every read is rebuild-auditable. Replayed with
    ``DistanceServer.serve_readwrite_trace`` on a versioned server.

The port's copy of ``repro.serve.loadgen`` (numpy only): the same
``make_trace(...)`` call gives the same trace, field by field, in
either package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.versions import MutationOp


@dataclasses.dataclass
class Trace:
    name: str
    arrival_s: np.ndarray    # float64[R], sorted, seconds from 0
    s: np.ndarray            # int32[R]
    t: np.ndarray            # int32[R]
    meta: dict
    # per-request mutation batch: None = read; a list of MutationOp
    # makes request i a write (s/t are placeholder zeros for writes)
    writes: list | None = None

    def __len__(self) -> int:
        return len(self.arrival_s)

    @property
    def span_s(self) -> float:
        return float(self.arrival_s[-1]) if len(self.arrival_s) else 0.0


def _poisson_arrivals(rng, num_requests: int, rate_qps: float) -> np.ndarray:
    gaps = rng.exponential(1.0 / rate_qps, num_requests)
    out = np.cumsum(gaps)
    return out - out[0]


def _zipf_endpoints(rng, n: int, size: int, alpha: float) -> np.ndarray:
    """Zipf ranks clipped to [1, n], mapped through a random permutation
    so the hot set is scattered over vertex ids."""
    ranks = np.minimum(rng.zipf(alpha, size), n) - 1
    perm = rng.permutation(n)
    return perm[ranks].astype(np.int32)


def uniform_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                  seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    return Trace(
        "uniform", _poisson_arrivals(rng, num_requests, rate_qps),
        rng.integers(0, n, num_requests).astype(np.int32),
        rng.integers(0, n, num_requests).astype(np.int32),
        {"n": n, "rate_qps": rate_qps, "seed": seed})


def hotspot_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                  seed: int = 0, alpha: float = 1.2) -> Trace:
    rng = np.random.default_rng(seed)
    return Trace(
        "hotspot", _poisson_arrivals(rng, num_requests, rate_qps),
        _zipf_endpoints(rng, n, num_requests, alpha),
        _zipf_endpoints(rng, n, num_requests, alpha),
        {"n": n, "rate_qps": rate_qps, "seed": seed, "alpha": alpha})


def bursty_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                 seed: int = 0, burst: int = 128,
                 duty_cycle: float = 0.1) -> Trace:
    """Bursts of ``burst`` requests at ``rate_qps / duty_cycle`` within
    the burst, separated by idle gaps so the long-run rate is
    ``rate_qps``."""
    rng = np.random.default_rng(seed)
    in_burst_gap = duty_cycle / rate_qps
    gaps = np.full(num_requests, in_burst_gap)
    # total idle budget spread over the interior gaps (the trace starts
    # at t=0, so there are n_bursts-1 of them — without the correction
    # the realized rate overshoots rate_qps by ~1/n_bursts)
    n_bursts = -(-num_requests // burst)
    idle_total = (burst / rate_qps) * (1.0 - duty_cycle) * n_bursts
    gaps[::burst] = idle_total / max(n_bursts - 1, 1)
    gaps[0] = 0.0
    return Trace(
        "bursty", np.cumsum(gaps),
        rng.integers(0, n, num_requests).astype(np.int32),
        rng.integers(0, n, num_requests).astype(np.int32),
        {"n": n, "rate_qps": rate_qps, "seed": seed, "burst": burst,
         "duty_cycle": duty_cycle})


def repeated_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                   seed: int = 0, pool: int = 256) -> Trace:
    rng = np.random.default_rng(seed)
    ps = rng.integers(0, n, pool).astype(np.int32)
    pt = rng.integers(0, n, pool).astype(np.int32)
    pick = rng.integers(0, pool, num_requests)
    return Trace(
        "repeated", _poisson_arrivals(rng, num_requests, rate_qps),
        ps[pick], pt[pick],
        {"n": n, "rate_qps": rate_qps, "seed": seed, "pool": pool})


def readwrite_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                    seed: int = 0, write_ratio: float = 0.05,
                    write_batch: int = 2, n_read: int | None = None,
                    spares=(), attach_to=(), max_deg: int = 3,
                    max_w: int = 8) -> Trace:
    """Reads mixed with §8.3 mutation batches (the serving-under-
    mutation scenario).

    ``spares`` are preallocated vertex ids outside the read range that
    inserts draw from (and deletes return to); ``attach_to`` are the
    index's initial core ids. The generator mirrors the manager's
    strict domain: inserts attach only to attach_to + currently-live
    spares, deletes target only live spares, reads sample the
    ``n_read`` base vertices (always live) plus occasionally a live
    spare. Weights are integer-valued floats so float32 path sums stay
    exact and the rebuild audit can demand bitwise equality.
    """
    rng = np.random.default_rng(seed)
    spares = [int(u) for u in spares]
    attach = [int(c) for c in attach_to]
    if write_ratio > 0 and (not spares or not attach):
        raise ValueError("readwrite with write_ratio > 0 needs spare "
                         "vertex ids and core attach_to candidates")
    n_read = n if n_read is None else int(n_read)
    pool, live = list(spares), []
    arrivals = _poisson_arrivals(rng, num_requests, rate_qps)
    s = np.zeros(num_requests, np.int32)
    t = np.zeros(num_requests, np.int32)
    writes: list = [None] * num_requests
    n_writes = n_ins = n_del = 0

    def read_endpoint():
        if live and rng.random() < 0.15:
            return int(live[int(rng.integers(0, len(live)))])
        return int(rng.integers(0, n_read))

    for i in range(num_requests):
        if rng.random() < write_ratio and (pool or live):
            ops = []
            for _ in range(int(rng.integers(1, write_batch + 1))):
                if pool and (not live or rng.random() < 0.6):
                    u = pool.pop(int(rng.integers(0, len(pool))))
                    cands = attach + live
                    deg = int(rng.integers(1, min(max_deg, len(cands)) + 1))
                    picks = rng.choice(len(cands), size=deg, replace=False)
                    ops.append(MutationOp(
                        "insert", u,
                        tuple(int(cands[j]) for j in picks),
                        tuple(float(x)
                              for x in rng.integers(1, max_w + 1, deg))))
                    live.append(u)
                    n_ins += 1
                elif live:
                    u = live.pop(int(rng.integers(0, len(live))))
                    ops.append(MutationOp("delete", u))
                    pool.append(u)
                    n_del += 1
            writes[i] = ops
            n_writes += 1
        else:
            s[i] = read_endpoint()
            t[i] = read_endpoint()
    return Trace(
        "readwrite", arrivals, s, t,
        {"n": n, "rate_qps": rate_qps, "seed": seed,
         "write_ratio": write_ratio, "writes": n_writes,
         "inserts": n_ins, "deletes": n_del, "spares": len(spares)},
        writes=writes)


def straggler_trace(n: int, num_requests: int, rate_qps: float = 50_000.0,
                    seed: int = 0, stall_replica: int = 0,
                    stall_s: float = 5.0) -> Trace:
    """Uniform load with a straggler-injection plan: ``stall_replica``
    of the serving ``ReplicaSet`` gets ``stall_s`` of synthetic stall
    charged to every distance batch it executes
    (``ReplicaSet.apply_injection`` reads ``meta["inject"]``)."""
    base = uniform_trace(n, num_requests, rate_qps, seed)
    return Trace(
        "straggler", base.arrival_s, base.s, base.t,
        {**base.meta,
         "inject": {"replica": int(stall_replica),
                    "stall_s": float(stall_s)}})


SCENARIOS = {
    "uniform": uniform_trace,
    "hotspot": hotspot_trace,
    "bursty": bursty_trace,
    "repeated": repeated_trace,
    "readwrite": readwrite_trace,
    "straggler": straggler_trace,
}


def make_trace(scenario: str, n: int, num_requests: int, **kw) -> Trace:
    try:
        fn = SCENARIOS[scenario]
    except KeyError:
        raise ValueError(
            f"unknown scenario {scenario!r}; one of {sorted(SCENARIOS)}")
    return fn(n, num_requests, **kw)
