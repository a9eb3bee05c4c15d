"""End-to-end serving driver on the port (the paper's workload): an
IS-LABEL distance-query service with continuous batching, latency
percentiles, and an exactness audit.

  PYTHONPATH=src python -m repro_torch.examples.distance_serving \\
      [n_pow] [n_requests] [--shards P] [--l-cap L] [--device cpu]

The sharded lane cuts the label table into one shard a card (at most
4); ``--shards P`` puts all P shards on the one device instead (on
``cpu:0`` ... ``cpu:P-1`` under ``--device cpu``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import ISLabelIndex, IndexConfig, ref
from repro_torch.core.sync import host_read
from repro_torch.graphs import generators as gen
from repro_torch.kernels.backend import resolve_device
from repro_torch.paths import check_path_batch, edge_weight_map
from repro_torch.shard import ShardedIndex

BATCH = 512
AUDITED = 64
HOP_CAP = 128


def shard_placement(device: torch.device, shards: int | None):
    """(shard count, ``devices`` for ``ShardedIndex.from_index``): one
    shard a card, at most 4, by default; ``shards`` of them on the one
    device when asked (distinct CPU devices on the CPU)."""
    if shards is None:
        if device.type != "cuda":
            return 1, device
        p = min(torch.cuda.device_count(), 4)
        return p, [torch.device("cuda", i) for i in range(p)]
    if device.type == "cpu":
        return shards, [f"cpu:{i}" for i in range(shards)]
    return shards, device


def main(argv=None, perms=None) -> dict:
    """``perms``: the MIS permutation source handed to
    ``ISLabelIndex.build`` (``core/mis.py``); None draws the port's
    own."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pow", type=int, nargs="?", default=13)
    ap.add_argument("n_requests", type=int, nargs="?", default=8192)
    ap.add_argument("--l-cap", type=int, default=512)
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the sharded lane, all on the one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_req = args.n_requests

    n, src, dst, w = gen.rmat_graph(args.n_pow, avg_deg=6.0, seed=3)
    print(f"[build] n={n} m={len(src) // 2}")
    t0 = time.perf_counter()
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(l_cap=args.l_cap),
                             device=device, perms=perms)
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f}s  {idx.stats.summary()}")

    # simulated request stream with continuous batching
    rng = np.random.default_rng(0)
    reqs = rng.integers(0, n, (n_req, 2)).astype(np.int32)
    lat, served = [], 0
    answers = np.zeros(n_req, np.float32)
    t_serve = time.perf_counter()
    for lo in range(0, n_req, BATCH):
        s_b = reqs[lo:lo + BATCH, 0]
        t_b = reqs[lo:lo + BATCH, 1]
        t1 = time.perf_counter()
        d = host_read(idx.query(s_b, t_b))   # blocks on the device
        lat.append(time.perf_counter() - t1)
        answers[lo:lo + BATCH] = d
        served += len(s_b)
    wall = time.perf_counter() - t_serve
    p50, p99 = np.median(lat) * 1e3, np.quantile(lat, 0.99) * 1e3
    print(f"[serve] {served} requests in {wall:.2f}s -> "
          f"{served / wall:.0f} q/s | per-batch p50 {p50:.1f}ms "
          f"p99 {p99:.1f}ms (batch={BATCH})")

    # audit a sample against Dijkstra
    k = min(AUDITED, n_req)
    want = ref.dijkstra_oracle(n, src, dst, w, reqs[:k, 0])[np.arange(k),
                                                            reqs[:k, 1]]
    fin = np.isfinite(want)
    if not ((np.isfinite(answers[:k]) == fin).all()
            and np.allclose(answers[:k][fin], want[fin])):
        raise AssertionError("served answers differ from Dijkstra")
    print(f"[audit] {k} sampled answers exact vs Dijkstra")

    # query-type mix (paper Table 5)
    types = idx.query_types(reqs[:, 0], reqs[:, 1])
    u, c = np.unique(types, return_counts=True)
    mix = dict(zip(u.tolist(), c.tolist()))
    print("[mix] endpoint types:", mix)

    # sharded lane: partition the label table over the shards' devices;
    # one cross-shard min a batch, answers bitwise
    n_shards, devices = shard_placement(device, args.shards)
    sidx = ShardedIndex.from_index(idx, n_shards, devices=devices)
    d_sh, _ = sidx.engine.batch_fn()(reqs[:BATCH, 0], reqs[:BATCH, 1])
    if not np.array_equal(host_read(d_sh), answers[:BATCH]):
        raise AssertionError("the sharded batch differs from the index's")
    entries = sidx.shard_entry_counts().tolist()
    print(f"[shard] {n_shards} shard(s), entries/shard={entries}, "
          f"one batch bitwise-equal to the unsharded index")
    if n_shards == 1:
        print("[shard] hint: --shards 4 puts 4 shards on one device")
    del sidx

    # path serving: full shortest-path retrieval at batch rates — every
    # served path is edge-validated and its weight sum equals the served
    # distance
    p_s, p_t = reqs[:BATCH, 0], reqs[:BATCH, 1]
    t2 = time.perf_counter()
    out = idx.path_engine().path_batch_fn(hop_cap=HOP_CAP)(p_s, p_t)
    out = type(out)(*host_read(tuple(out)))   # blocks on the device
    rep = check_path_batch(edge_weight_map(src, dst, w), p_s, p_t, out)
    if rep["violations"]:
        raise AssertionError(rep["violations"][:3])
    path_s = time.perf_counter() - t2
    print(f"[paths] {rep['checked']} shortest paths reconstructed + "
          f"validated in {path_s:.2f}s ({rep['overflowed']} over hop_cap)")
    relaxer = idx.engine.relaxer
    return {"device": str(device), "n": n, "m": len(src) // 2,
            "k": idx.k, "n_core": idx.stats.n_core,
            "route": relaxer.mode if relaxer else "none",
            "build_s": build_s, "served": served, "serve_s": wall,
            "qps": served / wall, "batch": BATCH, "batch_p50_ms": p50,
            "batch_p99_ms": p99, "audited": k, "mix": mix,
            "shards": n_shards, "entries_per_shard": entries,
            "paths_checked": rep["checked"],
            "paths_overflowed": rep["overflowed"], "paths_s": path_s,
            "requests": reqs, "answers": answers, "types": types}


if __name__ == "__main__":
    main()
