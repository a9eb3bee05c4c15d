"""Quickstart on the port: build an IS-LABEL index, query distances,
reconstruct a path, save + reload.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``--n-pow`` and ``--l-cap`` size the graph and the labels (defaults:
``rmat_graph(12)`` at ``l_cap=512``); ``--out`` is where the index is
saved (default: ``quickstart_index_torch`` in the temp directory).
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import ISLabelIndex, IndexConfig, ref
from repro_torch.graphs import generators as gen
from repro_torch.kernels.backend import resolve_device

QUERIES = 256
CHECKED = 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-pow", type=int, default=12,
                    help="the R-MAT graph has 2**n_pow vertices")
    ap.add_argument("--l-cap", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "quickstart_index_torch"),
                    help="where the index is saved and loaded from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a weighted undirected graph (power-law, ~4k vertices)
    n, src, dst, w = gen.rmat_graph(args.n_pow, avg_deg=6.0, seed=7)
    print(f"graph: {n} vertices, {len(src) // 2} edges")

    # 2. build the index (vertex hierarchy -> labels -> core graph)
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(l_cap=args.l_cap),
                             device=device)
    print("built:", idx.stats.summary())
    print("levels:", idx.stats.level_sizes)

    # 3. batched exact distance queries
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, QUERIES).astype(np.int32)
    t = rng.integers(0, n, QUERIES).astype(np.int32)
    d = idx.query_host(s, t)
    print(f"query batch of {QUERIES}: median distance "
          f"{np.median(d[np.isfinite(d)]):.0f}, "
          f"{np.isinf(d).sum()} disconnected pairs")

    # 4. verify against Dijkstra
    want = ref.dijkstra_oracle(n, src, dst, w,
                               s[:CHECKED])[np.arange(CHECKED), t[:CHECKED]]
    if not np.allclose(np.where(np.isfinite(d[:CHECKED]), d[:CHECKED], -1),
                       np.where(np.isfinite(want), want, -1)):
        raise AssertionError("answers differ from Dijkstra")
    print(f"exactness verified on {CHECKED} queries")

    # 5. an actual shortest path (paper §8.1)
    qi = int(np.flatnonzero(np.isfinite(d))[0])
    dist, path = idx.shortest_path(int(s[qi]), int(t[qi]))
    print(f"path {s[qi]} -> {t[qi]} (len {dist:.0f}): {path}")

    # 6. persistence
    idx.save(args.out)
    idx2 = ISLabelIndex.load(args.out, device=device)
    if not np.allclose(idx2.query_host(s[:8], t[:8]), d[:8]):
        raise AssertionError("the loaded index answers otherwise")
    print("save/load roundtrip ok")
    relaxer = idx.engine.relaxer
    return {"device": str(device), "n": n, "m": len(src) // 2, "k": idx.k,
            "n_core": idx.stats.n_core,
            "route": relaxer.mode if relaxer else "none",
            "build_s": idx.stats.build_seconds, "s": s, "t": t,
            "distances": d, "path_pair": (int(s[qi]), int(t[qi])),
            "path_dist": dist, "path": path, "saved": args.out}


if __name__ == "__main__":
    main()
