"""Quick end-to-end correctness smoke for the IS-LABEL core, on the port.

  PYTHONPATH=src python -m repro_torch.scripts.smoke_core [--device cpu]

Builds an index on each of four small graphs (``l_cap=256``,
``label_chunk=512``), checks 200 random queries against the Dijkstra
oracle and five shortest paths edge by edge, and prints "ALL OK".
``--graph NAME`` (repeatable) runs only the named graphs.
"""
import argparse

import numpy as np

from repro_torch.core import ISLabelIndex, IndexConfig, ref
from repro_torch.graphs import generators as gen
from repro_torch.kernels.backend import resolve_device

GRAPHS = {
    "er": lambda: gen.er_graph(300, avg_deg=3.0, seed=1),
    "rmat": lambda: gen.rmat_graph(9, avg_deg=6.0, seed=2),
    "grid": lambda: gen.grid_graph(18, seed=3),
    "caveman": lambda: gen.caveman_graph(12, 8, seed=4),
}
QUERIES = 200
PATHS = 5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", action="append", choices=sorted(GRAPHS),
                    help="run only this graph (repeatable; default: all "
                         "four)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.graph or list(GRAPHS)

    rng = np.random.default_rng(0)
    out = {}
    for name in GRAPHS:
        # the pairs of every graph are drawn, so a chosen graph gets the
        # pairs it gets in a run of all four
        n, src, dst, w = GRAPHS[name]()
        s = rng.integers(0, n, QUERIES).astype(np.int32)
        t = rng.integers(0, n, QUERIES).astype(np.int32)
        if name not in names:
            continue
        cfg = IndexConfig(l_cap=256, label_chunk=512)
        idx = ISLabelIndex.build(n, src, dst, w, cfg, device=device)
        print(f"[{name}] {idx.stats.summary()} "
              f"levels={idx.stats.level_sizes}")
        got = idx.query_host(s, t)
        oracle = ref.dijkstra_oracle(n, src, dst, w, s)
        want = oracle[np.arange(QUERIES), t]
        ok = np.allclose(got, want, equal_nan=False)
        bad = np.flatnonzero(~np.isclose(got, want))
        print(f"   query match: {ok}  (mismatches: {len(bad)})")
        if len(bad):
            for b in bad[:5]:
                print(f"   s={s[b]} t={t[b]} got={got[b]} want={want[b]}")
            raise SystemExit(1)
        # path reconstruction spot-check against the edge list
        ed = {}
        for a, b, ww in zip(src, dst, w):
            ed[(int(a), int(b))] = min(ed.get((int(a), int(b)), np.inf),
                                       float(ww))
        paths = 0
        for qi in range(PATHS):
            d, path = idx.shortest_path(int(s[qi]), int(t[qi]))
            if not np.isfinite(d):
                continue
            if path[0] != s[qi] or path[-1] != t[qi]:
                raise AssertionError((path, s[qi], t[qi]))
            ln = sum(ed[(path[i], path[i + 1])] for i in range(len(path) - 1))
            if abs(ln - d) >= 1e-4:
                raise AssertionError((ln, d, path))
            paths += 1
        print("   paths ok")
        relaxer = idx.engine.relaxer
        out[name] = {"n": n, "k": idx.k, "n_core": idx.stats.n_core,
                     "route": relaxer.mode if relaxer else "none",
                     "queries": QUERIES, "mismatches": 0,
                     "paths_checked": paths,
                     "build_s": idx.stats.build_seconds}
    print("ALL OK")
    return {"device": str(device), "graphs": out}


if __name__ == "__main__":
    main()
