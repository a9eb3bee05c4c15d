"""The ``rebuild`` traffic kind: ``ISLabelIndex.build`` from the host
edge list, back to back, each build dropping the index before it. The
weights cycle through ``VARIANTS`` sets drawn from the seed (the first
is the configuration's own, which only the warm-up build uses), so an
index left over from an earlier build answers wrongly. The check takes
``CHECK_PAIRS`` pairs drawn from the seed, over the vertices that have
an edge, on the last index."""
from __future__ import annotations

import gc
import time

from portbench.bench import (CHECK, WEIGHTS, Window, endpoints,
                             index_config, rng, setup_parts)
from portbench.graphs import reweighted

VARIANTS = 4
CHECK_PAIRS = 1024


def run(ctx: dict) -> dict:
    """Set-up, the window, and the pairs to check on the last index
    built."""
    from repro_torch.core import ISLabelIndex
    n, src, dst, w = ctx["graph"]
    dev, seed = ctx["device"], ctx["seed"]
    cfg = index_config(ctx["config"])
    max_w = ctx["config"]["graph"]["args"]["max_w"]
    weights = [w] + [reweighted(w, int(rng(seed, WEIGHTS, i).integers(
        2 ** 62)), max_w) for i in range(1, VARIANTS)]
    ISLabelIndex.build(n, src, dst, weights[0], cfg, device=dev)
    t_built = time.perf_counter()
    gc.collect()
    t_ready = time.perf_counter()
    run = {"setup_s": t_ready - ctx["t_start"],
           "setup_parts": setup_parts(ctx, t_built, t_ready)}
    builds = []
    idx = None
    window = Window(ctx["trace"], dev)
    with window.open():
        t0 = time.perf_counter()
        end = t0 + ctx["seconds"]
        while time.perf_counter() < end:
            idx = None                      # drop the index before
            k = (len(builds) + 1) % VARIANTS
            with window.span("build"):
                idx = ISLabelIndex.build(n, src, dst, weights[k], cfg,
                                         device=dev)
            builds.append({"peel_s": idx.stats.peel_seconds,
                           "label_s": idx.stats.label_seconds,
                           "variant": k})
        t1 = time.perf_counter()
    run.update(window_s=t1 - t0, builds=builds, n_core=idx.stats.n_core,
               k=idx.k)
    s, t = endpoints(ctx["graph"])(rng(seed, CHECK), CHECK_PAIRS)
    got = idx.query_host(s, t)
    return {"run": run, "window": window, "index": idx,
            "check": (weights[builds[-1]["variant"]], s, t, got,
                      CHECK_PAIRS)}
