"""The ``query`` traffic kind: one client in a closed loop. Each request
is a batch of ``batch`` pairs, s and t drawn uniformly from the seed
over the vertices that have an edge, sent through
``ISLabelIndex.query_host``; the next request goes when the answers are
on the host. The check takes every pair of one request drawn from the
seed."""
from __future__ import annotations

import time

from portbench.bench import (CHECK, TRAFFIC, WARMUP, Window, endpoints,
                             index_config, rng, setup_parts)


def run(ctx: dict) -> dict:
    """Set-up, the window, and the pairs to check."""
    from repro_torch.core import ISLabelIndex
    from repro_torch.core import sync as hsync
    n, src, dst, w = ctx["graph"]
    batch = ctx["traffic"]["batch"]
    dev, seed = ctx["device"], ctx["seed"]
    pick = endpoints(ctx["graph"])
    idx = ISLabelIndex.build(n, src, dst, w, index_config(ctx["config"]),
                             device=dev)
    t_built = time.perf_counter()
    idx.query_host(*pick(rng(seed, WARMUP), batch))
    t_ready = time.perf_counter()
    run = {"setup_s": t_ready - ctx["t_start"],
           "setup_parts": setup_parts(ctx, t_built, t_ready),
           "batch": batch, "n_core": idx.stats.n_core,
           "route": (idx.engine.relaxer.mode
                     if idx.engine.relaxer is not None else "none")}
    draw = rng(seed, TRAFFIC)
    lat, asked, answers = [], [], []
    window = Window(ctx["trace"], dev)
    syncs0 = hsync.sync_count()
    with window.open():
        t0 = time.perf_counter()
        end = t0 + ctx["seconds"]
        while time.perf_counter() < end:
            s, t = pick(draw, batch)
            ts = time.perf_counter()
            with window.span("entry"):
                ans = idx.query_host(s, t)
            lat.append(time.perf_counter() - ts)
            asked.append((s, t))
            answers.append(ans)
        t1 = time.perf_counter()
    run.update(window_s=t1 - t0, latencies_s=lat,
               pairs=batch * len(lat), requests=len(lat),
               syncs=hsync.sync_count() - syncs0)
    i = int(rng(seed, CHECK).integers(len(lat)))
    return {"run": run, "window": window, "index": idx,
            "check": (w, *asked[i], answers[i], batch)}
