"""Host-side path validation — the exactness gate of the path lane: the
port's copy of ``repro.paths.validate`` (numpy only), used by its tests
and ``chip_smoke.py``.

A reconstructed path is *valid* iff: its endpoints are the queried
(s, t); every consecutive pair is an edge of the original graph with
the weight the engine reported; and the weight sum reproduces the
served distance. With the repo's integer-valued weights (graph
generators emit 1..max_w) every sum is exactly representable, so the
distance check is bitwise; for general float weights it falls back to a
relative tolerance.
"""
from __future__ import annotations

import numpy as np


def edge_weight_map(src, dst, w) -> dict:
    """(u, v) -> min edge weight over parallel edges (float)."""
    out: dict = {}
    for a, b, ww in zip(np.asarray(src), np.asarray(dst), np.asarray(w)):
        key = (int(a), int(b))
        ww = float(ww)
        if key not in out or ww < out[key]:
            out[key] = ww
    return out


def integral_weights(edges: dict) -> bool:
    """True when every edge weight is integer-valued (float32 sums are
    then exact, so the distance comparison can be bitwise)."""
    return all(float(w).is_integer() for w in edges.values())


def check_vertex_path(edges: dict, s: int, t: int, dist: float, path,
                      rtol: float = 1e-5,
                      exact: bool | None = None) -> list[str]:
    """Violations for one plain vertex-list path (empty list = valid):
    correct endpoints, every hop a real edge, weight sum equal to the
    served distance — bitwise when ``exact`` (default: iff every graph
    weight is integer-valued), else within ``rtol``. Shared by the
    engine-output gate below and the serving/CLI audits.
    """
    errors: list[str] = []
    if not np.isfinite(dist):
        if len(path):
            errors.append(f"unreachable ({s},{t}) returned a "
                          f"{len(path)}-vertex path")
        return errors
    if len(path) < 1:
        return [f"({s},{t}): finite distance {dist} but empty path"]
    if path[0] != s or path[-1] != t:
        errors.append(f"({s},{t}): endpoints {path[0]}..{path[-1]}")
    total = 0.0
    for i, (a, b) in enumerate(zip(path[:-1], path[1:])):
        want_w = edges.get((a, b))
        if want_w is None:
            errors.append(f"({s},{t}): non-edge ({a},{b}) at hop {i}")
            continue
        total += want_w
    dist32 = np.float32(dist)
    sum32 = np.float32(total)
    if exact is None:
        exact = integral_weights(edges)
    exact_ok = sum32 == dist32 if exact else \
        np.isclose(sum32, dist32, rtol=rtol)
    if errors == [] and not exact_ok:
        errors.append(f"({s},{t}): weight sum {sum32} != distance {dist32}")
    return errors


def check_path(edges: dict, s: int, t: int, dist: float, verts, weights,
               length: int, ok: bool, rtol: float = 1e-5,
               exact: bool | None = None) -> list[str]:
    """Violations for one reconstructed ``PathBatch`` entry (empty list
    = valid): the vertex-path gate above plus agreement of the
    engine-reported per-edge weight plane with the graph.

    Overflowed paths (``ok=False``) are not judged — the caller decides
    whether an overflow at its hop_cap tier is acceptable.
    """
    if not ok:
        return []
    vs = [int(v) for v in np.asarray(verts)[:length]]
    errors = check_vertex_path(edges, s, t, dist, vs, rtol=rtol, exact=exact)
    for i, (a, b) in enumerate(zip(vs[:-1], vs[1:])):
        want_w = edges.get((a, b))
        got_w = float(np.asarray(weights)[i])
        if want_w is not None and got_w != want_w:
            errors.append(f"({s},{t}): edge ({a},{b}) weight {got_w} != "
                          f"graph weight {want_w}")
    return errors


def check_path_batch(edges: dict, s, t, batch, rtol: float = 1e-5) -> dict:
    """Gate a whole ``PathBatch`` (or host tuples with the same
    fields). Returns {"checked", "overflowed", "violations": [...]}.
    """
    s = np.atleast_1d(np.asarray(s))
    t = np.atleast_1d(np.asarray(t))
    dist = np.asarray(batch.dist)
    verts = np.asarray(batch.verts)
    weights = np.asarray(batch.weights)
    lens = np.asarray(batch.lens)
    ok = np.asarray(batch.ok)
    violations: list[str] = []
    checked = overflowed = 0
    exact = integral_weights(edges)
    for i in range(len(s)):
        if not ok[i]:
            overflowed += 1
            continue
        checked += 1
        violations += check_path(edges, int(s[i]), int(t[i]),
                                 float(dist[i]), verts[i], weights[i],
                                 int(lens[i]), True, rtol=rtol, exact=exact)
    return {"checked": checked, "overflowed": overflowed,
            "violations": violations}
