"""Host-side synthetic graph generators (numpy).

Real datasets from the paper (BTC, UK-Web, as-Skitter, wiki-Talk,
web-Google) are not available offline; these generators reproduce their
*regimes*: sparse power-law (rmat ~ web/social), low-degree semantic
(sparse ER ~ BTC with avg deg 2.19), meshes (grid), and community
graphs (caveman). All return (n, src, dst, weight) with both edge
directions, no self loops, no duplicates, integer-valued float weights.
"""
from __future__ import annotations

import numpy as np


def _pack_pairs(n, u, v):
    """Self-loop-free canonical (lo < hi) pairs as *sorted unique* int64
    keys ``lo * n + hi`` — one 1-D sort replaces the old row-wise
    ``np.unique(..., axis=0)``; key order equals lexicographic (lo, hi)
    order, so decoded pair sets are bitwise-unchanged."""
    keep = u != v
    lo = np.minimum(u[keep], v[keep]).astype(np.int64)
    hi = np.maximum(u[keep], v[keep]).astype(np.int64)
    return np.unique(lo * np.int64(n) + hi)


def _unpack_keys(n, keys):
    return np.stack([keys // n, keys % n], 1)


def _finalize(n, und_edges, rng, max_w, weights=None):
    """und_edges: (m,2) possibly-duplicated undirected pairs, any order.

    Canonicalizes to (lo < hi) *before* the dedup: the old order deduped
    the raw (u, v) rows first, so reversed duplicates survived the first
    pass and the full O(m log m) sort ran twice — on the critical path
    of every 10^6-edge generator."""
    pairs = _unpack_keys(n, _pack_pairs(n, und_edges[:, 0], und_edges[:, 1]))
    m = pairs.shape[0]
    if weights is None:
        weights = rng.integers(1, max_w + 1, size=m).astype(np.float32)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32)
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32)
    w = np.concatenate([weights, weights]).astype(np.float32)
    return n, src, dst, w


def er_graph(n: int, avg_deg: float = 3.0, max_w: int = 4, seed: int = 0):
    """Sparse Erdos-Renyi — the BTC-like low-degree regime."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    return _finalize(n, e, rng, max_w)


def _rmat_chunk(rng, m: int, n_pow: int, a, b, c):
    """Sample m raw R-MAT (src, dst) pairs (recursive quadrant walk)."""
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(n_pow):
        q = rng.random(m)
        sbit = (q >= a + b).astype(np.int64)          # quadrants c,d
        dbit = ((q >= a) & (q < a + b) | (q >= a + b + c)).astype(np.int64)
        src = (src << 1) | sbit
        dst = (dst << 1) | dbit
    return src, dst


def rmat_graph(n_pow: int, avg_deg: float = 8.0, max_w: int = 4, seed: int = 0,
               a=0.57, b=0.19, c=0.19, chunk_edges: int = 2_000_000):
    """R-MAT power-law graph (web/social regime). n = 2**n_pow.

    Raw pairs are sampled in ``chunk_edges``-sized chunks, each chunk
    canonicalized + deduped on arrival, so peak host memory is one raw
    chunk plus the surviving unique keys — the 10^6–10^7-vertex regime
    never materializes all ``n_pow`` bit-planes of the full edge list at
    once. Graphs with m <= chunk_edges are bitwise-identical to the
    unchunked generator at the same seed (one chunk = one rng stream).
    """
    n = 1 << n_pow
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    keys = []
    for lo in range(0, m, chunk_edges):
        src, dst = _rmat_chunk(rng, min(chunk_edges, m - lo), n_pow, a, b, c)
        keys.append(_pack_pairs(n, src, dst))
    pairs = _unpack_keys(n, np.unique(np.concatenate(keys))
                         if len(keys) > 1 else keys[0])
    return _finalize(n, pairs, rng, max_w)


def grid_graph(side: int, max_w: int = 4, seed: int = 0):
    """2D grid — road-network-like regime (max degree 4)."""
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    return _finalize(n, np.concatenate([h, v]), rng, max_w)


def pa_graph(n: int, m_per: int = 2, max_w: int = 4, seed: int = 0,
             chunk: int = 500_000):
    """Chunked preferential attachment (Barabási–Albert, scale-free
    social regime) at 10^6–10^7 vertices.

    The serial BA chain (each vertex attaches to endpoints of the graph
    built so far, proportional to degree) is vectorized per chunk: all
    vertices of a chunk sample their ``m_per`` targets uniformly from
    the *endpoint pool* (every edge contributes both endpoints, so pool
    frequency == degree) as it stood before the chunk — the standard
    copy-model approximation. Chunks ramp geometrically (a chunk never
    more than doubles the vertex count, capped at ``chunk``) so the
    no-feedback window stays a constant fraction of the graph,
    preserving the power-law tail while keeping generation O(m)
    vectorized numpy.
    """
    rng = np.random.default_rng(seed)
    s0 = m_per + 1
    if n <= s0:
        raise ValueError(f"n must exceed m_per + 1 = {s0}")
    # seed clique: every early vertex reachable, pool seeded with degree
    ii, jj = np.triu_indices(s0, k=1)
    edges = [np.stack([ii.astype(np.int64), jj.astype(np.int64)], 1)]
    pool = [np.concatenate([ii, jj]).astype(np.int32)]
    lo = s0
    while lo < n:
        hi = min(lo + min(chunk, max(64, lo)), n)
        flat_pool = np.concatenate(pool) if len(pool) > 1 else pool[0]
        pool = [flat_pool]
        new = np.repeat(np.arange(lo, hi, dtype=np.int64), m_per)
        tgt = flat_pool[rng.integers(0, len(flat_pool), size=len(new))]
        edges.append(np.stack([new, tgt.astype(np.int64)], 1))
        pool.append(np.concatenate([new.astype(np.int32),
                                    tgt.astype(np.int32)]))
        lo = hi
    return _finalize(n, np.concatenate(edges), rng, max_w)


def caveman_graph(n_communities: int, size: int, p_rewire: float = 0.05,
                  max_w: int = 4, seed: int = 0):
    """Connected-caveman — community structure regime."""
    rng = np.random.default_rng(seed)
    n = n_communities * size
    edges = []
    for ci in range(n_communities):
        base = ci * size
        for i in range(size):
            for j in range(i + 1, size):
                edges.append((base + i, base + j))
        edges.append((base + size - 1, (base + size) % n))  # ring link
    e = np.array(edges, np.int64)
    rw = rng.random(len(e)) < p_rewire
    e[rw, 1] = rng.integers(0, n, rw.sum())
    return _finalize(n, e, rng, max_w)


def unit_weights(n, src, dst, w):
    return n, src, dst, np.ones_like(w)


def largest_component_queries(n, src, dst, n_q, seed=0):
    """Sample query endpoints biased to the largest connected component
    (mirrors the paper's random 1000-query workloads)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, comp = csg.connected_components(adj, directed=False)
    counts = np.bincount(comp)
    big = np.flatnonzero(comp == counts.argmax())
    s = rng.choice(big, n_q)
    t = rng.choice(big, n_q)
    return s.astype(np.int32), t.astype(np.int32)
