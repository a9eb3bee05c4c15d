"""Reference oracles + paper baselines (host-side, exact).

* ``dijkstra_oracle``: scipy multi-source exact distances — the ground
  truth every index answer is checked against.
* ``bidijkstra``: the paper's IM-DIJ baseline (Table 8) — textbook
  bidirectional Dijkstra with the standard top(F)+top(R) >= μ stop rule.
* ``dijkstra_p2p``: plain early-exit Dijkstra (online search baseline).
"""
from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csg


def build_csr(n, src, dst, w):
    # scipy COO->CSR SUMS duplicate entries; parallel edges must keep the
    # MIN weight instead — dedup first.
    key = np.asarray(src, np.int64) * n + np.asarray(dst, np.int64)
    order = np.lexsort((np.asarray(w), key))
    key_s, w_s = key[order], np.asarray(w, np.float64)[order]
    first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    key_u, w_u = key_s[first], w_s[first]
    return sp.csr_matrix((w_u, (key_u // n, key_u % n)), shape=(n, n))


def dijkstra_oracle(n, src, dst, w, sources):
    """Exact distances from each source to all vertices. [S, n] float64."""
    mat = build_csr(n, src, dst, w)
    return csg.dijkstra(mat, directed=True, indices=np.asarray(sources))


def _adj_lists(n, src, dst, w):
    order = np.argsort(src, kind="stable")
    s, d, ww = np.asarray(src)[order], np.asarray(dst)[order], np.asarray(w)[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    return np.cumsum(indptr), d, ww


def dijkstra_p2p(n, src, dst, w, s, t):
    """Early-exit unidirectional Dijkstra."""
    indptr, nbr, ww = _adj_lists(n, src, dst, w)
    dist = {s: 0.0}
    pq = [(0.0, s)]
    done = set()
    while pq:
        du, u = heapq.heappop(pq)
        if u in done:
            continue
        if u == t:
            return du
        done.add(u)
        for e in range(indptr[u], indptr[u + 1]):
            v, alt = int(nbr[e]), du + float(ww[e])
            if alt < dist.get(v, np.inf):
                dist[v] = alt
                heapq.heappush(pq, (alt, v))
    return np.inf


def bidijkstra(n, src, dst, w, s, t):
    """IM-DIJ baseline: bidirectional Dijkstra (undirected edge lists)."""
    if s == t:
        return 0.0
    indptr, nbr, ww = _adj_lists(n, src, dst, w)
    dist = [{s: 0.0}, {t: 0.0}]
    done = [set(), set()]
    pq = [[(0.0, s)], [(0.0, t)]]
    mu = np.inf
    while pq[0] and pq[1]:
        if pq[0][0][0] + pq[1][0][0] >= mu:
            break
        side = 0 if pq[0][0][0] <= pq[1][0][0] else 1
        du, u = heapq.heappop(pq[side])
        if u in done[side]:
            continue
        done[side].add(u)
        for e in range(indptr[u], indptr[u + 1]):
            v, alt = int(nbr[e]), du + float(ww[e])
            if alt < dist[side].get(v, np.inf):
                dist[side][v] = alt
                heapq.heappush(pq[side], (alt, v))
            if v in dist[1 - side]:
                mu = min(mu, alt + dist[1 - side][v])
    return mu


def host_meet(row_s, d_s, row_t, d_t, n):
    """Host Equation 1 over two sorted label rows: returns
    ``(mu, meet_id)`` with ``meet_id = -1`` when the labels share no
    finite ancestor. Shared by the undirected and directed host path
    oracles so their tie rule (argmin over the s-row order, matching
    the device engine) cannot drift apart."""
    pos = np.minimum(np.searchsorted(row_t, row_s), len(row_t) - 1)
    hit = (row_t[pos] == row_s) & (row_s < n)
    tot = np.where(hit, d_s + d_t[pos], np.inf)
    j = int(np.argmin(tot))
    return float(tot[j]), (int(row_s[j]) if hit[j] else -1)


def sorted_adjacency(n, src, dst, w, via):
    """Src-sorted CSR-ish adjacency ``(indptr, dst, w, via)`` — the
    representation both host path oracles cache per index."""
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, np.asarray(src)[order] + 1, 1)
    return (np.cumsum(indptr), np.asarray(dst)[order],
            np.asarray(w)[order], np.asarray(via)[order])


def seeded_sssp(seeds, indptr, nbr, w, via):
    """Dijkstra from a multi-source seed dict over a sorted adjacency.
    Returns ``(dist dict, parent dict)`` with ``parent[v] = (u, via)``
    (``(None, -1)`` at seeds) — the label-seeded core search both host
    path oracles unwind."""
    dd, par = dict(seeds), {u: (None, -1) for u in seeds}
    pq = [(d, u) for u, d in seeds.items()]
    heapq.heapify(pq)
    done = set()
    while pq:
        du, u = heapq.heappop(pq)
        if u in done:
            continue
        done.add(u)
        for e in range(indptr[u], indptr[u + 1]):
            v2, alt = int(nbr[e]), du + float(w[e])
            if alt < dd.get(v2, np.inf):
                dd[v2] = alt
                par[v2] = (u, int(via[e]))
                heapq.heappush(pq, (alt, v2))
    return dd, par


def bfs_hops(n, src, dst, s, t):
    """Unweighted BFS hop distance (sanity baseline)."""
    indptr, nbr, _ = _adj_lists(n, src, dst, np.ones(len(src)))
    from collections import deque
    seen = {s: 0}
    q = deque([s])
    while q:
        u = q.popleft()
        if u == t:
            return seen[u]
        for e in range(indptr[u], indptr[u + 1]):
            v = int(nbr[e])
            if v not in seen:
                seen[v] = seen[u] + 1
                q.append(v)
    return np.inf
