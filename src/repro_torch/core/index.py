"""ISLabelIndex — the public API of the port (the counterpart of
``repro.core.index``).

  idx = ISLabelIndex.build(n, src, dst, w, IndexConfig())   # on "cuda"
  d = idx.query(s_batch, t_batch)           # exact distances, batched
  dist, paths, ok = idx.shortest_paths(s_batch, t_batch)   # §8.1, batched
  path = idx.shortest_path(s, t)            # §8.1 host oracle
  idx.save(dir); ISLabelIndex.load(dir)
  idx.insert_vertex(u, nbrs, ws) / idx.delete_vertex(u)   # §8.3

The entry points run on the card unless the caller passes
``device="cpu"``; without CUDA they raise. ``save`` writes the same
``index.npz`` + ``meta.json`` as ``repro``, so an index built by either
package loads and answers in the other. The label codec
(``cfg.label_dtype``) travels in ``meta.json`` beside the fp32 planes,
and the engine encodes them again on load (and after every mutation),
so a compressed index crosses too. Batched paths run through
``repro_torch.paths.PathEngine``; the scalar path oracle and the §8.3
mutators are host code, as in ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.config import BuildStats, IndexConfig
from repro_torch.core.hierarchy import Hierarchy, build_hierarchy
from repro_torch.core.labeling import build_labels
from repro_torch.core.query import QueryEngine
from repro_torch.kernels.backend import resolve_device

# backend names of ``repro`` that the port does not have, and back
_FROM_REPRO_BACKEND = {"pallas": "auto", "interpret": "auto"}
_TO_REPRO_BACKEND = {"cuda": "auto"}
ARRAYS = ("level", "lbl_ids", "lbl_d", "lbl_pred", "up_ids", "up_w",
          "up_via", "core_src", "core_dst", "core_w", "core_via")


def _batch(x):
    """Endpoint ids as a 1-D batch: a tensor stays where it lies."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    return np.atleast_1d(x)


@dataclasses.dataclass
class ISLabelIndex:
    n: int
    k: int
    cfg: IndexConfig
    level: np.ndarray            # int32[n]
    # device label arrays [n+1, l_cap]
    lbl_ids: torch.Tensor
    lbl_d: torch.Tensor
    lbl_pred: torch.Tensor
    # up-edge matrix (host, for paths/updates) [n+1, d_cap]
    up_ids: np.ndarray
    up_w: np.ndarray
    up_via: np.ndarray
    # core graph: global-id COO (host) + the engine's local-index copy
    core_ids: np.ndarray         # int32[n_core]
    core_pos_host: np.ndarray    # int32[n+1]
    core_src: np.ndarray
    core_dst: np.ndarray
    core_w: np.ndarray
    core_via: np.ndarray
    engine: QueryEngine
    stats: BuildStats
    # lazy caches of the host oracle and the path lane; dropped by
    # _install_labels on every in-place mutation
    _host_labels: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _core_adj: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _paths: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.lbl_ids.device

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(n, src, dst, w, cfg: IndexConfig = IndexConfig(), device=None,
              perms=None) -> "ISLabelIndex":
        """Build on ``device`` ("cuda" when None). ``perms`` is the MIS
        permutation source (``core/mis.py``): one permutation of [0, n)
        per level; the default draws ``torch.randperm`` from
        ``cfg.seed``."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        syncs0 = hsync.sync_count()
        hier = build_hierarchy(n, src, dst, w, cfg, dev, perms)
        t1 = time.perf_counter()
        # the labeler ends on a blocking read of its overflow flags, which
        # waits for every chunk: t2 is the labels' completion time
        lbl_ids, lbl_d, lbl_pred = build_labels(hier, cfg, dev)
        t2 = time.perf_counter()
        idx = ISLabelIndex._assemble(n, hier, lbl_ids, lbl_d, lbl_pred, cfg,
                                     m_input=len(src))
        idx.stats.build_seconds = time.perf_counter() - t0
        idx.stats.peel_seconds = t1 - t0
        idx.stats.label_seconds = t2 - t1
        idx.stats.host_syncs = hsync.sync_count() - syncs0
        if dev.type == "cuda":
            idx.stats.peak_device_bytes = torch.cuda.max_memory_allocated(dev)
        return idx

    @staticmethod
    def _assemble(n, hier: Hierarchy, lbl_ids, lbl_d, lbl_pred,
                  cfg: IndexConfig, m_input: int) -> "ISLabelIndex":
        dev = lbl_ids.device
        core_ids = np.flatnonzero(hier.level == hier.k).astype(np.int32)
        n_core = len(core_ids)
        core_pos = np.full(n + 1, n_core, np.int32)
        core_pos[core_ids] = np.arange(n_core, dtype=np.int32)
        engine = QueryEngine(
            lbl_ids, lbl_d, hsync.upload(core_pos, dev),
            (core_pos[hier.core_src], core_pos[hier.core_dst],
             np.asarray(hier.core_w, np.float32)),
            n=n, n_core=n_core, max_rounds=cfg.max_relax_rounds,
            backend=cfg.query_backend, query_chunk=cfg.query_chunk,
            label_dtype=cfg.label_dtype)
        entries = int(hsync.host_read(
            (lbl_ids[:n] < n).sum(dtype=torch.int64)))
        stats = BuildStats(
            n=n, m=m_input, k=hier.k, n_core=n_core,
            m_core=len(hier.core_src), level_sizes=hier.level_sizes,
            graph_sizes=hier.graph_sizes, label_entries=entries,
            label_bytes=entries * 8, mis_rounds=hier.mis_rounds,
            peel_loop_syncs=hier.host_syncs, peel_iters=hier.peel_iters)
        return ISLabelIndex(
            n=n, k=hier.k, cfg=cfg, level=hier.level, lbl_ids=lbl_ids,
            lbl_d=lbl_d, lbl_pred=lbl_pred, up_ids=hier.up_ids, up_w=hier.up_w,
            up_via=hier.up_via, core_ids=core_ids, core_pos_host=core_pos,
            core_src=hier.core_src, core_dst=hier.core_dst, core_w=hier.core_w,
            core_via=hier.core_via, engine=engine, stats=stats)

    # ------------------------------------------------------------------ query
    def query(self, s, t):
        """Exact batched distances (float32[Q] on the index's device)."""
        return self.engine.query(s, t)

    def query_host(self, s, t) -> np.ndarray:
        """``query`` read to the host (one ``host_read`` of the answers).
        Endpoints may be numpy arrays, scalars or tensors on any device;
        a CUDA tensor goes to the query as it is."""
        return hsync.host_read(self.query(_batch(s), _batch(t)))

    def query_types(self, s, t):
        """§5.2 endpoint classes (``QueryEngine.classify``) on the host."""
        return self.engine.classify(s, t, self.level, self.k)

    # ------------------------------------------------------------- §8.1 paths
    def _label_host(self):
        """Cached host copies of the label planes (ids, d, pred): one
        read of the device planes per index generation."""
        if self._host_labels is None:
            self._host_labels = hsync.host_read(
                (self.lbl_ids, self.lbl_d, self.lbl_pred))
        return self._host_labels

    def _core_adjacency(self):
        """Cached src-sorted core adjacency (indptr, dst, w, via)."""
        if self._core_adj is None:
            from repro_torch.core.ref import sorted_adjacency
            self._core_adj = sorted_adjacency(
                self.n, self.core_src, self.core_dst, self.core_w,
                self.core_via)
        return self._core_adj

    def path_engine(self):
        """Batched path reconstruction on the index's device
        (``repro_torch.paths``). Memoized per index generation —
        in-place mutations drop it alongside the query engine."""
        if self._paths is None:
            from repro_torch.paths import PathEngine
            self._paths = PathEngine.from_index(self)
        return self._paths

    def shortest_paths(self, s, t, hop_cap: int = 256,
                       backend: str | None = None):
        """Batched shortest paths through ``PathEngine``. Returns
        ``(dist float32[Q], list of vertex lists, ok bool[Q])``; hop_cap
        escalates automatically on overflow."""
        return self.path_engine().paths(s, t, hop_cap=hop_cap,
                                        backend=backend)

    def _up_slot(self, v: int, u: int):
        row = self.up_ids[v]
        slots = np.flatnonzero(row == u)
        return int(slots[0]) if len(slots) else -1

    def _expand_edge(self, a: int, b: int, via: int) -> list[int]:
        """Expand an (augmenting) edge into original-graph vertices
        [a..b) — recursion over the `via` bookkeeping (§8.1)."""
        if via < 0:
            return [a]
        # via c was removed below both a and b; its up-adjacency contains both
        sa = self._up_slot(via, a)
        sb = self._up_slot(via, b)
        if sa < 0 or sb < 0:     # should not happen on a consistent index
            return [a]
        left = self._expand_edge(a, via, int(self.up_via[via, sa]))
        right = self._expand_edge(via, b, int(self.up_via[via, sb]))
        return left + right

    def _label_path(self, v: int, x: int) -> list[int]:
        """Path v -> x following the label pred chain (x an ancestor of v)."""
        if v == x:
            return [v]
        ids_h, _, pred_h = self._label_host()
        row = ids_h[v]
        j = np.searchsorted(row, x)
        if j >= len(row) or row[j] != x:
            raise ValueError(f"{x} is not an ancestor of {v}")
        u = int(pred_h[v][j])
        if u < 0:
            raise ValueError("inconsistent pred chain")
        slot = self._up_slot(v, u)
        hop = self._expand_edge(v, u, int(self.up_via[v, slot]))
        return hop + self._label_path(u, x)

    def shortest_path(self, s: int, t: int):
        """Return (distance, [s..t] vertex list in the original graph)."""
        dist = float(self.query_host([s], [t])[0])
        if not np.isfinite(dist):
            return dist, []
        # meeting vertex: best label-intersection ancestor, or best core
        # pair — host-side over the cached label copies (Equation 1)
        from repro_torch.core.ref import host_meet
        ids_h, d_h, _ = self._label_host()
        mu, w = host_meet(ids_h[s], d_h[s], ids_h[t], d_h[t], self.n)
        if mu <= dist + 1e-6 and w >= 0:
            left = self._label_path(s, w)
            right = self._label_path(t, w)
            return dist, left + right[::-1][1:]
        # path passes through the core: host Dijkstra on G_k with label seeds
        return dist, self._core_path(s, t, dist)

    def _core_path(self, s: int, t: int, dist: float):
        from repro_torch.core.ref import seeded_sssp
        ids_h, d_h, _ = self._label_host()
        seeds = {}
        for side, v in ((0, s), (1, t)):
            row_i, row_d = ids_h[v], d_h[v]
            sd = {}
            for i, u in enumerate(row_i):
                u = int(u)
                if u < self.n and self.level[u] == self.k:
                    sd[u] = float(row_d[i])
            seeds[side] = sd
        # adjacency of core in global ids (cached, src-sorted);
        # undirected core: the same adjacency serves both directions
        adj = self._core_adjacency()
        ds, ps = seeded_sssp(seeds[0], *adj)
        dt, pt = seeded_sssp(seeds[1], *adj)
        meet = min((ds.get(u, np.inf) + dt.get(u, np.inf), u) for u in ds)[1]

        def unwind(par, v, side):
            out = [v]
            while par[v][0] is not None:
                u, via = par[v]
                # expand (u -> v) into original vertices, then continue from u
                out = self._expand_edge(u, v, via) + out
                v = u
            # label path from the query endpoint to the seed vertex
            endpoint = s if side == 0 else t
            head = self._label_path(endpoint, v)
            return head[:-1] + out
        left = unwind(ps, meet, 0)
        right = unwind(pt, meet, 1)
        return left + right[::-1][1:]

    # ------------------------------------------------------ §8.3 maintenance
    def _descendants(self, v: int):
        """Vertices whose label contains v (BFS over reversed up-edges)."""
        rev = {}
        nz = np.argwhere(self.up_ids[:self.n] < self.n)
        for a, slot in nz:
            rev.setdefault(int(self.up_ids[a, slot]), []).append(int(a))
        out, frontier = set(), [v]
        while frontier:
            u = frontier.pop()
            for c in rev.get(u, []):
                if c not in out:
                    out.add(c)
                    frontier.append(c)
        return out

    def insert_vertex(self, u: int, nbrs, ws) -> np.ndarray:
        """§8.3 lazy insert: u joins G_k; label entries (u, d) pushed to the
        descendants of its non-core neighbors. Host-side, rebuild-free.
        Returns the touched label rows (sorted vertex ids)."""
        ids_h, d_h, pred_h = hsync.host_read(
            (self.lbl_ids, self.lbl_d, self.lbl_pred))   # writable copies
        rows = apply_insert_host(self, ids_h, d_h, pred_h, u, nbrs, ws)
        self._refresh_device(ids_h, d_h, pred_h)
        return rows

    def delete_vertex(self, u: int) -> np.ndarray:
        """§8.3 lazy delete: drop u's core edges and its entries in the
        labels of all descendants. Returns the touched label rows."""
        ids_h, d_h, pred_h = hsync.host_read(
            (self.lbl_ids, self.lbl_d, self.lbl_pred))   # writable copies
        rows = apply_delete_host(self, ids_h, d_h, pred_h, u)
        self._refresh_device(ids_h, d_h, pred_h)
        return rows

    def _refresh_device(self, ids_h, d_h, pred_h):
        """Upload mutated host label arrays and rebuild the engine. The
        host copies seed the host-label cache (they ARE the new labels —
        no device round trip on the next oracle call)."""
        dev = self.device
        self._install_labels(hsync.upload(ids_h, dev), hsync.upload(d_h, dev),
                             hsync.upload(pred_h, dev),
                             host=(ids_h, d_h, pred_h))

    def _install_labels(self, lbl_ids, lbl_d, lbl_pred, host=None):
        """Install new device label planes and rebuild the core maps and
        the query engine (which encodes a delta16 index again). ``host``
        (matching host copies) seeds the host-label cache; the
        core-adjacency and path-engine caches are always dropped — the
        core edge arrays may have changed alongside the labels."""
        self.lbl_ids = lbl_ids
        self.lbl_d = lbl_d
        self.lbl_pred = lbl_pred
        self._host_labels = host
        self._core_adj = None
        self._paths = None
        core_ids = np.flatnonzero(self.level == self.k).astype(np.int32)
        n_core = len(core_ids)
        core_pos = np.full(self.n + 1, n_core, np.int32)
        core_pos[core_ids] = np.arange(n_core, dtype=np.int32)
        self.core_ids, self.core_pos_host = core_ids, core_pos
        self.engine = QueryEngine(
            lbl_ids, lbl_d, hsync.upload(core_pos, lbl_ids.device),
            (core_pos[self.core_src], core_pos[self.core_dst],
             np.asarray(self.core_w, np.float32)),
            n=self.n, n_core=n_core, max_rounds=self.cfg.max_relax_rounds,
            backend=self.cfg.query_backend, query_chunk=self.cfg.query_chunk,
            label_dtype=self.cfg.label_dtype)

    # ------------------------------------------------------------------ io
    def save(self, path):
        """Write ``index.npz`` + ``meta.json`` in ``repro``'s format (the
        query backend in ``repro``'s vocabulary)."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        lbl_ids, lbl_d, lbl_pred = hsync.host_read(
            (self.lbl_ids, self.lbl_d, self.lbl_pred))
        np.savez_compressed(
            p / "index.npz", level=self.level, lbl_ids=lbl_ids, lbl_d=lbl_d,
            lbl_pred=lbl_pred, up_ids=self.up_ids, up_w=self.up_w,
            up_via=self.up_via, core_src=self.core_src,
            core_dst=self.core_dst, core_w=self.core_w,
            core_via=self.core_via)
        cfg = dataclasses.asdict(self.cfg)
        cfg["query_backend"] = _TO_REPRO_BACKEND.get(cfg["query_backend"],
                                                     cfg["query_backend"])
        meta = {"n": self.n, "k": self.k, "cfg": cfg,
                "stats": dataclasses.asdict(self.stats)}
        (p / "meta.json").write_text(json.dumps(meta))

    @staticmethod
    def from_arrays(meta: dict, arrays: dict, device=None) -> "ISLabelIndex":
        """The port's index from the ``meta.json`` dict and the numpy
        arrays of ``index.npz`` (as written by either package)."""
        dev = resolve_device(device)
        cfg_d = dict(meta["cfg"])
        cfg_d["query_backend"] = _FROM_REPRO_BACKEND.get(
            cfg_d["query_backend"], cfg_d["query_backend"])
        cfg = IndexConfig(**cfg_d)
        z = arrays
        hier = Hierarchy(
            n=meta["n"], k=meta["k"], level=np.asarray(z["level"]),
            up_ids=np.asarray(z["up_ids"]), up_w=np.asarray(z["up_w"]),
            up_via=np.asarray(z["up_via"]), core_src=np.asarray(z["core_src"]),
            core_dst=np.asarray(z["core_dst"]), core_w=np.asarray(z["core_w"]),
            core_via=np.asarray(z["core_via"]), level_sizes=[],
            graph_sizes=[], mis_rounds=[])
        idx = ISLabelIndex._assemble(
            meta["n"], hier, hsync.upload(z["lbl_ids"], dev),
            hsync.upload(z["lbl_d"], dev), hsync.upload(z["lbl_pred"], dev),
            cfg, m_input=meta["stats"]["m"])
        idx.stats = BuildStats(**meta["stats"])
        return idx

    @staticmethod
    def load(path, device=None) -> "ISLabelIndex":
        p = Path(path)
        meta = json.loads((p / "meta.json").read_text())
        with np.load(p / "index.npz") as z:
            arrays = {name: z[name] for name in ARRAYS}
        return ISLabelIndex.from_arrays(meta, arrays, device)


# ------------------------------------------------------------------------
# §8.3 host mutators (copied from ``repro.core.index``, numpy only), for
# ISLabelIndex (in place) and, in later slices of the port, the versioned
# serving store and sharded indexes. ``st`` is any object carrying the
# graph structure the lazy update rules read and rewrite:
#   n, k, level (mutated), up_ids, up_w (read),
#   core_src/core_dst/core_w/core_via, core_ids (rebound, never mutated).
# The label arrays are writable host copies, mutated in place. Both
# functions return the touched label rows (sorted int64 vertex ids) so
# callers can propagate the change incrementally.


def _children_of_host(st, v):
    """(child, w) pairs over up-edges into v — label(child) merges
    label(v) + w, so a pushed entry relaxes down the same edges."""
    out = []
    rows, slots = np.nonzero(st.up_ids[:st.n] == v)
    for r, sl in zip(rows, slots):
        out.append((int(r), float(st.up_w[r, sl])))
    return out


def _set_label_entry_host(st, ids_h, d_h, pred_h, v, u, d, pred,
                          touched) -> bool:
    row = ids_h[v]
    j = np.searchsorted(row, u)
    if j < row.shape[0] and row[j] == u:
        if d_h[v, j] <= d:
            return False
        d_h[v, j] = d
        pred_h[v, j] = pred
        touched.add(int(v))
        return True
    if row[-1] < st.n:
        raise RuntimeError("label row full: raise l_cap and rebuild")
    ids_h[v] = np.insert(row, j, u)[:-1]
    d_h[v] = np.insert(d_h[v], j, d)[:-1]
    pred_h[v] = np.insert(pred_h[v], j, pred)[:-1]
    touched.add(int(v))
    return True


def _push_entry_host(st, ids_h, d_h, pred_h, v, u, d, pred, touched):
    """Insert/improve (u, d) in label(v), then relax v's descendants."""
    if not _set_label_entry_host(st, ids_h, d_h, pred_h, v, u, d, pred,
                                 touched):
        return
    for child, wc in _children_of_host(st, v):
        _push_entry_host(st, ids_h, d_h, pred_h, child, u, d + wc, v, touched)


def apply_insert_host(st, ids_h, d_h, pred_h, u: int, nbrs, ws,
                      touched: set | None = None) -> np.ndarray:
    """§8.3 lazy insert on host label copies; returns touched rows."""
    if u >= st.n:
        raise ValueError("grow n before inserting (id must be preallocated)")
    touched = set() if touched is None else touched
    st.level[u] = st.k
    new_core_edges = ([], [], [])
    # u itself becomes a core vertex with self label
    _set_label_entry_host(st, ids_h, d_h, pred_h, u, u, 0.0, -1, touched)
    for v, wv in zip(nbrs, ws):
        v = int(v)
        if st.level[v] == st.k:
            new_core_edges[0].extend([u, v])
            new_core_edges[1].extend([v, u])
            new_core_edges[2].extend([float(wv), float(wv)])
        else:
            # add (u, w) to label(v) and propagate to v's descendants
            _push_entry_host(st, ids_h, d_h, pred_h, v, u, float(wv), v,
                             touched)
    if new_core_edges[0]:
        st.core_src = np.concatenate(
            [st.core_src, np.asarray(new_core_edges[0], np.int32)])
        st.core_dst = np.concatenate(
            [st.core_dst, np.asarray(new_core_edges[1], np.int32)])
        st.core_w = np.concatenate(
            [st.core_w, np.asarray(new_core_edges[2], np.float32)])
        st.core_via = np.concatenate(
            [st.core_via, np.full(len(new_core_edges[0]), -1, np.int32)])
    if st.level[u] == st.k and u not in set(st.core_ids.tolist()):
        st.core_ids = np.concatenate(
            [st.core_ids, np.asarray([u], np.int32)])
    return np.asarray(sorted(touched), np.int64)


def apply_delete_host(st, ids_h, d_h, pred_h, u: int,
                      touched: set | None = None) -> np.ndarray:
    """§8.3 lazy delete on host label copies; returns touched rows.

    Exact inverse of ``apply_insert_host`` when u was previously
    inserted (every mutated entry carries ancestor id u); conservative
    — never under-reports a distance — for build-time vertices."""
    touched = set() if touched is None else touched
    keep = (st.core_src != u) & (st.core_dst != u)
    st.core_src, st.core_dst = st.core_src[keep], st.core_dst[keep]
    st.core_w, st.core_via = st.core_w[keep], st.core_via[keep]
    rows = np.unique(np.nonzero(ids_h[:st.n] == u)[0])
    for v in rows:
        j = np.searchsorted(ids_h[v], u)
        ids_h[v] = np.concatenate([np.delete(ids_h[v], j), [st.n]])
        d_h[v] = np.concatenate([np.delete(d_h[v], j), [np.inf]])
        pred_h[v] = np.concatenate([np.delete(pred_h[v], j), [-1]])
        touched.add(int(v))
    st.level[u] = st.k  # orphaned; queries fall back to core/∞
    return np.asarray(sorted(touched), np.int64)
