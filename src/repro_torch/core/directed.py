"""Directed-graph IS-LABEL (paper §8.2), the counterpart of
``repro.core.directed``.

Same vertex hierarchy (independence ignores direction) but distance
preservation creates an augmenting edge (u, w) only for directed 2-paths
u -> v -> w through a removed v. Two label families per vertex:
*out-labels* over out-ancestors (edges low->high level) and *in-labels*
over in-ancestors; a query (s, t) intersects out(s) with in(t) and the
core search relaxes forward from s-seeds and backward from t-seeds.

The in-label machinery is exactly the out-label machinery on the
reversed graph, so ``build_labels`` is reused verbatim with a reversed
``Hierarchy`` view. This module also answers *reachability* (dist <
inf), the paper's closing claim.

As in ``repro``, no kernel runs here: stage 1 is the plain
``label_intersect_mu`` and stage 2 one scatter-min relaxation per
direction (``_relax_one``), whose rounds run as a host loop with the
exit test on the device (``dispatch.relax_rounds``), at most n_core
rounds. The level loop keeps every buffer on the device and reads one
stat vector a level (the undirected builder's pattern,
``core/hierarchy.py``); the MIS permutation comes from the permutation
source (``core/mis.py``), one per level.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.config import IndexConfig
from repro_torch.core.dispatch import relax_rounds, seed_rows
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.index import _batch
from repro_torch.core.labeling import build_labels
from repro_torch.core.labels import row_index
from repro_torch.core.mis import MISState, torch_permutations
from repro_torch.core.query import QueryEngine, label_intersect_mu
from repro_torch.graphs import csr as gcsr
from repro_torch.kernels.backend import resolve_device

__all__ = ["DiISLabelIndex", "peel_level_directed"]

INF = float("inf")


def peel_level_directed(src, dst, w, via, in_is, n: int, d_cap: int,
                        aug_cap: int):
    """One directed hierarchy level after its independent set ``in_is``
    (chosen over the union in+out adjacency) is known: the out- and
    in-neighbour matrices, and augmenting pairs IN(v) x OUT(v).

    Returns ``(o_src, o_dst, o_w, o_via, out_ids, out_w, out_via,
    in_ids, in_w, in_via, n_unique, n_is, n_is_edges)``."""
    e_cap = src.shape[0]
    valid = src < n
    out_ids, out_w, out_via, _ = gcsr.neighbor_matrix(
        gcsr.EdgeList(src, dst, w, via, n_nodes=n), d_cap)
    in_ids, in_w, in_via, _ = gcsr.neighbor_matrix(
        gcsr.EdgeList(dst, src, w, via, n_nodes=n), d_cap)

    # edges OUT of IS vertices: (v -> u); pair with v's IN neighbours
    src_c = torch.where(valid, src, 0).long()
    dst_c = torch.where(valid, dst, 0).long()
    is_out = in_is[src_c] & valid
    a_v, a_u, a_w = gcsr.compact(is_out, aug_cap, (src, n), (dst, n),
                                 (w, INF))
    n_is_edges = is_out.sum(dtype=torch.int32)

    av = a_v.long()
    p_ids = in_ids[av]                        # in-neighbours of v [aug, d]
    p_w = in_w[av]
    au = a_u[:, None]
    pair_ok = (p_ids < n) & (p_ids != au) & (au < n)
    pair_src = torch.where(pair_ok, p_ids, n)                    # win -> u
    pair_dst = torch.where(pair_ok, au.expand_as(p_ids), n)
    pair_w = torch.where(pair_ok, p_w + a_w[:, None], INF)
    pair_via = torch.where(pair_ok, a_v[:, None].expand_as(p_ids), -1)

    keep = valid & ~(in_is[src_c] | in_is[dst_c])
    all_src = torch.cat([torch.where(keep, src, n), pair_src.reshape(-1)])
    all_dst = torch.cat([torch.where(keep, dst, n), pair_dst.reshape(-1)])
    all_w = torch.cat([torch.where(keep, w, INF), pair_w.reshape(-1)])
    all_via = torch.cat([torch.where(keep, via, -1), pair_via.reshape(-1)])
    o_src, o_dst, o_w, o_via, n_unique = gcsr.dedup_min_edges(
        all_src, all_dst, all_w, all_via, n, e_cap)
    n_is = in_is.sum(dtype=torch.int32)
    return (o_src, o_dst, o_w, o_via, out_ids, out_w, out_via, in_ids,
            in_w, in_via, n_unique, n_is, n_is_edges)


def _relax_one(seed, es, ed, ew, n_core: int):
    """One-directional Bellman-Ford on the (possibly reversed) core:
    synchronous scatter-min rounds to the fixed point, at most n_core
    of them. Returns (d, rounds int32 device scalar)."""
    q = seed.shape[0]
    src = es.long()
    dst = ed.long()[None, :].expand(q, -1)

    def round_(d):
        return (d.scatter_reduce(1, dst, d[:, src] + ew[None, :], "amin",
                                 include_self=True),)

    (d,), rounds = relax_rounds(round_, (seed,), n_core)
    return d, rounds


@dataclasses.dataclass
class DiISLabelIndex:
    n: int
    k: int
    cfg: IndexConfig
    level: np.ndarray
    out_lbl: tuple      # (ids, d, pred) device tensors (out-ancestors)
    in_lbl: tuple
    core_pos: np.ndarray
    core_edges: tuple   # fwd local (src, dst, w) device tensors
    n_core: int
    # host state for §8.1/§8.2 path reconstruction: the out/in
    # up-adjacency matrices ((ids, w, via) triples) and the core COO in
    # global ids with its via bookkeeping
    up_out: tuple = None
    up_in: tuple = None
    core_host: tuple = None     # (src, dst, w, via) global ids
    # lazy per-call-cost hoists (host label copies, sorted core
    # adjacencies, the device core map) — the directed index has no
    # in-place mutators, so these never need invalidation
    _host_lbl: dict = dataclasses.field(default=None, init=False,
                                        repr=False, compare=False)
    _core_adj: dict = dataclasses.field(default=None, init=False,
                                        repr=False, compare=False)
    _cpos: torch.Tensor = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)
    # relaxation rounds of the last query (forward, backward), device
    # scalars; None when it had no core search
    _last_rounds: tuple = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.out_lbl[0].device

    @staticmethod
    def build(n, src, dst, w, cfg: IndexConfig = IndexConfig(), device=None,
              perms=None) -> "DiISLabelIndex":
        """Build on ``device`` ("cuda" when None). ``perms`` is the MIS
        permutation source, as for ``ISLabelIndex.build``."""
        dev = resolve_device(device)
        if perms is None:
            perms = torch_permutations(cfg.seed, n)
        m0 = len(src)
        e_cap, aug_cap = cfg.e_cap(m0), cfg.aug_cap(m0)
        g = gcsr.from_host_edges(src, dst, w, n, e_cap, device=dev)
        cur = (g.src, g.dst, g.weight, g.via)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        level_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        ups = {d: [torch.full((n + 1, cfg.d_cap), n, dtype=torch.int32,
                              device=dev),
                   torch.full((n + 1, cfg.d_cap), INF, dtype=torch.float32,
                              device=dev),
                   torch.full((n + 1, cfg.d_cap), -1, dtype=torch.int32,
                              device=dev)]
               for d in ("out", "in")}
        no_row = torch.zeros(1, dtype=torch.bool, device=dev)
        sizes = [n + m0]
        removed = 0
        k = 1
        guess = 16
        for i in range(1, cfg.k_max + 1):
            perm = hsync.upload(next(perms), dev, torch.int32)
            c_src, c_dst = cur[0], cur[1]
            valid = c_src < n
            # symmetrized view for the MIS (independence ignores direction)
            mis = MISState.start(torch.cat([c_src, c_dst]),
                                 torch.cat([c_dst, c_src]),
                                 torch.cat([valid, valid]), active, perm, n,
                                 cfg.d_cap)
            budget = guess
            while True:
                mis.advance(budget)
                out = peel_level_directed(*cur, mis.in_is, n, cfg.d_cap,
                                          aug_cap)
                stats = torch.stack([
                    out[11], out[10], out[12], mis.rounds,
                    mis.pool_left().to(torch.int32),
                    (out[0] < n).sum(dtype=torch.int32)])
                # the level's blocking read: stop-rule scalars, overflow
                # flags and the MIS fixed-point flag
                n_is, n_unique, n_is_e, rounds, left, n_edges = (
                    int(x) for x in hsync.host_read(stats))
                if not left:
                    break
                budget = 8
            guess = max(8, 2 * rounds)
            if n_unique > e_cap or n_is_e > aug_cap:
                raise RuntimeError("capacity overflow; raise e_cap_factor")
            if n_is == 0:
                k = i
                break
            in_is = mis.in_is
            rec = torch.cat([in_is, no_row])[:, None]
            level_dev.masked_fill_(in_is, i)
            for key, new in (("out", out[4:7]), ("in", out[7:10])):
                ups[key] = [torch.where(rec, a, b)
                            for a, b in zip(new, ups[key])]
            active &= ~in_is
            cur = out[:4]
            k = i + 1
            removed += n_is
            new_size = n_edges + n - removed
            sizes.append(new_size)
            if cfg.k_force:
                if k >= cfg.k_force:
                    break
            elif new_size > cfg.sigma * sizes[-2]:
                break

        level, *rest = hsync.host_read(
            (level_dev, *ups["out"], *ups["in"], *cur))
        level[level == 0] = k
        up_out, up_in = tuple(rest[0:3]), tuple(rest[3:6])
        c_src, c_dst, c_w, c_via = rest[6:10]
        mask = c_src < n
        ce_s, ce_d, ce_w, ce_v = (c_src[mask], c_dst[mask], c_w[mask],
                                  c_via[mask])

        def labels_for(up):
            hier = Hierarchy(
                n=n, k=k, level=level, up_ids=up[0], up_w=up[1],
                up_via=up[2], core_src=ce_s, core_dst=ce_d, core_w=ce_w,
                core_via=np.zeros_like(ce_s), level_sizes=[],
                graph_sizes=[], mis_rounds=[])
            return build_labels(hier, cfg, dev)

        out_lbl = labels_for(up_out)
        in_lbl = labels_for(up_in)
        core_ids = np.flatnonzero(level == k).astype(np.int32)
        core_pos = np.full(n + 1, len(core_ids), np.int32)
        core_pos[core_ids] = np.arange(len(core_ids), dtype=np.int32)
        return DiISLabelIndex(
            n=n, k=k, cfg=cfg, level=level, out_lbl=out_lbl, in_lbl=in_lbl,
            core_pos=core_pos,
            core_edges=(hsync.upload(core_pos[ce_s], dev),
                        hsync.upload(core_pos[ce_d], dev),
                        hsync.upload(ce_w, dev)),
            n_core=len(core_ids), up_out=up_out, up_in=up_in,
            core_host=(ce_s, ce_d, ce_w, ce_v))

    # endpoint ids as int32 on the index's device, as the engine
    # uploads them
    _index = QueryEngine._index

    def _seed(self, ids, d):
        """[Q, n_core+1] seed vector of one side's label rows."""
        if self._cpos is None:
            self._cpos = hsync.upload(self.core_pos, self.device)
        cpos = self._cpos[ids.clamp(max=self.n).long()].long()
        return seed_rows((cpos, torch.where(ids < self.n, d, INF)),
                         self.n_core + 1)

    def query(self, s, t):
        """Directed distances dist(s -> t), batched (float32[Q] on the
        index's device)."""
        s, t = self._index(s), self._index(t)
        rs, rt = (row_index(x, self.n + 1) for x in (s, t))
        ids_s, d_s = self.out_lbl[0][rs], self.out_lbl[1][rs]
        ids_t, d_t = self.in_lbl[0][rt], self.in_lbl[1][rt]
        mu, _ = label_intersect_mu(ids_s, d_s, ids_t, d_t, self.n)
        self._last_rounds = None
        if self.n_core == 0:
            return mu
        es, ed, ew = self.core_edges
        # forward relax for DS; DT relaxes on the reversed core graph
        ds, r_fwd = _relax_one(self._seed(ids_s, d_s), es, ed, ew,
                               self.n_core)
        dt, r_bwd = _relax_one(self._seed(ids_t, d_t), ed, es, ew,
                               self.n_core)
        self._last_rounds = (r_fwd, r_bwd)
        through = (ds[:, :self.n_core] + dt[:, :self.n_core]).amin(1)
        return torch.minimum(mu, through)

    def query_host(self, s, t) -> np.ndarray:
        """``query`` read to the host (one ``host_read``)."""
        return hsync.host_read(self.query(_batch(s), _batch(t)))

    def reachable(self, s, t):
        return np.isfinite(self.query_host(s, t))

    # ------------------------------------------------------- §8.1/§8.2 paths
    def _label_host(self, family: str):
        """Cached host copies of one label family's (ids, d, pred)."""
        if self._host_lbl is None:
            self._host_lbl = {}
        if family not in self._host_lbl:
            lbl = self.out_lbl if family == "out" else self.in_lbl
            self._host_lbl[family] = hsync.host_read(tuple(lbl))
        return self._host_lbl[family]

    def _core_adjacency(self, reverse: bool = False):
        """Cached src-sorted core adjacency, forward or reversed."""
        if self._core_adj is None:
            self._core_adj = {}
        if reverse not in self._core_adj:
            from repro_torch.core.ref import sorted_adjacency
            ce_s, ce_d, ce_w, ce_v = self.core_host
            src, dst = (ce_d, ce_s) if reverse else (ce_s, ce_d)
            self._core_adj[reverse] = sorted_adjacency(self.n, src, dst,
                                                       ce_w, ce_v)
        return self._core_adj[reverse]

    # Directed via expansion: an augmenting edge (a, b) through a
    # removed c stands for the 2-path a -> c -> b, so a sits in c's
    # *in*-adjacency and b in its *out*-adjacency.
    def _expand_dir(self, a: int, b: int, via: int) -> list[int]:
        """Original-graph vertices [a..b) of the directed edge a -> b."""
        if via < 0:
            return [a]
        sa = self._slot(self.up_in, via, a)
        sb = self._slot(self.up_out, via, b)
        if sa < 0 or sb < 0:
            return [a]
        return (self._expand_dir(a, via, int(self.up_in[2][via, sa]))
                + self._expand_dir(via, b, int(self.up_out[2][via, sb])))

    @staticmethod
    def _slot(up, v: int, u: int) -> int:
        slots = np.flatnonzero(up[0][v] == u)
        return int(slots[0]) if len(slots) else -1

    def _chase(self, v: int, x: int, family: str) -> list[int]:
        """Real-graph vertices of the label path between v and x.

        ``family="out"``: returns [v..x) of the path v -> x (chasing
        out-labels forward). ``family="in"``: returns [x..v) of the
        path x -> v (every in-label hop is a real edge INTO v).
        """
        if v == x:
            return []
        lbl = self._label_host(family)
        up = self.up_out if family == "out" else self.up_in
        row = lbl[0][v]
        j = int(np.searchsorted(row, x))
        if j >= len(row) or row[j] != x:
            raise ValueError(f"{x} is not a {family}-ancestor of {v}")
        u = int(lbl[2][v][j])
        slot = self._slot(up, v, u)
        if u < 0 or slot < 0:
            raise ValueError("inconsistent pred chain")
        via = int(up[2][v, slot])
        if family == "out":
            return self._expand_dir(v, u, via) + self._chase(u, x, "out")
        return self._chase(u, x, "in") + self._expand_dir(u, v, via)

    def shortest_path(self, s: int, t: int):
        """Return (dist(s -> t), [s..t] vertex list in the original
        directed graph) — the directed analogue of
        ``ISLabelIndex.shortest_path``."""
        dist = float(self.query_host([s], [t])[0])
        if not np.isfinite(dist):
            return dist, []
        from repro_torch.core.ref import host_meet
        out_h, in_h = self._label_host("out"), self._label_host("in")
        mu, w = host_meet(out_h[0][s], out_h[1][s], in_h[0][t], in_h[1][t],
                          self.n)
        if mu <= dist + 1e-6 and w >= 0:
            return dist, (self._chase(s, w, "out")
                          + self._chase(t, w, "in") + [t])
        return dist, self._core_path_dir(s, t)

    def _core_path_dir(self, s: int, t: int) -> list[int]:
        from repro_torch.core.ref import seeded_sssp

        def seeds(family, v):
            lbl = self._label_host(family)
            row_i, row_d = lbl[0][v], lbl[1][v]
            return {int(u): float(d) for u, d in zip(row_i, row_d)
                    if int(u) < self.n and self.level[int(u)] == self.k}

        ds, ps = seeded_sssp(seeds("out", s),
                             *self._core_adjacency(reverse=False))
        dt, pt = seeded_sssp(seeds("in", t),
                             *self._core_adjacency(reverse=True))
        meet = min((ds.get(u, np.inf) + dt.get(u, np.inf), u)
                   for u in ds)[1]
        # forward side: unwind par edges (u -> v) back to the s seed
        fwd, v = [], meet
        while ps[v][0] is not None:
            u, via = ps[v]
            fwd = self._expand_dir(u, v, via) + fwd
            v = u
        left = self._chase(s, v, "out") + fwd
        # backward side: par edges are real (v -> u), already forward
        bwd, v = [], meet
        while pt[v][0] is not None:
            u, via = pt[v]
            bwd = bwd + self._expand_dir(v, u, via)
            v = u
        return left + bwd + self._chase(t, v, "in") + [t]
