"""``PathEngine`` — batched shortest-path retrieval over an IS-LABEL
index: the counterpart of ``repro.paths.engine``.

Mirrors the ``QueryEngine`` serving contract: ``path_batch_fn`` returns
a fixed-shape callable memoized per (resolved backend, hop_cap),
``warmup`` runs every serving shape once, and the stages run through
the dispatch layer the distance path uses: the plain
``label_intersect_mu`` for μ and the meeting ancestor (the label
kernels return μ alone, as in ``repro``), and the index's own
``CoreRelaxer`` for the fixed point the parents are read from. On the
card, stage 2 therefore launches the route's hand-written kernel
(``spmv_relax``, ``fused_relax`` or ``minplus_matmul``); the chases,
the stitch and the via expansion are plain torch ops, as they are
plain jnp in ``repro``.

The chase planes are the core's in-edges in ELL form
(``kernels/spmv_relax/ops.py:ell_layout``: a destination's in-edges in
COO order), built here and read by nothing else. The parent chase
takes the first candidate in that order, so vertex lists equal
``repro``'s.

A batch issues no host sync outside ``host_read``: the relaxation loop
and each chase read their exit flags once every few steps.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dispatch import CoreRelaxer, seed_rows
from repro_torch.core.labels import row_index
from repro_torch.core.query import (QueryEngine, label_intersect_mu,
                                    shape_counted)
from repro_torch.core.sync import host_read, upload
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.spmv_relax.ops import ell_layout
from repro_torch.obs.profiler import record_build
from repro_torch.obs.registry import REGISTRY
from repro_torch.paths.reconstruct import (core_chase, expand_vias,
                                           label_chase, stitch)

DEFAULT_HOP_CAP = 256


class PathBatch(NamedTuple):
    """One batch of reconstructed paths (fixed shapes, tensors on the
    engine's device).

    ``verts[q, :lens[q]]`` is the vertex sequence (sentinel-n padded),
    ``weights[q, i]`` the original-graph weight of edge
    ``(verts[q, i], verts[q, i+1])`` (0 beyond the path), ``lens[q]``
    the vertex count (0 = unreachable), ``ok[q]`` False when the path
    overflowed ``hop_cap`` (escalate and retry; ``dist`` stays exact).
    """
    dist: torch.Tensor        # float32[Q]
    verts: torch.Tensor       # int32[Q, hop_cap]
    weights: torch.Tensor     # float32[Q, hop_cap]
    lens: torch.Tensor        # int32[Q]
    ok: torch.Tensor          # bool[Q]
    rounds: torch.Tensor      # int32 scalar (core relaxation rounds)


class PathEngine:
    """Device-resident path-reconstruction state and its entry points.
    ``hop_cap`` is per callable, not per engine — one engine serves
    every hop_cap tier. The label planes are tensors on the engine's
    device; the up-edge and core arrays are host numpy (uploaded
    here)."""

    def __init__(self, *, n: int, k: int, lbl_ids, lbl_d, lbl_pred,
                 up_ids, up_w, up_via, core_ids, core_pos, core_src,
                 core_dst, core_w, core_via, max_rounds: int = 0,
                 backend: str = "auto", d_width: int = 16, relaxer=None):
        self.n = n
        self.k = k
        self.backend = backend
        self.device = lbl_ids.device
        dev = self.device
        self.lbl_ids = lbl_ids
        self.lbl_d = lbl_d
        self.lbl_pred = lbl_pred
        self.l_cap = lbl_ids.shape[1]
        self.up_ids = upload(np.asarray(up_ids, np.int32), dev)
        self.up_w = upload(np.asarray(up_w, np.float32), dev)
        self.up_via = upload(np.asarray(up_via, np.int32), dev)
        core_ids = np.asarray(core_ids, np.int32)
        self.n_core = len(core_ids)
        self.core_gid = upload(np.append(core_ids, n).astype(np.int32), dev)
        cpos = np.asarray(core_pos, np.int32)
        self.core_pos = upload(cpos, dev)
        self.max_rounds = max_rounds if max_rounds > 0 else max(self.n_core, 1)
        self.chase_cap = max(k, 1)
        self.expand_rounds = k + 1
        self.relaxer = None
        if self.n_core > 0:
            ce_src = cpos[np.asarray(core_src)].astype(np.int32)
            ce_dst = cpos[np.asarray(core_dst)].astype(np.int32)
            ce_w = np.asarray(core_w, np.float32)
            # share the query engine's relaxer when offered — same
            # arrays, same route, so the fixed point the parents are
            # read from is the one the served distances came from
            self.relaxer = relaxer if relaxer is not None else CoreRelaxer(
                ce_src, ce_dst, ce_w, self.n_core, device=dev)
            # chase planes aligned slot for slot (ids, w, via) so the
            # parent chase reads edge vias with the same gather
            record_build("chase_planes")
            order, rows, slots, width = ell_layout(self.n_core + 1, ce_dst,
                                                   d_width)
            ids = np.zeros((self.n_core + 1, width), np.int32)
            ws = np.full((self.n_core + 1, width), np.inf, np.float32)
            vias = np.full((self.n_core + 1, width), -1, np.int32)
            if len(ce_src):
                ids[rows, slots] = ce_src[order]
                ws[rows, slots] = ce_w[order]
                vias[rows, slots] = np.asarray(core_via, np.int32)[order]
            self.ell_ids = upload(ids, dev)
            self.ell_w = upload(ws, dev)
            self.ell_via = upload(vias, dev)
        self._fns: dict = {}

    # ------------------------------------------------------------ builders
    @staticmethod
    def from_index(index, backend: str | None = None) -> "PathEngine":
        """Wrap an ``ISLabelIndex`` (shares its device label planes and
        its query engine's relaxer)."""
        return PathEngine(
            n=index.n, k=index.k, lbl_ids=index.lbl_ids, lbl_d=index.lbl_d,
            lbl_pred=index.lbl_pred, up_ids=index.up_ids, up_w=index.up_w,
            up_via=index.up_via, core_ids=index.core_ids,
            core_pos=index.core_pos_host, core_src=index.core_src,
            core_dst=index.core_dst, core_w=index.core_w,
            core_via=index.core_via, max_rounds=index.cfg.max_relax_rounds,
            backend=backend or index.cfg.query_backend,
            relaxer=index.engine.relaxer)

    # Label seeds and endpoint upload shared with QueryEngine, so the
    # frontier the parents are chased over cannot drift from the one
    # the served distances were computed with.
    _label_seeds = QueryEngine._label_seeds
    _index = QueryEngine._index

    # ----------------------------------------------------------- core fn
    def _run(self, s, t, hop_cap: int, backend: str) -> PathBatch:
        n, n_core, dev = self.n, self.n_core, self.device
        s, t = self._index(s), self._index(t)
        q = s.shape[0]
        rows = self.lbl_ids.shape[0]
        rs, rt = row_index(s, rows), row_index(t, rows)
        ids_s, d_s = self.lbl_ids[rs], self.lbl_d[rs]
        ids_t, d_t = self.lbl_ids[rt], self.lbl_d[rt]
        mu, meet = label_intersect_mu(ids_s, d_s, ids_t, d_t, n)
        core_cap = min(n_core, hop_cap)
        if n_core > 0:
            seeds_s = self._label_seeds(ids_s, d_s)
            seeds_t = self._label_seeds(ids_t, d_t)
            _, ds, dt, rounds = self.relaxer.run(seeds_s, seeds_t, mu,
                                                 self.max_rounds, backend)
            sum_st = ds[:, :n_core] + dt[:, :n_core]
            vstar = sum_st.argmin(1).to(torch.int32)
            through = sum_st.gather(1, vstar.long()[:, None])[:, 0]
            dist = torch.minimum(mu, through)
        else:
            rounds = torch.zeros((), dtype=torch.int32, device=dev)
            through = torch.full((q,), float("inf"), device=dev)
            vstar = torch.zeros(q, dtype=torch.int32, device=dev)
            dist = mu
        finite = torch.isfinite(dist)
        # ties prefer the label route, matching the host oracle
        use_label = finite & (mu <= through)
        ok = torch.ones(q, dtype=torch.bool, device=dev)

        if n_core > 0:
            core_act = finite & ~use_label
            seg_s_v, seg_s_via, seg_s_w, m_s, r_s, ok_s = core_chase(
                ds, seed_rows(seeds_s, n_core + 1), self.ell_ids, self.ell_w,
                self.ell_via, self.core_gid, vstar, core_act, core_cap, n)
            seg_t_v, seg_t_via, seg_t_w, m_t, r_t, ok_t = core_chase(
                dt, seed_rows(seeds_t, n_core + 1), self.ell_ids, self.ell_w,
                self.ell_via, self.core_gid, vstar, core_act, core_cap, n)
            ok = ok & ok_s & ok_t
            x_s = torch.where(use_label, meet, self.core_gid[r_s.long()])
            x_t = torch.where(use_label, meet, self.core_gid[r_t.long()])
            vstar_g = self.core_gid[vstar.long()]
        else:
            zero_i = torch.zeros((q, 0), dtype=torch.int32, device=dev)
            zero_f = torch.zeros((q, 0), dtype=torch.float32, device=dev)
            seg_s_v = seg_t_v = seg_s_via = seg_t_via = zero_i
            seg_s_w = seg_t_w = zero_f
            m_s = m_t = torch.zeros(q, dtype=torch.int32, device=dev)
            x_s = x_t = meet
            vstar_g = s

        ls_v, ls_via, ls_w, p_s, ok_ls = label_chase(
            self.lbl_ids, self.lbl_pred, self.up_ids, self.up_w,
            self.up_via, s, x_s, finite, self.chase_cap, n)
        lt_v, lt_via, lt_w, p_t, ok_lt = label_chase(
            self.lbl_ids, self.lbl_pred, self.up_ids, self.up_w,
            self.up_via, t, x_t, finite, self.chase_cap, n)
        ok = ok & ok_ls & ok_lt

        verts, evia, ew, length, ok_st = stitch(
            s, t, finite, hop_cap, n,
            ls_v, ls_via, ls_w, p_s,
            seg_s_v, seg_s_via, seg_s_w, m_s,
            vstar_g, seg_t_v, seg_t_via, seg_t_w, m_t,
            lt_v, lt_via, lt_w, p_t, x_t)
        verts, weights, length, ok_ex = expand_vias(
            verts, evia, ew, length, ok & ok_st, self.up_ids, self.up_w,
            self.up_via, n, self.expand_rounds)
        return PathBatch(dist, verts, weights, length, ok_ex, rounds)

    # ------------------------------------------------------- serving APIs
    def path_batch_fn(self, hop_cap: int = DEFAULT_HOP_CAP,
                      backend: str | None = None):
        """``run(s, t) -> PathBatch`` at a fixed ``hop_cap``, memoized
        per (resolved backend, hop_cap); no host read of the results —
        the caller owns blocking, timing and hop_cap escalation. Each
        call counts one ``path.batches`` for its tier; ``shapes`` holds
        the batch shapes it has run (``shape_counted``)."""
        backend = resolve_backend(self.backend if backend is None else backend,
                                  self.device)
        key = (backend, int(hop_cap))
        if key not in self._fns:
            hc = int(hop_cap)
            calls = REGISTRY.counter("path.batches",
                                     "path-lane batch dispatches")

            def run(s, t):
                calls.inc(1, hop_cap=str(hc))
                return self._run(s, t, hc, backend)
            self._fns[key] = shape_counted(run)
        return self._fns[key]

    def warmup(self, batch_sizes, hop_caps=(DEFAULT_HOP_CAP,),
               backend: str | None = None) -> dict:
        """Run one dummy batch per (batch, hop_cap) entry point (this
        builds the kernels and the route's layout). Returns
        {(size, hop_cap): seconds}."""
        out = {}
        for hc in hop_caps:
            fn = self.path_batch_fn(hc, backend)
            for size in batch_sizes:
                z = torch.zeros(int(size), dtype=torch.int32,
                                device=self.device)
                t0 = time.perf_counter()
                host_read(fn(z, z).dist)
                out[(int(size), int(hc))] = time.perf_counter() - t0
        return out

    # -------------------------------------------------------- host APIs
    def paths(self, s, t, hop_cap: int = DEFAULT_HOP_CAP,
              backend: str | None = None, max_escalations: int = 4):
        """Host convenience: batched paths as Python lists.

        Escalates hop_cap (doubling, up to ``max_escalations`` times)
        until every reconstructed path fits. Returns
        ``(dist float32[Q], paths list[list[int]], ok bool[Q])`` —
        unreachable pairs get an empty list.
        """
        s = np.atleast_1d(np.asarray(s, np.int32))
        t = np.atleast_1d(np.asarray(t, np.int32))
        hc = int(hop_cap)
        for _ in range(max_escalations + 1):
            out = self.path_batch_fn(hc, backend)(s, t)
            ok = host_read(out.ok)
            if ok.all():
                break
            hc *= 2
        dist, verts, lens = host_read((out.dist, out.verts, out.lens))
        paths = [verts[i, :lens[i]].tolist() if ok[i] else []
                 for i in range(len(s))]
        return dist, paths, ok
