"""Kernel dispatch layer for the query hot path (the counterpart of
``repro.core.dispatch``).

  stage 1 — Equation 1 label intersection:
      ``label_intersect_dispatch`` (gathered fp32 rows) /
      ``label_intersect_planes_dispatch`` (endpoint ids; the kernels
      read the rows in place from the label planes)
      -> ``kernels.label_intersect.ops``; delta16 rows go to the packed
      kernel, which decodes them in registers.

  stage 2 — label-seeded bidirectional core relaxation:
      ``CoreRelaxer`` — the reference backend keeps the COO scatter-min
      wavefront (``core_relax``); the ``cuda`` backend picks one of
      three routes (``CoreRelaxer.mode``), by the same rule as ``repro``:

      "fused"    — one ``fused_relax`` launch runs all rounds, per
                   8-row block of the stacked frontiers, over the
                   core's real in-edges sliced 32 destinations a warp.
      "dense"    — small dense cores relax via ``minplus_matmul``
                   against a 0-diagonal dense adjacency.
      "ell_loop" — one ``spmv_relax`` launch per round, when the fused
                   working-set model exceeds its budget (large cores).
                   The stacked frontier is vertex-major ([Vp, R]) and
                   the kernel walks the core's real in-edges (a CSR),
                   gathering only from sources that changed last round.

Every route computes the same synchronous (Jacobi) rounds, so answers
and round counts agree bitwise with ``repro``.

JAX ran the round loops as device ``while_loop``s. Here the loop is on
the host and the exit test stays on the device (``device_loop``, which
the path lane's chases share): a round run after the fixed point is an
exact no-op and is not counted, so ``rounds`` equals JAX's count, and
the host reads the "improved" flag (``host_read``) once every
``CHECK_EVERY`` rounds instead of once per round. The
``ell_loop`` kernel writes that flag itself, and a launch after a
round that improved nothing returns at once.

A route's seeds are label seeds: per query side, the core position of
each label entry's ancestor (the sentinel column n_core for non-core
ancestors) and its distance (+inf for padding). Each route scatters
them (min) into the frontier layout it relaxes.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.labels import LabelRows
from repro_torch.core.sync import host_read, upload
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.label_intersect import ops as li_ops
from repro_torch.kernels.minplus_matmul.ops import minplus_matmul
from repro_torch.kernels.spmv_relax.kernel import (ROW_TILE, RelaxCSR,
                                                   SlicedEdges,
                                                   fused_vmem_bytes)
from repro_torch.kernels.spmv_relax.ops import (coo_to_csr, coo_to_sliced,
                                                ell_width, fused_relax,
                                                spmv_relax)
from repro_torch.obs.profiler import record_build

# The TPU's VMEM budget for the fused kernel's working set, kept from
# ``repro`` so both packages take the same route on the same index;
# above it the dispatcher falls back to the per-round launch loop.
FUSED_VMEM_BUDGET = 12 * 2 ** 20
CHECK_EVERY = 8          # rounds between host reads of the exit flag
INF = float("inf")


def label_intersect_dispatch(ids_s, d_s, ids_t, d_t, n_sentinel: int,
                             backend: str):
    """Equation 1 μ via the resolved kernel backend. Returns float32[Q]."""
    return li_ops.label_intersect(ids_s, d_s, ids_t, d_t, n_sentinel,
                                  backend=backend)


def label_intersect_planes_dispatch(planes: LabelRows, s, t, n_sentinel: int,
                                    codec: str, backend: str):
    """Equation 1 μ of the endpoint pairs (s[q], t[q]) over [n+1, L]
    label planes in either codec, rows read in place."""
    return li_ops.label_intersect_planes(planes, s, t, n_sentinel, codec,
                                         backend=backend)


def device_loop(step, state, steps: int, active):
    """A JAX ``while_loop`` as a host loop whose test stays on the
    device: run ``step(state, i)`` for i = 0, 1, ... up to ``steps``
    times, stopping after the first multiple of ``CHECK_EVERY`` steps at
    which ``active(state)`` (a device bool tensor) holds nowhere — one
    ``host_read`` per ``CHECK_EVERY`` steps. ``step`` must leave a state
    that is inactive everywhere unchanged."""
    i = 0
    while i < steps:
        for _ in range(min(CHECK_EVERY, steps - i)):
            state = step(state, i)
            i += 1
        if i < steps and not host_read(active(state).any()):
            break
    return state


def relax_rounds(step, state: tuple, max_rounds: int):
    """Apply ``step`` (state -> state) until no tensor of the state
    improves, or ``max_rounds``. Returns (state, rounds int32 tensor).

    ``improved`` is the flag JAX's ``while_loop`` tested; a round it
    does not cover leaves the state unchanged and is not counted."""
    dev = state[0].device

    def round_(st, _):
        *cur, rounds, improved = st
        new = step(*cur)
        better = torch.zeros((), dtype=torch.bool, device=dev)
        for a, b in zip(new, cur):
            better |= (a < b).any()
        return (*new, rounds + improved, improved & better)

    *state, rounds, _ = device_loop(
        round_, (*state, torch.zeros((), dtype=torch.int32, device=dev),
                 torch.ones((), dtype=torch.bool, device=dev)),
        max_rounds, lambda st: st[-1])
    return tuple(state), rounds


def core_relax(seed_s, seed_t, ce_src, ce_dst, ce_w, mu, n_core: int,
               max_rounds: int):
    """Reference bidirectional label-seeded relaxation on G_k (Alg. 1
    stage 2) — COO scatter-min wavefront rounds.

    seed_s/seed_t: [Q, n_core+1] initial distance vectors (+inf default,
    label distances scattered in, sentinel column n_core).
    Returns (ans [Q], ds, dt, rounds) with ans = min(μ, min_v ds+dt).
    """
    q = seed_s.shape[0]
    src = ce_src.long()
    dst = ce_dst.long()[None, :].expand(q, -1)

    def round_(ds, dt):
        cs = ds[:, src] + ce_w[None, :]
        ct = dt[:, src] + ce_w[None, :]
        return (ds.scatter_reduce(1, dst, cs, "amin", include_self=True),
                dt.scatter_reduce(1, dst, ct, "amin", include_self=True))

    (ds, dt), rounds = relax_rounds(round_, (seed_s, seed_t), max_rounds)
    # the sentinel column n_core parks non-core label entries — exclude it
    through_core = (ds[:, :n_core] + dt[:, :n_core]).amin(1)
    return torch.minimum(mu, through_core), ds, dt, rounds


def seed_rows(seeds, v: int):
    """[Q, v] row-major frontier from one side's label seeds ``(cpos
    int64[Q, L], d float32[Q, L])``: +inf, with each label distance
    scattered (min) to its core position."""
    cpos, d = seeds
    q = cpos.shape[0]
    out = torch.full((q * v,), INF, dtype=torch.float32, device=d.device)
    rows = torch.arange(q, device=d.device)[:, None] * v
    out.scatter_reduce_(0, (rows + cpos).reshape(-1), d.reshape(-1), "amin",
                        include_self=True)
    return out.view(q, v)


def seed_vertex_major(seeds_s, seeds_t, vp: int, rows: int):
    """Both sides' label seeds scattered (min) straight into one
    vertex-major [vp, rows] frontier (s rows 0..Q-1, t rows Q..2Q-1,
    +inf elsewhere), and the first round's ``changed`` mask
    bool[ceil(rows / ROW_TILE), vp]: the (tile, vertex) pairs that hold a
    finite seed, the only sources that can lower anything."""
    (cpos_s, d_s), (cpos_t, d_t) = seeds_s, seeds_t
    q, l = cpos_s.shape
    dev = d_s.device
    cpos = torch.cat([cpos_s, cpos_t]).reshape(-1)
    d = torch.cat([d_s, d_t]).reshape(-1)
    r = torch.arange(2 * q, device=dev)[:, None].expand(2 * q, l).reshape(-1)
    d0 = torch.full((vp * rows,), INF, dtype=torch.float32, device=dev)
    d0.scatter_reduce_(0, cpos * rows + r, d, "amin", include_self=True)
    n_tiles = -(-rows // ROW_TILE)
    # +inf seeds park in one extra slot past the mask
    changed = torch.zeros(n_tiles * vp + 1, dtype=torch.bool, device=dev)
    changed.index_fill_(0, torch.where(d < INF, (r // ROW_TILE) * vp + cpos,
                                       n_tiles * vp), True)
    return d0.view(vp, rows), changed[:-1].view(n_tiles, vp)


def stack_frontiers(seed_s, seed_t, vp: int, bq: int):
    """Both frontiers stacked into one [2Q rounded up to bq, Vp] matrix,
    +inf padded."""
    q, v = seed_s.shape
    rp = -(-2 * q // bq) * bq
    d0 = torch.full((rp, vp), INF, dtype=torch.float32, device=seed_s.device)
    d0[:q, :v] = seed_s
    d0[q:2 * q, :v] = seed_t
    return d0


def _finish(d, q: int, v: int, mu, n_core: int, rounds):
    """(ans, ds, dt, rounds) from the stacked [rows, Vp] frontier ``d``
    (any strides)."""
    ds = d[:q, :v]
    dt = d[q:2 * q, :v]
    through_core = (ds[:, :n_core] + dt[:, :n_core]).amin(1)
    return torch.minimum(mu, through_core), ds, dt, rounds


def relax_csr_rounds(cur, changed, csr: RelaxCSR, max_rounds: int):
    """Rounds of ``spmv_relax`` over the vertex-major frontier ``cur``
    to the fixed point or ``max_rounds``, ping-ponging between two
    frontier buffers and two ``changed`` masks. Returns (frontier,
    rounds int32 device scalar).

    ``flags[i]`` is round i's input flag (``flags[0] = 1``); round i
    sets ``flags[i + 1]`` if it improved anything. A round whose flag is
    0 returns at once, leaving both buffers equal, so ``rounds`` (the
    rounds that ran, the last non-improving one included) is
    ``flags[:done].sum()``, JAX's ``while_loop`` count."""
    dev = cur.device
    nxt = torch.empty_like(cur)
    changed_nxt = torch.empty_like(changed)
    flags = torch.zeros(max_rounds + 1, dtype=torch.int32, device=dev)
    flags[:1].fill_(1)
    done = 0
    while done < max_rounds:
        for _ in range(min(CHECK_EVERY, max_rounds - done)):
            spmv_relax(cur, csr, changed, flag_in=flags[done:done + 1],
                       out=nxt, changed_out=changed_nxt,
                       flag_out=flags[done + 1:done + 2], backend="cuda")
            cur, nxt = nxt, cur
            changed, changed_nxt = changed_nxt, changed
            done += 1
        if not host_read(flags[done]):
            break
    return cur, flags[:done].sum(dtype=torch.int32)


def _core_relax_csr(seeds_s, seeds_t, csr: RelaxCSR, mu, n_core: int,
                    max_rounds: int, bq: int):
    """Both frontiers stacked vertex-major, one ``spmv_relax`` launch per
    round."""
    q = seeds_s[0].shape[0]
    vp = csr.order.shape[0]
    rows = -(-2 * q // bq) * bq
    d0, changed = seed_vertex_major(seeds_s, seeds_t, vp, rows)
    d, rounds = relax_csr_rounds(d0, changed, csr, max_rounds)
    return _finish(d.T, q, n_core + 1, mu, n_core, rounds)


def _core_relax_fused(seeds_s, seeds_t, edges: SlicedEdges, mu,
                      n_core: int, max_rounds: int, bq: int):
    """Both frontiers stacked, all rounds in one ``fused_relax`` launch.
    Batch rounds = max over per-block rounds (all-pad blocks settle in
    one round, real blocks freeze bitwise at their own fixed point)."""
    q, v = seeds_s[0].shape[0], n_core + 1
    d0 = stack_frontiers(seed_rows(seeds_s, v), seed_rows(seeds_t, v),
                         edges.order.shape[0], bq)
    d, blk_rounds = fused_relax(d0, edges, max_rounds=max_rounds, bq=bq)
    rounds = torch.cat([blk_rounds, blk_rounds.new_zeros(1)]).amax()
    return _finish(d, q, v, mu, n_core, rounds)


def _core_relax_dense(seeds_s, seeds_t, adj, mu, n_core: int,
                      max_rounds: int, bm: int = 8):
    """One ``minplus_matmul`` per round against the 0-diagonal adjacency
    (the diagonal supplies the keep-old term, so ``minplus(d, adj)`` IS
    the synchronous round)."""
    q, v = seeds_s[0].shape[0], n_core + 1
    d0 = stack_frontiers(seed_rows(seeds_s, v), seed_rows(seeds_t, v),
                         adj.shape[0], bm)
    (d,), rounds = relax_rounds(
        lambda d: (minplus_matmul(d, adj, backend="cuda"),), (d0,),
        max_rounds)
    return _finish(d, q, v, mu, n_core, rounds)


class CoreRelaxer:
    """Backend-dispatched stage-2 relaxation over the local core graph.

    Holds the COO edge arrays (host arrays: local indices in
    [0, n_core), weights) and derives the layout of its route once, on
    first use, on ``device``: the in-edge CSR of the per-round kernel,
    the sliced in-edges of the fused kernel or, for dense cores, the
    0-diagonal dense adjacency — padded to a multiple of ``bv``
    vertices. Each layout's build counts one first-use build in the
    current region (``obs.profiler.record_build``).

    Route selection (``.mode``) is ``repro``'s: density >=
    ``dense_threshold`` (env ``ISLABEL_DENSE_THRESHOLD``) with n_core <=
    ``dense_cap`` -> "dense"; else "fused" when the fused working-set
    model (the ELL width from the in-degrees) fits ``vmem_budget``; else
    "ell_loop". Env ``ISLABEL_FUSED_RELAX=0`` forces the per-round loop.
    No kernel reads ELL planes; only the rule's width does.
    """

    def __init__(self, ce_src, ce_dst, ce_w, n_core: int, *,
                 bq: int = 8, bv: int = 128, d_width: int = 16,
                 fused: bool | None = None,
                 dense_threshold: float | None = None,
                 dense_cap: int = 2048,
                 vmem_budget: int = FUSED_VMEM_BUDGET,
                 device="cpu"):
        self.ce_src = np.asarray(ce_src, np.int32)
        self.ce_dst = np.asarray(ce_dst, np.int32)
        self.ce_w = np.asarray(ce_w, np.float32)
        self.n_core = n_core
        self.bq = bq
        self.bv = bv
        self.d_width = d_width
        self.device = torch.device(device)
        if fused is None:
            fused = os.environ.get("ISLABEL_FUSED_RELAX", "1") != "0"
        self.fused = fused
        if dense_threshold is None:
            dense_threshold = float(
                os.environ.get("ISLABEL_DENSE_THRESHOLD", "0.05"))
        self.dense_threshold = dense_threshold
        self.dense_cap = dense_cap
        self.vmem_budget = vmem_budget
        self.density = (len(self.ce_src) / (n_core * n_core)) if n_core else 0.0
        self._coo = None
        self._csr = None
        self._sliced = None
        self._adj = None
        self._mode = None

    @property
    def mode(self) -> str:
        """Kernel route: "dense" | "fused" | "ell_loop" (the reference
        backend bypasses this entirely)."""
        if self._mode is None:
            if (0 < self.n_core <= self.dense_cap
                    and self.density >= self.dense_threshold):
                self._mode = "dense"
            elif self.fused:
                width = ell_width(self.n_core + 1, self.ce_dst, self.d_width)
                fits = (fused_vmem_bytes(self._vp(), width, self.bq)
                        <= self.vmem_budget)
                self._mode = "fused" if fits else "ell_loop"
            else:
                self._mode = "ell_loop"
        return self._mode

    def _vp(self) -> int:
        return -(-(self.n_core + 1) // self.bv) * self.bv

    def coo(self):
        """(src, dst, w) device tensors for the COO reference."""
        if self._coo is None:
            record_build("relax_layout:coo")
            self._coo = (upload(self.ce_src, self.device),
                         upload(self.ce_dst, self.device),
                         upload(self.ce_w, self.device))
        return self._coo

    def csr(self) -> RelaxCSR:
        """The in-edges by destination over Vp = n_core+1 rounded up to
        a multiple of bv vertices (sentinel included, padding vertices
        edgeless), for ``spmv_relax``."""
        if self._csr is None:
            record_build("relax_layout:csr")
            indptr, src, w, order, n_heavy = coo_to_csr(
                self._vp(), self.ce_src, self.ce_dst, self.ce_w)
            self._csr = RelaxCSR(*(upload(x, self.device)
                                   for x in (indptr, src, w, order)), n_heavy)
        return self._csr

    def sliced(self) -> SlicedEdges:
        """The in-edges over the same Vp vertices, sliced 32
        destinations a warp, for ``fused_relax``."""
        if self._sliced is None:
            record_build("relax_layout:sliced")
            self._sliced = SlicedEdges(*(
                upload(x, self.device) for x in coo_to_sliced(
                    self._vp(), self.ce_src, self.ce_dst, self.ce_w)))
        return self._sliced

    def dense_adj(self):
        """[Vp, Vp] float32 dense adjacency: adj[src, dst] = min edge
        weight, +inf elsewhere, diagonal min'd with 0 on ALL rows
        including the sentinel and lane padding so parked values
        survive each round."""
        if self._adj is None:
            record_build("relax_layout:dense")
            vp = self._vp()
            adj = np.full((vp, vp), np.inf, np.float32)
            if len(self.ce_src):
                np.minimum.at(adj, (self.ce_src, self.ce_dst), self.ce_w)
            idx = np.arange(vp)
            adj[idx, idx] = np.minimum(adj[idx, idx], 0.0)
            self._adj = upload(adj, self.device)
        return self._adj

    def run(self, seeds_s, seeds_t, mu, max_rounds: int, backend=None):
        """Relax to convergence from both sides' label seeds ``(cpos
        int64[Q, L], d float32[Q, L])``. Returns (ans, ds, dt, rounds)
        with ds/dt of shape [Q, n_core+1] and rounds an int32 device
        scalar."""
        backend = resolve_backend(backend, self.device)
        v = self.n_core + 1
        if backend == "reference":
            return core_relax(seed_rows(seeds_s, v), seed_rows(seeds_t, v),
                              *self.coo(), mu, self.n_core, max_rounds)
        mode = self.mode
        if mode == "dense":
            return _core_relax_dense(seeds_s, seeds_t, self.dense_adj(), mu,
                                     self.n_core, max_rounds, self.bq)
        if mode == "fused":
            return _core_relax_fused(seeds_s, seeds_t, self.sliced(), mu,
                                     self.n_core, max_rounds, self.bq)
        return _core_relax_csr(seeds_s, seeds_t, self.csr(), mu, self.n_core,
                               max_rounds, self.bq)
