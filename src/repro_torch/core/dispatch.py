"""Kernel dispatch layer for the query hot path (the counterpart of
``repro.core.dispatch``).

  stage 1 — Equation 1 label intersection:
      ``label_intersect_dispatch`` / ``label_intersect_rows_dispatch``
      -> ``kernels.label_intersect.ops``; delta16 rows go to the packed
      kernel, which decodes them in registers.

  stage 2 — label-seeded bidirectional core relaxation:
      ``CoreRelaxer`` — the reference backend keeps the COO scatter-min
      wavefront (``core_relax``); the ``cuda`` backend picks one of
      three routes (``CoreRelaxer.mode``), by the same rule as ``repro``:

      "fused"    — one ``fused_relax`` launch runs all rounds, per
                   8-row block of the stacked frontiers.
      "dense"    — small dense cores relax via ``minplus_matmul``
                   against a 0-diagonal dense adjacency.
      "ell_loop" — one ``spmv_relax`` launch per round, when the fused
                   working-set model exceeds its budget (large cores).

Every route computes the same synchronous (Jacobi) rounds, so answers
and round counts agree bitwise with ``repro``.

JAX ran the round loops as device ``while_loop``s. Here the loop is on
the host and the exit test stays on the device: a round run after the
fixed point is an exact no-op and is not counted, so ``rounds`` equals
JAX's count, and the host reads the "improved" flag (``host_read``)
once every ``CHECK_EVERY`` rounds instead of once per round.
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
from repro_torch.kernels.spmv_relax.kernel import fused_vmem_bytes
from repro_torch.kernels.spmv_relax.ops import (coo_to_ell, fused_relax,
                                                spmv_relax)

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


def label_intersect_rows_dispatch(rows_s: LabelRows, rows_t: LabelRows,
                                  n_sentinel: int, codec: str, backend: str):
    """Equation 1 μ over gathered ``LabelRows`` in either codec."""
    return li_ops.label_intersect_rows(rows_s, rows_t, n_sentinel, codec,
                                       backend=backend)


def relax_rounds(step, state: tuple, max_rounds: int):
    """Apply ``step`` (state -> state) until no tensor of the state
    improves, or ``max_rounds``. Returns (state, rounds int32 tensor).

    ``improved`` is the flag JAX's ``while_loop`` tested; a round it
    does not cover leaves the state unchanged and is not counted."""
    dev = state[0].device
    improved = torch.ones((), dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    done = 0
    while done < max_rounds:
        for _ in range(min(CHECK_EVERY, max_rounds - done)):
            new = step(*state)
            rounds += improved
            better = torch.zeros((), dtype=torch.bool, device=dev)
            for a, b in zip(new, state):
                better |= (a < b).any()
            improved &= better
            state = new
            done += 1
        if not host_read(improved):
            break
    return state, rounds


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
    ds = d[:q, :v]
    dt = d[q:2 * q, :v]
    through_core = (ds[:, :n_core] + dt[:, :n_core]).amin(1)
    return torch.minimum(mu, through_core), ds, dt, rounds


def _core_relax_ell(seed_s, seed_t, nbr_ids, nbr_w, mu, n_core: int,
                    max_rounds: int, bq: int):
    """Both frontiers stacked, one ``spmv_relax`` launch per round."""
    q, v = seed_s.shape
    d0 = stack_frontiers(seed_s, seed_t, nbr_ids.shape[0], bq)
    (d,), rounds = relax_rounds(
        lambda d: (spmv_relax(d, nbr_ids, nbr_w, backend="cuda"),),
        (d0,), max_rounds)
    return _finish(d, q, v, mu, n_core, rounds)


def _core_relax_fused(seed_s, seed_t, nbr_ids, nbr_w, mu, n_core: int,
                      max_rounds: int, bq: int):
    """Both frontiers stacked, all rounds in one ``fused_relax`` launch.
    Batch rounds = max over per-block rounds (all-pad blocks settle in
    one round, real blocks freeze bitwise at their own fixed point)."""
    q, v = seed_s.shape
    d0 = stack_frontiers(seed_s, seed_t, nbr_ids.shape[0], bq)
    d, blk_rounds = fused_relax(d0, nbr_ids, nbr_w, max_rounds=max_rounds,
                                bq=bq)
    rounds = torch.cat([blk_rounds, blk_rounds.new_zeros(1)]).amax()
    return _finish(d, q, v, mu, n_core, rounds)


def _core_relax_dense(seed_s, seed_t, adj, mu, n_core: int, max_rounds: int,
                      bm: int = 8):
    """One ``minplus_matmul`` per round against the 0-diagonal adjacency
    (the diagonal supplies the keep-old term, so ``minplus(d, adj)`` IS
    the synchronous round)."""
    q, v = seed_s.shape
    d0 = stack_frontiers(seed_s, seed_t, adj.shape[0], bm)
    (d,), rounds = relax_rounds(
        lambda d: (minplus_matmul(d, adj, backend="cuda"),), (d0,),
        max_rounds)
    return _finish(d, q, v, mu, n_core, rounds)


class CoreRelaxer:
    """Backend-dispatched stage-2 relaxation over the local core graph.

    Holds the COO edge arrays (host arrays: local indices in
    [0, n_core), weights) and derives the kernel-side layouts once, on first use, on
    ``device``: the ELL planes of the per-round and fused kernels and,
    for dense cores, the 0-diagonal dense adjacency — padded to a
    multiple of ``bv`` vertices.

    Route selection (``.mode``) is ``repro``'s: density >=
    ``dense_threshold`` (env ``ISLABEL_DENSE_THRESHOLD``) with n_core <=
    ``dense_cap`` -> "dense"; else "fused" when the fused working-set
    model fits ``vmem_budget``; else "ell_loop". Env
    ``ISLABEL_FUSED_RELAX=0`` forces the per-round loop.
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
        self._ell = None
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
                vp, width = self.ell()[0].shape
                fits = fused_vmem_bytes(vp, width, self.bq) <= self.vmem_budget
                self._mode = "fused" if fits else "ell_loop"
            else:
                self._mode = "ell_loop"
        return self._mode

    def _vp(self) -> int:
        return -(-(self.n_core + 1) // self.bv) * self.bv

    def coo(self):
        """(src, dst, w) device tensors for the COO reference."""
        if self._coo is None:
            self._coo = (upload(self.ce_src, self.device),
                         upload(self.ce_dst, self.device),
                         upload(self.ce_w, self.device))
        return self._coo

    def dense_adj(self):
        """[Vp, Vp] float32 dense adjacency: adj[src, dst] = min edge
        weight, +inf elsewhere, diagonal min'd with 0 on ALL rows
        including the sentinel and lane padding so parked values
        survive each round."""
        if self._adj is None:
            vp = self._vp()
            adj = np.full((vp, vp), np.inf, np.float32)
            if len(self.ce_src):
                np.minimum.at(adj, (self.ce_src, self.ce_dst), self.ce_w)
            idx = np.arange(vp)
            adj[idx, idx] = np.minimum(adj[idx, idx], 0.0)
            self._adj = upload(adj, self.device)
        return self._adj

    def ell(self):
        """(nbr_ids [Vp, D], nbr_w [Vp, D]) with Vp = n_core+1 rounded up
        to a multiple of bv (sentinel column included, padding rows
        edgeless)."""
        if self._ell is None:
            v = self.n_core + 1
            vp = self._vp()
            ids, ws = coo_to_ell(v, self.ce_src, self.ce_dst, self.ce_w,
                                 d_width=self.d_width)
            ids = np.pad(ids, ((0, vp - v), (0, 0)))
            ws = np.pad(ws, ((0, vp - v), (0, 0)), constant_values=np.inf)
            self._ell = (upload(ids, self.device), upload(ws, self.device))
        return self._ell

    def run(self, seed_s, seed_t, mu, max_rounds: int, backend=None):
        """Relax to convergence. Returns (ans, ds, dt, rounds) with
        ds/dt of shape [Q, n_core+1] and rounds an int32 device scalar."""
        backend = resolve_backend(backend, self.device)
        if backend == "reference":
            return core_relax(seed_s, seed_t, *self.coo(), mu, self.n_core,
                              max_rounds)
        mode = self.mode
        if mode == "dense":
            return _core_relax_dense(seed_s, seed_t, self.dense_adj(), mu,
                                     self.n_core, max_rounds, self.bq)
        nbr_ids, nbr_w = self.ell()
        if mode == "fused":
            return _core_relax_fused(seed_s, seed_t, nbr_ids, nbr_w, mu,
                                     self.n_core, max_rounds, self.bq)
        return _core_relax_ell(seed_s, seed_t, nbr_ids, nbr_w, mu,
                               self.n_core, max_rounds, self.bq)
