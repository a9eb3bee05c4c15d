"""Wrappers of the relaxation kernels (stage 2 of a query), the COO ->
CSR and COO -> sliced conversions they take, the ELL width of the route
rule, and the ELL slot layout of the path lane's chase planes.

``spmv_relax`` replaces ``repro/kernels/spmv_relax/kernel.py:
spmv_relax_kernel`` (one round per launch, the route of large cores):
a vertex-major frontier, the core's real in-edges as a CSR, a per-(row
tile, source) 16-bit "changed last round" mask, one bit per 8-row
sector, and an in-kernel exit flag
(``csrc/spmv_relax.cu``). ``fused_relax`` replaces ``fused_relax_kernel``
(all rounds in one launch, per 8-row block, over the in-edges sliced
32 destinations a warp, the block's rows vertex-major in shared memory
where they fit; ``csrc/fused_relax.cu``). Bound on Hopper: bytes in
the first, the gathers in the second.

On a CUDA tensor a wrapper launches its kernel, or raises; on a CPU
tensor it runs the kernel's plain version (``ref.py``). ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.spmv_relax.kernel import (HEAVY_DEGREE, SLICE,
                                                   RelaxCSR, SlicedEdges,
                                                   fused_relax_kernel,
                                                   spmv_relax_kernel)
from repro_torch.kernels.spmv_relax.ref import fused_relax_ref, spmv_relax_ref

LAUNCHES = {"spmv_relax_kernel": 0, "fused_relax_kernel": 0}


def stable_argsort(a) -> np.ndarray:
    """``np.argsort(a, kind="stable")`` of a host integer array, through
    torch's parallel stable sort: the same permutation, several times
    faster on the millions of edges a layout of the 10^6 core sorts
    (built again for every version of ``serve/versions.py``)."""
    return torch.sort(torch.from_numpy(np.ascontiguousarray(a)),
                      stable=True).indices.numpy()


def ell_width(n_v: int, dst, d_width: int = 16) -> int:
    """ELL width of the COO's in-degrees: the largest in-degree (at
    least 1) rounded up to a multiple of ``d_width``. No kernel of the
    port reads ELL planes; the route rule (``core/dispatch.py``) sizes
    ``repro``'s fused working set with this width."""
    indeg = np.bincount(np.asarray(dst, np.int64), minlength=n_v)
    return max(d_width, int(-(-max(1, indeg.max(initial=0)) // d_width)
                            * d_width))


def ell_layout(n_v: int, dst, d_width: int = 16):
    """Slot assignment of ELL planes: a stable sort of the edges by
    destination, each edge's slot its rank among its destination's
    in-edges (COO order kept). Returns ``(order, rows, slots, width)``
    so callers scatter any per-edge payload (ids, weights, vias) into
    planes aligned slot for slot; ``width`` is ``ell_width``'s. The
    path lane's parent chase (``paths/engine.py``) reads these planes;
    no kernel does."""
    dst = np.asarray(dst, np.int64)
    width = ell_width(n_v, dst, d_width)
    if len(dst) == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty, width
    indeg = np.bincount(dst, minlength=n_v)
    order = stable_argsort(dst)
    d_sorted = dst[order]
    indptr = np.concatenate([[0], np.cumsum(indeg)])
    rank = np.arange(len(dst), dtype=np.int64) - indptr[d_sorted]
    return order, d_sorted, rank, width


def coo_to_csr(n_v: int, src, dst, w, heavy: int = HEAVY_DEGREE):
    """COO (src -> dst relaxation direction) as host in-edge CSR arrays
    ``(indptr int32[n_v+1], src int32[E], w float32[E], order
    int32[n_v], n_heavy)``: the in-edges of each destination in COO
    order (the ELL rows' order), and the destinations by in-degree,
    heaviest first, the first ``n_heavy`` above ``heavy``."""
    src = np.asarray(src, np.int32)
    w = np.asarray(w, np.float32)
    indeg = np.bincount(np.asarray(dst, np.int64), minlength=n_v)
    edge_order = stable_argsort(np.asarray(dst, np.int64))
    indptr = np.concatenate([[0], np.cumsum(indeg)]).astype(np.int32)
    order = stable_argsort(-indeg).astype(np.int32)
    return (indptr, src[edge_order], w[edge_order], order,
            int((indeg > heavy).sum()))


def coo_to_sliced(n_v: int, src, dst, w):
    """COO (src -> dst relaxation direction) as the host arrays of
    ``SlicedEdges``: ``(order int32[n_v], slice_ptr int32[ceil(n_v /
    32) + 1], src int32[S], w float32[S])``. Destinations go by
    in-degree, heaviest first (``coo_to_csr``'s order); each slice of 32
    is as deep as its largest in-degree; a destination's in-edges keep
    COO order; unused slots hold source 0 and weight +inf."""
    src = np.asarray(src, np.int32)
    w = np.asarray(w, np.float32)
    dst = np.asarray(dst, np.int64)
    indeg = np.bincount(dst, minlength=n_v)
    order = stable_argsort(-indeg)
    n_sl = -(-n_v // SLICE)
    deg = np.zeros(n_sl * SLICE, np.int64)
    deg[:n_v] = indeg[order]
    depth = deg.reshape(n_sl, SLICE).max(1, initial=0)
    slice_ptr = np.concatenate([[0], np.cumsum(depth * SLICE)])
    pos = np.empty(n_v, np.int64)                  # destination -> slot
    pos[order] = np.arange(n_v)
    edge_order = stable_argsort(dst)
    d_sorted = dst[edge_order]
    indptr = np.concatenate([[0], np.cumsum(indeg)])
    rank = np.arange(len(dst), dtype=np.int64) - indptr[d_sorted]
    p = pos[d_sorted]
    slot = slice_ptr[p // SLICE] + rank * SLICE + p % SLICE
    s_out = np.zeros(int(slice_ptr[-1]), np.int32)
    w_out = np.full(int(slice_ptr[-1]), np.inf, np.float32)
    s_out[slot] = src[edge_order]
    w_out[slot] = w[edge_order]
    return (order.astype(np.int32), slice_ptr.astype(np.int32), s_out,
            w_out)


def spmv_relax(dist, csr: RelaxCSR, changed, *, flag_in=None, out=None,
               changed_out=None, flag_out=None, full=True, counts=None,
               backend=None):
    """One synchronous round over the vertex-major frontier ``dist``
    [Vp, R], gathering only the sectors of sources marked in ``changed``
    int16[ceil(R / ROW_TILE), Vp] (8 rows a bit). Outputs not given are
    allocated (``flag_in`` defaults to 1, ``flag_out`` to 0). ``full``
    False lets the kernel leave the sectors of ``out`` that cannot
    change: pass it only with ``out`` holding the round before's input
    (``relax_csr_rounds``). ``counts`` int64[2], if given, gains the
    (tile, vertex) pairs marked in ``changed`` and its set bits when
    ``flag_in`` is 1. Returns (out, changed_out, flag_out)."""
    backend = resolve_backend(backend, dist.device)
    dev = dist.device
    if flag_in is None:
        flag_in = torch.ones(1, dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty_like(dist)
        full = True
    if changed_out is None:
        changed_out = torch.empty_like(changed)
    if flag_out is None:
        flag_out = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (dist, csr, changed, flag_in, out, changed_out, flag_out, full,
            counts)
    if backend == "reference" or not dist.is_cuda:
        return spmv_relax_ref(*args)
    res = spmv_relax_kernel(*args)
    LAUNCHES["spmv_relax_kernel"] += 1
    return res


def fused_relax(dist, edges: SlicedEdges, *, max_rounds: int,
                bq: int = 8):
    """All rounds over the sliced in-edges ``edges``, per ``bq``-row
    block (Q % bq == 0). Returns (fixed-point dist, per-block rounds
    int32[Q // bq])."""
    dist = dist.to(torch.float32).contiguous()
    if not dist.is_cuda:
        return fused_relax_ref(dist, edges, max_rounds, bq)
    out = fused_relax_kernel(dist, edges, max_rounds=max_rounds, bq=bq)
    LAUNCHES["fused_relax_kernel"] += 1
    return out
