"""Wrappers of the ELL relaxation kernels (stage 2 of a query) and the
COO -> ELL conversion.

``spmv_relax`` replaces ``repro/kernels/spmv_relax/kernel.py:
spmv_relax_kernel`` (one round per launch, the route of large cores);
``fused_relax`` replaces ``fused_relax_kernel`` (all rounds in one
launch, per 8-row block). Bound on Hopper: bytes, as random gathers of
frontier rows through L2; the CUDA kernels serve 8 rows from each load
of a vertex's ELL slots and skip padding slots
(``csrc/spmv_relax.cu``).

On a CUDA tensor a wrapper launches its kernel, or raises; on a CPU
tensor it runs the kernel's plain version (``ref.py``). ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.spmv_relax.kernel import (fused_relax_kernel,
                                                   spmv_relax_kernel)
from repro_torch.kernels.spmv_relax.ref import fused_relax_ref, spmv_relax_ref

LAUNCHES = {"spmv_relax_kernel": 0, "fused_relax_kernel": 0}


def ell_layout(n_v: int, dst, d_width: int = 16):
    """Slot assignment for the ELL conversion: stable-sort edges by dst,
    each edge's slot is its rank within the dst group (position minus
    the group's CSR offset). Returns ``(order, rows, slots, width)``.
    """
    dst = np.asarray(dst, np.int64)
    indeg = np.bincount(dst, minlength=n_v)
    width = max(d_width, int(-(-max(1, indeg.max(initial=0)) // d_width)
                             * d_width))
    if len(dst) == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty, width
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    indptr = np.concatenate([[0], np.cumsum(indeg)])
    rank = np.arange(len(dst), dtype=np.int64) - indptr[d_sorted]
    return order, d_sorted, rank, width


def coo_to_ell(n_v: int, src, dst, w, d_width: int = 16):
    """COO (src -> dst relaxation direction) as host ELL planes
    ``(ids int32[n_v, width], w float32[n_v, width])``, width = max
    in-degree rounded up to a multiple of d_width; padding has id 0 and
    weight +inf."""
    src = np.asarray(src, np.int32)
    w = np.asarray(w, np.float32)
    order, rows, slots, width = ell_layout(n_v, dst, d_width)
    ids = np.zeros((n_v, width), np.int32)
    ws = np.full((n_v, width), np.inf, np.float32)
    if len(src):
        ids[rows, slots] = src[order]
        ws[rows, slots] = w[order]
    return ids, ws


def spmv_relax(dist, nbr_ids, nbr_w, *, backend=None):
    """One synchronous relaxation round, any [Q, V]."""
    backend = resolve_backend(backend, dist.device)
    dist = dist.to(torch.float32).contiguous()
    if backend == "reference" or not dist.is_cuda:
        return spmv_relax_ref(dist, nbr_ids, nbr_w)
    out = spmv_relax_kernel(dist, nbr_ids, nbr_w)
    LAUNCHES["spmv_relax_kernel"] += 1
    return out


def fused_relax(dist, nbr_ids, nbr_w, *, max_rounds: int, bq: int = 8):
    """All rounds, per ``bq``-row block (Q % bq == 0). Returns
    (fixed-point dist, per-block rounds int32[Q // bq])."""
    dist = dist.to(torch.float32).contiguous()
    if not dist.is_cuda:
        return fused_relax_ref(dist, nbr_ids, nbr_w, max_rounds, bq)
    out = fused_relax_kernel(dist, nbr_ids, nbr_w, max_rounds=max_rounds,
                             bq=bq)
    LAUNCHES["fused_relax_kernel"] += 1
    return out
