"""Bindings of the hand-written ELL relaxation kernels
(``csrc/spmv_relax.cu``; the design note is in that file). They replace
the Pallas ``spmv_relax_kernel`` and ``fused_relax_kernel`` of
``repro/kernels/spmv_relax/kernel.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

FUSED_BQ = 8        # rows per fused block (fixed in the CUDA source)


def _check_ell(dist, nbr_ids, nbr_w):
    _build.require(dist, "dist", torch.float32, 2)
    _build.require(nbr_ids, "nbr_ids", torch.int32, 2)
    _build.require(nbr_w, "nbr_w", torch.float32, 2)
    if nbr_ids.shape != nbr_w.shape or nbr_ids.shape[0] != dist.shape[1]:
        raise ValueError(f"ELL planes {tuple(nbr_ids.shape)} / "
                         f"{tuple(nbr_w.shape)} do not fit dist "
                         f"{tuple(dist.shape)}")


def spmv_relax_kernel(dist, nbr_ids, nbr_w):
    """One synchronous round. dist: [Q, V] f32; nbr_ids: [V, D] int32 in
    [0, V); nbr_w: [V, D] (+inf padding). Any Q and V. Returns the
    relaxed [Q, V]."""
    _check_ell(dist, nbr_ids, nbr_w)
    q, v = dist.shape
    out = torch.empty_like(dist)
    _build.launch("islabel_spmv_relax", dist, nbr_ids, nbr_w, out, q, v,
                  nbr_ids.shape[1])
    return out


def fused_relax_kernel(dist, nbr_ids, nbr_w, *, max_rounds: int,
                       bq: int = FUSED_BQ):
    """All relaxation rounds in one launch. dist: [Q, V] f32 seeds with
    Q % 8 == 0. Returns (fixed-point dist [Q, V], per-block rounds
    int32[Q // 8])."""
    if bq != FUSED_BQ:
        raise ValueError(f"the CUDA fused kernel takes bq={FUSED_BQ}, got {bq}")
    _check_ell(dist, nbr_ids, nbr_w)
    q, v = dist.shape
    if q % bq:
        raise ValueError(f"fused_relax_kernel needs Q % {bq} == 0, got Q={q}")
    out = torch.empty_like(dist)
    scratch = torch.empty_like(dist)
    rounds = torch.empty(q // bq, dtype=torch.int32, device=dist.device)
    _build.launch("islabel_fused_relax", dist, nbr_ids, nbr_w, out, scratch,
                  rounds, q, v, nbr_ids.shape[1], max_rounds)
    return out, rounds


def fused_vmem_bytes(v: int, d_width: int, bq: int = 8) -> int:
    """The TPU working-set model of one fused grid step, kept verbatim
    from ``repro`` so the port takes the same route as ``repro`` on the
    same index (``core/dispatch.py``): the [bq, V] block (x2 for the
    carry copy), the ELL planes, and the gather intermediate [bq, V, D]."""
    return 4 * (2 * bq * v + 2 * v * d_width + bq * v * d_width)
