"""Bindings of the hand-written relaxation kernels (``csrc/spmv_relax.cu``
and ``csrc/fused_relax.cu``; the design notes are in those files). They
replace the Pallas ``spmv_relax_kernel`` and ``fused_relax_kernel`` of
``repro/kernels/spmv_relax/kernel.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

FUSED_BQ = 8        # rows per fused block (fixed in the CUDA source)
ROW_TILE = 128      # frontier rows per work item (fixed in the CUDA source)
HEAVY_DEGREE = 256  # in-degree above which a hub takes a whole block


class RelaxCSR(NamedTuple):
    """In-edges of the core graph by destination, for ``spmv_relax``.

    ``indptr`` int32[Vp+1], ``src`` int32[E], ``w`` float32[E]: the
    in-edges of destination v are ``src/w[indptr[v]:indptr[v+1]]``.
    ``order`` int32[Vp]: every destination, by in-degree, heaviest first;
    the first ``n_heavy`` (in-degree > ``HEAVY_DEGREE``) take a whole
    CUDA block each."""
    indptr: torch.Tensor
    src: torch.Tensor
    w: torch.Tensor
    order: torch.Tensor
    n_heavy: int


def _check_ell(dist, nbr_ids, nbr_w):
    _build.require(dist, "dist", torch.float32, 2)
    _build.require(nbr_ids, "nbr_ids", torch.int32, 2)
    _build.require(nbr_w, "nbr_w", torch.float32, 2)
    if nbr_ids.shape != nbr_w.shape or nbr_ids.shape[0] != dist.shape[1]:
        raise ValueError(f"ELL planes {tuple(nbr_ids.shape)} / "
                         f"{tuple(nbr_w.shape)} do not fit dist "
                         f"{tuple(dist.shape)}")


def _check_flag(t, name):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32 or t.numel() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be one contiguous int32, got "
                         f"{t.dtype} {tuple(t.shape)}")


def spmv_relax_kernel(dist, csr: RelaxCSR, changed, flag_in, out,
                      changed_out, flag_out):
    """One synchronous round over the vertex-major frontier ``dist``
    float32[Vp, R] (R % 8 == 0), gathering only from sources marked in
    ``changed`` bool[ceil(R / ROW_TILE), Vp]. Writes ``out`` [Vp, R] and
    ``changed_out`` (which (tile, vertex) improved) and sets ``flag_out``
    int32[1] to 1 if any entry improved; when ``flag_in`` is 0 it writes
    nothing. Returns (out, changed_out, flag_out)."""
    _build.require(dist, "dist", torch.float32, 2)
    _build.require(out, "out", torch.float32, 2)
    _build.require(csr.indptr, "indptr", torch.int32, 1)
    _build.require(csr.src, "src", torch.int32, 1)
    _build.require(csr.w, "w", torch.float32, 1)
    _build.require(csr.order, "order", torch.int32, 1)
    _build.require(changed, "changed", torch.bool, 2)
    _build.require(changed_out, "changed_out", torch.bool, 2)
    _check_flag(flag_in, "flag_in")
    _check_flag(flag_out, "flag_out")
    vp, rows = dist.shape
    if rows % 8:
        raise ValueError(f"spmv_relax_kernel needs R % 8 == 0, got R={rows}")
    n_tiles = -(-rows // ROW_TILE)
    if (out.shape != dist.shape
            or changed.shape != (n_tiles, vp)
            or changed_out.shape != (n_tiles, vp)
            or csr.indptr.shape != (vp + 1,) or csr.order.shape != (vp,)
            or csr.src.shape != csr.w.shape
            or not 0 <= csr.n_heavy <= vp):
        raise ValueError(
            f"operands do not fit dist {tuple(dist.shape)}: "
            f"out {tuple(out.shape)}, changed {tuple(changed.shape)} / "
            f"{tuple(changed_out.shape)}, indptr {tuple(csr.indptr.shape)}, "
            f"order {tuple(csr.order.shape)}, src {tuple(csr.src.shape)}, "
            f"w {tuple(csr.w.shape)}, n_heavy {csr.n_heavy}")
    if out.data_ptr() == dist.data_ptr():
        raise ValueError("out must not alias dist")
    _build.launch("islabel_spmv_relax", dist, csr.indptr, csr.src, csr.w,
                  csr.order, csr.n_heavy, changed, flag_in, out, changed_out,
                  flag_out, rows, vp)
    return out, changed_out, flag_out


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
