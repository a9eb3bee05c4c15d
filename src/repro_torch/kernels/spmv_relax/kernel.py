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
SECTOR_ROWS = 8     # frontier rows a mask bit: one 32-byte sector
TILE_SECTORS = ROW_TILE // SECTOR_ROWS  # mask bits a (tile, vertex)
# a (tile, vertex) mask word: bit j is sector j of the tile; the kernel
# reads it as uint16
MASK_DTYPE = torch.int16
HEAVY_DEGREE = 256  # in-degree above which a hub takes a whole block
SLICE = 32          # fused destinations a slice (a warp; fixed in the source)


def pack_sectors(bits):
    """bool [..., TILE_SECTORS] -> ``MASK_DTYPE`` [...]: bit j set where
    ``bits[..., j]`` is (bit 15 is the int16's sign bit)."""
    shift = torch.arange(TILE_SECTORS, dtype=torch.int32, device=bits.device)
    word = (bits.to(torch.int32) << shift).sum(-1, dtype=torch.int32)
    return (word - ((word >> 15) << 16)).to(MASK_DTYPE)


def sector_bits(mask):
    """``MASK_DTYPE`` [...] -> int32 [...]: the set bits of each word
    (its 8-row sectors that are marked)."""
    word = mask.to(torch.int32) & 0xFFFF
    return sum((word >> j) & 1 for j in range(TILE_SECTORS))


class RelaxCSR(NamedTuple):
    """In-edges of the core graph by destination, for ``spmv_relax`` and
    ``fused_relax``.

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


class SlicedEdges(NamedTuple):
    """In-edges of the core graph for ``fused_relax``, sliced: slot k
    holds destination ``order[k]`` (destinations by in-degree, heaviest
    first), 32 slots to a slice (one warp). Edge j of slot k is at
    ``slice_ptr[k // 32] + 32 * j + k % 32`` in ``src`` / ``w``; a slice
    is as deep as its largest in-degree, and the slots past a
    destination's in-degree hold source 0 and weight +inf.

    ``order`` int32[V], ``slice_ptr`` int32[ceil(V / 32) + 1], ``src``
    int32[S], ``w`` float32[S]."""
    order: torch.Tensor
    slice_ptr: torch.Tensor
    src: torch.Tensor
    w: torch.Tensor


def _check_flag(t, name, dtype=torch.int32, n=1):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be {n} contiguous {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def spmv_relax_kernel(dist, csr: RelaxCSR, changed, flag_in, out,
                      changed_out, flag_out, full=True, counts=None):
    """One synchronous round over the vertex-major frontier ``dist``
    float32[Vp, R] (R % 8 == 0), gathering only the sectors of sources
    marked in ``changed`` int16[ceil(R / ROW_TILE), Vp] (bit j of
    ``changed[t, u]``: rows 8j..8j+7 of row tile t changed at u). Writes
    ``changed_out`` (which sectors of each (tile, vertex) improved) and
    ``out`` [Vp, R], and sets ``flag_out`` int32[1] to 1 if any entry
    improved; when ``flag_in`` is 0 it writes nothing.

    ``full`` 1 loads and stores every sector of ``out``. With ``full``
    0 the kernel stores only the sectors whose ``changed`` bit is set or
    that improved, so ``out`` equals the plain version's only if it held
    ``dist`` at every sector whose bit is 0: the buffer of the round
    before, as ``relax_csr_rounds`` passes it.

    ``counts`` int64[2], if given, gains the (tile, vertex) pairs with
    some bit set in ``changed`` and the bits set in it, unless
    ``flag_in`` is 0. Returns (out, changed_out, flag_out)."""
    _build.require(dist, "dist", torch.float32, 2)
    _build.require(out, "out", torch.float32, 2)
    _build.require(csr.indptr, "indptr", torch.int32, 1)
    _build.require(csr.src, "src", torch.int32, 1)
    _build.require(csr.w, "w", torch.float32, 1)
    _build.require(csr.order, "order", torch.int32, 1)
    _build.require(changed, "changed", MASK_DTYPE, 2)
    _build.require(changed_out, "changed_out", MASK_DTYPE, 2)
    _check_flag(flag_in, "flag_in")
    _check_flag(flag_out, "flag_out")
    if counts is not None:
        _check_flag(counts, "counts", torch.int64, 2)
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
                  flag_out, counts, int(bool(full)), rows, vp)
    return out, changed_out, flag_out


# the fused kernel's variants (``csrc/fused_relax.cu``), by the C entry
# point's index: the block's rows and flags in shared memory, or in
# device scratch
FUSED_VARIANTS = {"shared": 0, "global": 1}
SMEM_BLOCK_BYTES = 232_448       # shared memory one block may use on Hopper
VERTEX_BYTES = 4 * FUSED_BQ + 1  # one vertex's rows and changed flag


def fused_variant(v: int) -> str:
    """The fused kernel's variant for a core of ``v`` (padded) vertices:
    "shared" while two buffers of rows and flags fit one block's shared
    memory, else "global"."""
    return ("shared" if 2 * v * VERTEX_BYTES <= SMEM_BLOCK_BYTES
            else "global")


def fused_relax_kernel(dist, edges: SlicedEdges, *, max_rounds: int,
                       bq: int = FUSED_BQ, variant: str | None = None):
    """All relaxation rounds in one launch over the sliced in-edges
    ``edges``. dist: [Q, V] f32 seeds with Q % 8 == 0. ``variant``
    defaults to ``fused_variant(V)``. Returns (fixed-point dist [Q, V],
    per-block rounds int32[Q // 8])."""
    if bq != FUSED_BQ:
        raise ValueError(f"the CUDA fused kernel takes bq={FUSED_BQ}, got {bq}")
    _build.require(dist, "dist", torch.float32, 2)
    _build.require(edges.order, "order", torch.int32, 1)
    _build.require(edges.slice_ptr, "slice_ptr", torch.int32, 1)
    _build.require(edges.src, "src", torch.int32, 1)
    _build.require(edges.w, "w", torch.float32, 1)
    q, v = dist.shape
    if q % bq:
        raise ValueError(f"fused_relax_kernel needs Q % {bq} == 0, got Q={q}")
    if (edges.order.shape != (v,)
            or edges.slice_ptr.shape != (-(-v // SLICE) + 1,)
            or edges.src.shape != edges.w.shape):
        raise ValueError(
            f"sliced edges do not fit dist {tuple(dist.shape)}: order "
            f"{tuple(edges.order.shape)}, slice_ptr "
            f"{tuple(edges.slice_ptr.shape)}, src {tuple(edges.src.shape)}, "
            f"w {tuple(edges.w.shape)}")
    variant = fused_variant(v) if variant is None else variant
    if variant not in FUSED_VARIANTS:
        raise ValueError(f"unknown fused variant {variant!r}; expected one "
                         f"of {sorted(FUSED_VARIANTS)}")
    out = torch.empty_like(dist)
    # the global variant's two [V, 8] row buffers and two [V] flag
    # buffers a block
    n_scratch = 2 * q * v if variant == "global" else 0
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dist.device)
    scratch_chg = torch.empty(n_scratch // FUSED_BQ, dtype=torch.uint8,
                              device=dist.device)
    rounds = torch.empty(q // bq, dtype=torch.int32, device=dist.device)
    _build.launch("islabel_fused_relax", dist, edges.order, edges.slice_ptr,
                  edges.src, edges.w, out, scratch, scratch_chg, rounds, q, v,
                  max_rounds, FUSED_VARIANTS[variant])
    return out, rounds


def fused_vmem_bytes(v: int, d_width: int, bq: int = 8) -> int:
    """The TPU working-set model of one fused grid step, kept verbatim
    from ``repro`` so the port takes the same route as ``repro`` on the
    same index (``core/dispatch.py``): the [bq, V] block (x2 for the
    carry copy), the ELL planes, and the gather intermediate [bq, V, D]."""
    return 4 * (2 * bq * v + 2 * v * d_width + bq * v * d_width)
