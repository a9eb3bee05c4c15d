"""Plain PyTorch versions of the min-plus relaxation kernels."""
import torch

from repro_torch.kernels.spmv_relax.kernel import (ROW_TILE, SECTOR_ROWS,
                                                   SLICE, TILE_SECTORS,
                                                   pack_sectors, sector_bits)

GATHER_ELEMS = 2 ** 25   # [edges, R] gather elements per chunk (128 MB)


def sector_any(mask):
    """bool [Vp, R] -> int16 [ceil(R / ROW_TILE), Vp]: bit j of
    ``[t, v]`` set where any row of sector j of row tile t (rows
    ``t * ROW_TILE + 8j`` to ``+ 7``) is set at v."""
    vp, rows = mask.shape
    n_tiles = -(-rows // ROW_TILE)
    pad = n_tiles * ROW_TILE - rows
    if pad:
        mask = torch.cat([mask, mask.new_zeros(vp, pad)], 1)
    bits = mask.view(vp, n_tiles, TILE_SECTORS, SECTOR_ROWS).any(3)
    return pack_sectors(bits).T.contiguous()


def sector_rows(changed, rows: int):
    """int16 [n_tiles, Vp] -> bool [Vp, rows]: whether each row's sector
    bit is set, per vertex."""
    shift = torch.arange(TILE_SECTORS, dtype=torch.int32,
                         device=changed.device)
    bits = (changed.T.to(torch.int32)[..., None] >> shift) & 1  # [Vp, t, 16]
    return bits.bool().flatten(1).repeat_interleave(SECTOR_ROWS, 1)[:, :rows]


def spmv_relax_ref(dist, csr, changed, flag_in, out, changed_out, flag_out,
                   full=True, counts=None):
    """One Jacobi round over the vertex-major frontier ``dist`` [Vp, R]:
    ``out[v, r] = min(dist[v, r], dist[u, r] + w)`` over the in-edges
    (u -> v, w) of ``csr`` whose source has row r's sector bit set in
    ``changed[r // ROW_TILE, u]`` (int16 sector masks, ``sector_any``).
    ``changed_out[t, v]``: the sectors of tile t that improved at v;
    ``flag_out`` is set to 1 if any entry improved; ``counts`` int64[2],
    if given, gains the pairs with some bit set in ``changed`` and its
    set bits. When ``flag_in`` is 0 the outputs and ``counts`` keep what
    they held. Returns (out, changed_out, flag_out).

    This version writes all of ``out`` whatever ``full`` says; the
    kernel's ``out`` equals it when ``full`` is 1, or when ``out`` held
    ``dist`` at every sector whose ``changed`` bit is 0.

    The min over the in-edges runs in chunks of edges, so memory stays
    O(Vp R); min is exact and order-free, so the result is bitwise the
    kernel's whatever the order."""
    rows = dist.shape[1]
    src = csr.src.long()
    n_edges = src.shape[0]
    dst = torch.searchsorted(
        csr.indptr[1:].long(),
        torch.arange(n_edges, device=dist.device), right=True)
    live_rows = sector_rows(changed, rows)                  # [Vp, R]
    cand = torch.full_like(dist, float("inf"))
    chunk = max(1, GATHER_ELEMS // max(rows, 1))
    for lo in range(0, n_edges, chunk):
        u = src[lo:lo + chunk]
        g = torch.where(live_rows[u], dist[u] + csr.w[lo:lo + chunk, None],
                        float("inf"))
        cand.scatter_reduce_(0, dst[lo:lo + chunk, None].expand_as(g), g,
                             "amin")
    new = torch.minimum(dist, cand)
    improved = new < dist
    go = flag_in.reshape(()) != 0
    out.copy_(torch.where(go, new, out))
    changed_out.copy_(torch.where(go, sector_any(improved), changed_out))
    flag_out |= (go & improved.any()).to(flag_out.dtype)
    if counts is not None:
        counts += go * torch.stack([(changed != 0).sum(),
                                    sector_bits(changed).sum()])
    return out, changed_out, flag_out


def _edge_round(dist, src, dst, w):
    """One Jacobi round over row-major [Q, V] frontiers along the in-edges
    (src[e] -> dst[e], w[e]), in chunks of edges so memory stays
    O(Q V); min is exact and order-free."""
    q = dist.shape[0]
    cand = torch.full_like(dist, float("inf"))
    chunk = max(1, GATHER_ELEMS // max(q, 1))
    for lo in range(0, src.shape[0], chunk):
        g = dist[:, src[lo:lo + chunk]] + w[lo:lo + chunk]
        cand.scatter_reduce_(1, dst[None, lo:lo + chunk].expand_as(g), g,
                             "amin")
    return torch.minimum(dist, cand)


def sliced_dst(edges):
    """int64[S]: the destination of each slot of ``SlicedEdges`` (0 for
    the slots of a last slice's missing lanes, all +inf-weighted)."""
    n_slots = edges.src.shape[0]
    slot = torch.arange(n_slots, device=edges.src.device)
    s = torch.searchsorted(edges.slice_ptr[1:].long(), slot, right=True)
    k = s * SLICE + (slot - edges.slice_ptr[s].long()) % SLICE
    order = torch.cat([edges.order.long(),
                       edges.order.new_zeros(len(edges.slice_ptr) * SLICE)])
    return order[k]


def fused_relax_ref(dist, edges, max_rounds: int, bq: int = 8):
    """All rounds over the sliced in-edges ``edges``, each block of
    ``bq`` rows to its own fixed point or ``max_rounds``. Returns (dist
    [Q, V], rounds int32[Q // bq]). Padding slots weigh +inf and add
    nothing to a min. A block at its fixed point is unchanged by further
    rounds, so the batch runs as one matrix and only the round counts
    are kept per block."""
    q, v = dist.shape
    nb = q // bq
    src, dst = edges.src.long(), sliced_dst(edges)
    rounds = torch.zeros(nb, dtype=torch.int32, device=dist.device)
    active = torch.full((nb,), max_rounds > 0, dtype=torch.bool,
                        device=dist.device)
    d = dist
    for _ in range(max_rounds):
        d2 = _edge_round(d, src, dst, edges.w)
        rounds += active
        active &= (d2 < d).view(nb, bq * v).any(1)
        d = d2
        if not bool(active.any()):
            break
    return d, rounds
