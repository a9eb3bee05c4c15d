"""Padded fixed-shape edge lists (the counterpart of ``repro.graphs.csr``).

Conventions (as in ``repro``):
  * ``n`` real vertices; vertex id ``n`` is the *sentinel* — every padded
    edge has ``src = dst = n`` and ``weight = +inf`` so that segment ops
    with ``num_segments = n + 1`` park padding in a throwaway row.
  * Undirected graphs store both (u,v) and (v,u).
  * ``via`` carries the intermediate vertex of an augmenting edge
    (paper §8.1 path reconstruction); -1 = original edge.

Scatters that JAX writes as ``.at[idx].set(..., mode="drop")`` keep
their parking slot (one extra row or element that is sliced off, or a
sentinel row written with its own fill values): ``index_put_`` picks an
arbitrary winner among duplicate indices, and every duplicate here lands
on such a slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sync import upload
from repro_torch.graphs import segment_ops as sops
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs.trace import count, count_device, spans_on

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class EdgeList:
    src: torch.Tensor      # int32[e_cap]
    dst: torch.Tensor      # int32[e_cap]
    weight: torch.Tensor   # float32[e_cap], +inf padding
    via: torch.Tensor      # int32[e_cap], -1 = original edge
    n_nodes: int

    @property
    def e_cap(self) -> int:
        return self.src.shape[0]

    def valid(self) -> torch.Tensor:
        return self.src < self.n_nodes


def from_host_edges(src, dst, weight, n_nodes: int, e_cap: int | None = None,
                    via=None, device=None) -> EdgeList:
    """Build a padded EdgeList on ``device`` (the card when None) from
    host numpy arrays."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    weight = np.asarray(weight, np.float32)
    e = src.shape[0]
    if e_cap is None:
        e_cap = max(1, e)
    if e > e_cap:
        raise ValueError(f"e_cap={e_cap} < {e} edges")
    pad = e_cap - e
    s = np.concatenate([src, np.full(pad, n_nodes, np.int32)])
    d = np.concatenate([dst, np.full(pad, n_nodes, np.int32)])
    w = np.concatenate([weight, np.full(pad, np.inf, np.float32)])
    if via is None:
        via = np.full(e, -1, np.int32)
    v = np.concatenate([np.asarray(via, np.int32), np.full(pad, -1, np.int32)])
    return EdgeList(upload(s, device), upload(d, device), upload(w, device),
                    upload(v, device), n_nodes=n_nodes)


def _set_flat(size: int, fill, idx, vals):
    """``full(size, fill).at[idx].set(vals)`` — every duplicate of
    ``idx`` writes the same value or lands on a slot the caller drops."""
    out = torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out


def neighbor_matrix(g: EdgeList, d_cap: int):
    """Dense padded adjacency: for each vertex a row of up to ``d_cap``
    (neighbor, weight, via) triples. Vertices with degree > d_cap keep an
    arbitrary d_cap-subset with ``overflow[v] = True``.

    Returns (nbr_ids [n+1, d_cap] int32 (sentinel pad), nbr_w, nbr_via,
    overflow [n] bool).
    """
    n, e_cap = g.n_nodes, g.e_cap
    order = torch.sort(g.src, stable=True).indices        # group by src
    s_sorted = g.src[order]
    idx = torch.arange(e_cap, dtype=torch.int32, device=g.src.device)
    first_of_group = sops.segment_min(idx, s_sorted, n + 1)
    rank = idx - first_of_group[s_sorted.long()]
    ok = (s_sorted < n) & (rank < d_cap)
    # park non-entries at the sentinel row, written with its own fills
    flat = torch.where(ok, s_sorted * d_cap + rank, n * d_cap)
    size = (n + 1) * d_cap
    nbr_ids = _set_flat(size, n, flat, torch.where(ok, g.dst[order], n))
    nbr_w = _set_flat(size, INF, flat, torch.where(ok, g.weight[order], INF))
    nbr_via = _set_flat(size, -1, flat, torch.where(ok, g.via[order], -1))
    deg = sops.count_per_segment(g.src, n + 1, mask=g.valid())[:n]
    overflow = deg > d_cap
    return (nbr_ids.view(n + 1, d_cap), nbr_w.view(n + 1, d_cap),
            nbr_via.view(n + 1, d_cap), overflow)


def compact(keep, size: int, *cols):
    """Stable compaction of ``(values, fill)`` columns under ``keep``
    into fixed ``size`` arrays, through a parking slot ``size`` that is
    sliced off. Returns the compacted columns."""
    pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    tgt = torch.where(keep & (pos < size), pos, size)
    return [_set_flat(size + 1, fill, tgt, torch.where(keep, vals, fill))[:size]
            for vals, fill in cols]


def dedup_min_edges(src, dst, weight, via, n_nodes: int, out_cap: int):
    """Sort (src,dst) pairs, collapse duplicates keeping min weight (and
    its ``via``), compact into fixed ``out_cap`` arrays.

    ``jnp.lexsort((dst, src))`` is one stable sort of the int64 key
    ``src*(n+1)+dst``; stability keeps the tie order. Returns
    (src, dst, w, via, n_unique) — n_unique may exceed out_cap, callers
    must check (overflow detection). Counts ``build.dedup_slots`` (the
    slots it sorts) and ``build.dedup_live`` (those with src < n).
    """
    t = src.shape[0]
    count("build.dedup_slots", t)
    if spans_on():
        count_device("build.dedup_live",
                     (src < n_nodes).sum(dtype=torch.int64))
    key = src.long() * (n_nodes + 1) + dst.long()
    order = torch.sort(key, stable=True).indices
    del key
    s, d, w, v = src[order], dst[order], weight[order], via[order]
    del order
    is_first = torch.ones(t, dtype=torch.bool, device=src.device)
    is_first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    gid = torch.cumsum(is_first, 0, dtype=torch.int32) - 1    # group index
    gmin = sops.segment_min(w, gid, t)
    gvia = sops.segment_argmin_take(w, v, gid, t)
    valid_group = is_first & (s < n_nodes)
    gl = gid.long()
    o_src, o_dst, o_w, o_via = compact(
        valid_group, out_cap, (s, n_nodes), (d, n_nodes), (gmin[gl], INF),
        (gvia[gl], -1))
    n_unique = valid_group.sum(dtype=torch.int32)
    return o_src, o_dst, o_w, o_via, n_unique
