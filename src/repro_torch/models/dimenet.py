"""DimeNet (directional message passing, arXiv:2003.03123): the port of
``repro.models.dimenet``.

Kernel regime: *triplet gather* — messages live on directed edges
(j -> i) and are updated from incoming messages (k -> j) modulated by an
angular basis over the (k, j, i) triplet. Not expressible as SpMM; the
triplet index lists are explicit inputs (``build_triplets``, on the
host).

Basis functions: radial Bessel-style envelope RBF (n_radial) and a
separable radial x angular SBF (n_spherical x n_radial) using cos(l*θ)
Chebyshev angular modes, with the spherical-Bessel zeros simplified to
integer frequencies, as in ``repro``.

``DimeNet``'s parameter names are ``repro``'s tree paths (``emb_atom``,
``emb_rbf.w``, ``emb_msg.l0.w``, ``blk0.w_kj.w``, ``blk0.bilinear``,
``blk0.mlp.l1.b``, ``out0.l1.w``, ...). Every sentinel id is clamped
where ``repro`` clamps it (triplets at ``e``, atomic numbers at 94), so
no gather or scatter sees an id past its table. On a mesh (a
``GraphSplit``, ``distributed/sharding.py``) the messages are
edge-sharded like the edges, the triplets split in blocks of their own:
a block gathers ``m @ w_kj`` whole, reads its own triplets' rows, and
reduce-scatters the ``segment_sum`` over ``trip_ji`` back to edge
blocks; the atom sum is reduce-scattered to node blocks. ``jnp.maximum``,
``jnp.minimum`` and ``jnp.clip`` on floats are ``torch.maximum`` and
``torch.minimum`` (both split a tie's gradient in half, as jnp does).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import GraphSplit
from repro_torch.graphs import segment_ops as sops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_out: int = 1
    envelope_p: int = 6


def _max(x, c: float):
    # new_full fills on the device: no host copy, no sync
    return torch.maximum(x, x.new_full((), c))


def _min(x, c: float):
    return torch.minimum(x, x.new_full((), c))


def rbf_basis(d, cfg: DimeNetConfig):
    """[E] -> [E, n_radial] Bessel RBF with polynomial envelope."""
    x = d / cfg.cutoff
    p = cfg.envelope_p
    env = (1.0 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=d.device)
    scale = torch.sqrt(d.new_full((), 2.0 / cfg.cutoff))
    basis = scale * torch.sin(n[None, :] * math.pi * x[:, None]) \
        / _max(d[:, None], 1e-9)
    return basis * env[:, None]


def sbf_basis(d, angle, cfg: DimeNetConfig):
    """[T],[T] -> [T, n_spherical * n_radial] separable angular basis."""
    rad = rbf_basis(d, cfg)                                # [T, R]
    l = torch.arange(cfg.n_spherical, dtype=torch.float32, device=d.device)
    ang = torch.cos(l[None, :] * angle[:, None])           # [T, S]
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        d.shape[0], cfg.n_spherical * cfg.n_radial)


def bilinear_interaction(sb, bilinear, m_kj):
    """``einsum("tb,bhg,th->tg", sb, bilinear, m_kj)`` in a fixed order:
    ``m_kj`` against the [h, b*g] bilinear tensor (one GEMM, [T, b*g]),
    then the sum over b weighted by ``sb`` (a batched [1, b] x [b, g]
    product). Contracting ``sb`` with ``bilinear`` first would build a
    [T, h, g] intermediate (4.3 GB a block at T = 65,536, h = 128)."""
    b, h, g = bilinear.shape
    t = m_kj.shape[0]
    y = m_kj @ bilinear.permute(1, 0, 2).reshape(h, b * g)   # [T, b*g]
    return torch.bmm(sb[:, None, :], y.view(t, b, g))[:, 0]


def dimenet_axes(cfg: DimeNetConfig) -> dict:
    """``repro``'s ``init_dimenet`` axes."""
    a = {"emb_atom": ("gnn_in", "gnn_hidden"), "emb_rbf": L.linear_axes(),
         "emb_msg": L.mlp_axes(1)}
    for i in range(cfg.n_blocks):
        a[f"blk{i}"] = {
            "w_rbf": {"w": ("rbf", "gnn_hidden")},
            "w_sbf": {"w": ("sbf", "bilinear")},
            "w_kj": {"w": ("gnn_hidden", "gnn_hidden")},
            "w_ji": {"w": ("gnn_hidden", "gnn_hidden")},
            "bilinear": ("bilinear", "gnn_hidden", "gnn_hidden"),
            "mlp": L.mlp_axes(2),
        }
        a[f"out{i}"] = L.mlp_axes(2)
    return a


class _Block(nn.Module):
    def __init__(self, cfg: DimeNetConfig, generator=None):
        super().__init__()
        h, r, s, b = cfg.d_hidden, cfg.n_radial, cfg.n_spherical, \
            cfg.n_bilinear
        self.w_rbf = L.Linear(r, h, generator=generator)
        self.w_sbf = L.Linear(s * r, b, generator=generator)
        self.w_kj = L.Linear(h, h, generator=generator)
        self.w_ji = L.Linear(h, h, generator=generator)
        self.bilinear = nn.Parameter(
            torch.empty((b, h, h)) if generator is None
            else torch.randn((b, h, h), generator=generator) / h)
        self.mlp = L.MLP([h, h, h], generator=generator)


class DimeNet(nn.Module):
    """Built without a generator it is a structure for
    ``torch.func.functional_call``; with one, its parameters are drawn
    in ``repro``'s order and at its scale (other values than
    ``jax.random``'s)."""

    def __init__(self, cfg: DimeNetConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        h, r = cfg.d_hidden, cfg.n_radial
        self.emb_atom = L._dense_init((95, h), generator)   # atomic numbers
        self.emb_rbf = L.Linear(r, h, generator=generator)
        self.emb_msg = L.MLP([3 * h, h], generator=generator)
        for i in range(cfg.n_blocks):
            setattr(self, f"blk{i}", _Block(cfg, generator))
            setattr(self, f"out{i}", L.MLP([h, h, cfg.n_out],
                                           generator=generator))

    def forward(self, z, coords, edge_src, edge_dst, trip_kj, trip_ji,
                split=None):
        """z: int32[n+1] atomic numbers; coords: [n+1, 3]. edge_*:
        int32[E] (sentinel n). trip_kj/trip_ji: int32[T] indices into
        the edge list: message (k->j) feeds message (j->i) (sentinel E).
        Returns (node_out [n+1, n_out], messages) — callers pool.
        ``split``: the ``GraphSplit`` of a mesh step (the module
        docstring)."""
        cfg = self.cfg
        split = split or GraphSplit(z.shape[0], edge_src.shape[0])
        n1, e = split.nodes, split.edges
        act = F.silu
        es, ed = edge_src.long(), edge_dst.long()
        kj = torch.clamp(trip_kj.long(), max=e - 1)
        ji = torch.clamp(trip_ji.long(), max=e - 1)

        xa = split.whole(coords)
        diff = xa.index_select(0, es) - xa.index_select(0, ed)
        dist = torch.sqrt(_max(torch.sum(diff * diff, -1), 1e-12))
        rbf = rbf_basis(dist, cfg)                          # [E, R]

        # triplet angle between edge (k->j) and (j->i)
        diff_all, dist_all = split.whole(diff), split.whole(dist)
        d1 = diff_all.index_select(0, kj)
        d2 = -diff_all.index_select(0, ji)
        cosang = torch.sum(d1 * d2, -1) / _max(
            torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1),
            1e-9)
        angle = torch.arccos(_min(_max(cosang, -1 + 1e-7), 1 - 1e-7))
        d_kj = dist_all.index_select(0, kj)
        sbf = sbf_basis(d_kj, angle, cfg)                   # [T, S*R]
        trip_ok = (trip_kj < e) & (trip_ji < e)
        sbf = torch.where(trip_ok[:, None], sbf, 0.0)

        za = split.whole(z)
        hz = self.emb_atom.index_select(0, torch.clamp(za.long(), max=94))
        m = self.emb_msg(torch.cat(
            [hz.index_select(0, es), hz.index_select(0, ed),
             self.emb_rbf(rbf)], -1), act=act)              # [E, H]

        seg_ji = torch.clamp(trip_ji.long(), max=e)
        out = torch.zeros((z.shape[0], cfg.n_out), dtype=torch.float32,
                          device=coords.device)
        for i in range(cfg.n_blocks):
            blk = getattr(self, f"blk{i}")
            # directional interaction: m_kj -> (j->i), modulated by sbf
            m_kj = split.whole(m @ blk.w_kj.w).index_select(0, kj)
            sb = sbf @ blk.w_sbf.w                          # [T, B]
            inter = bilinear_interaction(sb, blk.bilinear, m_kj)
            agg = split.to_block(sops.segment_sum(
                torch.where(trip_ok[:, None], inter, 0.0), seg_ji,
                e + 1)[:e])                                 # [E, H]
            m = act(m @ blk.w_ji.w + agg * (rbf @ blk.w_rbf.w))
            m = m + blk.mlp(m, act=act)
            # per-block output: aggregate messages to atoms
            atom = split.to_block(sops.segment_sum(m, ed, n1))
            out = out + getattr(self, f"out{i}")(atom, act=act)
        return out, m


def build_triplets(edge_src, edge_dst, n, t_cap: int):
    """Host helper: triplet indices (k->j, j->i) with k != i.
    Returns (trip_kj, trip_ji) int32[t_cap], sentinel = len(edges)."""
    e = len(edge_src)
    by_dst = {}
    for idx in range(e):
        by_dst.setdefault(int(edge_dst[idx]), []).append(idx)
    kj, ji = [], []
    for idx in range(e):
        j = int(edge_src[idx])          # edge (j -> i)
        for kidx in by_dst.get(j, []):
            if int(edge_src[kidx]) != int(edge_dst[idx]):   # k != i
                kj.append(kidx)
                ji.append(idx)
    kj, ji = kj[:t_cap], ji[:t_cap]
    pad = t_cap - len(kj)
    return (np.asarray(kj + [e] * pad, np.int32),
            np.asarray(ji + [e] * pad, np.int32))
