"""GNN zoo: GCN (spectral), GraphSAGE (sampled mean-agg), EGNN (E(n)-
equivariant) — the port of ``repro.models.gnn``. Message passing is
``gather -> elementwise -> segment_sum/mean`` over explicit edge
indices (``graphs/segment_ops.py``), as in ``repro``.

Edge conventions match ``repro.graphs.csr``: sentinel-padded fixed
shapes; padding edges point at row ``n``, which aggregation fills and
the loss masks away. Rows are gathered with ``index_select``, whose
backward is an ``index_add_`` (atomics on the card): the backward of
``x[idx]`` sorts the indices and accumulates duplicates serially, which
took 1.5 ms a call on ``gcn-cora``'s 21,504 edges on an H100
(``chip_smoke.py``'s ``train_gcn-cora`` profile; PERF.md §6). Each
model is an ``nn.Module`` whose parameter names are ``repro``'s tree
paths (``w0``; ``self0``/``nbr0``; ``embed``, ``phi_e0.l0.w``,
``out.l1.b``). Built without a generator it is a structure for ``torch.func.functional_call``; with one, its
parameters are drawn in the order ``repro`` initialises them, at the
same scale (the values differ from ``jax.random``'s).

On a mesh each forward takes a ``GraphSplit``
(``distributed/sharding.py``): the arrays are this rank's blocks of
nodes and edges (``repro``'s ``GNN_RULES``), the dense products run on
the node block, and a layer gathers the node rows its edges read whole,
computes its own edges' messages, and reduce-scatters their
``segment_sum`` (every node row, the sentinel's too) back to node
blocks (SAGE's max aggregator: a ``MAX`` reduce-scatter of each
rank's partial maxima). Off a mesh the split is the identity, and the
arithmetic is the unsharded one.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import GraphSplit
from repro_torch.graphs import segment_ops as sops
from repro_torch.models import layers as L


# ------------------------------------------------------------------- GCN
@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    norm: str = "sym"


def gcn_axes(cfg) -> dict:
    return {f"w{i}": ("gnn_in", "gnn_hidden") for i in range(cfg.n_layers)}


def sage_axes(cfg) -> dict:
    a = {}
    for i in range(cfg.n_layers):
        a[f"self{i}"] = ("gnn_in", "gnn_hidden")
        a[f"nbr{i}"] = ("gnn_in", "gnn_hidden")
    return a


def egnn_axes(cfg) -> dict:
    a = {"embed": ("gnn_in", "gnn_hidden")}
    for i in range(cfg.n_layers):
        for name in ("phi_e", "phi_x", "phi_h"):
            a[f"{name}{i}"] = L.mlp_axes(2)
    a["out"] = L.mlp_axes(2)
    return a


class GCN(nn.Module):
    def __init__(self, cfg: GCNConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [cfg.n_classes]
        for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"w{i}", L._dense_init((di, do), generator))

    def forward(self, x, edge_src, edge_dst, deg, split=None):
        """x: [n+1, d_in] (sentinel row 0s); edges sentinel-padded to n.
        deg: [n+1] degrees (>=1). Symmetric normalization
        D^-1/2 A D^-1/2. ``split``: the ``GraphSplit`` of a mesh step
        (the module docstring)."""
        split = split or GraphSplit(x.shape[0], edge_src.shape[0])
        n1 = split.nodes
        es, ed = edge_src.long(), edge_dst.long()
        inv_sqrt = torch.rsqrt(torch.clamp(deg.to(torch.float32), min=1.0))
        inv_all = split.whole(inv_sqrt)
        for i in range(self.cfg.n_layers):
            h = split.whole(x @ getattr(self, f"w{i}"))
            msg = h.index_select(0, es) * inv_all.index_select(0, es)[:, None]
            agg = split.to_block(sops.segment_sum(msg, ed, n1))
            x = agg * inv_sqrt[:, None]
            if i < self.cfg.n_layers - 1:
                x = torch.relu(x)
        return x


# --------------------------------------------------------------- GraphSAGE
@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    aggregator: str = "mean"
    fanouts: tuple = (25, 10)


class SAGE(nn.Module):
    def __init__(self, cfg: SAGEConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [cfg.n_classes]
        for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
            # W_self and W_neigh (concat formulation)
            setattr(self, f"self{i}", L._dense_init((di, do), generator))
            setattr(self, f"nbr{i}", L._dense_init((di, do), generator))

    def layer(self, i, x_src, x_dst, es, ed, split, cnt):
        """``split``: the graph's ``GraphSplit`` (``x_src`` whole, ``x_dst``
        this rank's node block); ``cnt``: the block's in-degrees (the
        mean aggregator's, ``in_degrees``)."""
        msg = x_src.index_select(0, es)
        if self.cfg.aggregator == "mean":
            agg = split.to_block(sops.segment_sum(msg, ed, split.nodes)) \
                / cnt.clamp(min=1.0)[:, None]
        else:
            agg = split.segment_max(msg, ed)
            agg = torch.where(torch.isfinite(agg), agg, 0.0)
        return x_dst @ getattr(self, f"self{i}") \
            + agg @ getattr(self, f"nbr{i}")

    def forward(self, x, edge_src, edge_dst, split=None):
        """Full-graph SAGE (ogb_products-style full-batch); ``split``: the
        ``GraphSplit`` of a mesh step, where the mean aggregator's sums
        and counts are reduce-scattered and the max aggregator's partial
        maxima reduce-scattered by ``MAX`` (``GraphSplit.segment_max``)."""
        split = split or GraphSplit(x.shape[0], edge_src.shape[0])
        es, ed = edge_src.long(), edge_dst.long()
        cnt = in_degrees(split, ed)
        for i in range(self.cfg.n_layers):
            x = self.layer(i, split.whole(x), x, es, ed, split, cnt)
            if i < self.cfg.n_layers - 1:
                x = torch.relu(x)
        return x

    def forward_blocks(self, x_outer, blocks):
        """Minibatch SAGE over sampler blocks (outermost first). ``blocks``
        is a list of dicts with edge_src/edge_dst (local) + n_dst +
        map_dst: index of each dst node within the src node set. An
        index past the padded source rows reads the zero pad row, as
        ``repro``'s clamped gathers do."""
        x = x_outer
        for i, blk in enumerate(blocks):
            x_pad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])], 0)
            last = x_pad.shape[0] - 1
            # the pad segment's destination is the zero row
            map_dst = torch.cat([blk["map_dst"].long(),
                                 torch.full((1,), last, dtype=torch.long,
                                            device=x.device)])
            x_dst = x_pad.index_select(0, torch.clamp(map_dst, max=last))
            es = torch.clamp(blk["edge_src"].long(), max=last)
            ed = blk["edge_dst"].long()
            split = GraphSplit(blk["n_dst"] + 1, es.shape[0])
            x = self.layer(i, x_pad, x_dst, es, ed, split,
                           in_degrees(split, ed))[: blk["n_dst"]]
            if i < self.cfg.n_layers - 1:
                x = torch.relu(x)
        return x


def in_degrees(split, edge_dst):
    """Each node's in-degree on this rank's node block (``split``: a
    ``GraphSplit``), as float32: ``segment_mean``'s count."""
    ones = torch.ones(edge_dst.shape, dtype=torch.float32,
                      device=edge_dst.device)
    return split.to_block(sops.segment_sum(ones, edge_dst, split.nodes))


# -------------------------------------------------------------------- EGNN
@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_out: int = 1


class EGNN(nn.Module):
    def __init__(self, cfg: EGNNConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.d_hidden
        self.embed = L._dense_init((cfg.d_in, h), generator)
        for i in range(cfg.n_layers):
            setattr(self, f"phi_e{i}", L.MLP([2 * h + 1, h, h],
                                             generator=generator))
            setattr(self, f"phi_x{i}", L.MLP([h, h, 1], generator=generator))
            setattr(self, f"phi_h{i}", L.MLP([2 * h, h, h],
                                             generator=generator))
        self.out = L.MLP([h, h, cfg.n_out], generator=generator)

    def forward(self, h_feat, coords, edge_src, edge_dst, split=None):
        """h_feat: [n+1, d_in]; coords: [n+1, 3]; edges sentinel-padded.
        Returns (node_out [n+1, n_out], node feats h) — callers pool for
        graph-level targets (segment_sum over graph_ids). ``split``: the
        ``GraphSplit`` of a mesh step (the module docstring)."""
        split = split or GraphSplit(h_feat.shape[0], edge_src.shape[0])
        n1 = split.nodes
        es, ed = edge_src.long(), edge_dst.long()
        h = h_feat @ self.embed
        x = coords
        act = F.silu
        # segment_mean's count, an empty segment counting 1
        cnt = in_degrees(split, ed).clamp(min=1.0)[:, None]
        for i in range(self.cfg.n_layers):
            xa, ha = split.whole(x), split.whole(h)
            diff = xa.index_select(0, es) - xa.index_select(0, ed)
            d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
            m = getattr(self, f"phi_e{i}")(
                torch.cat([ha.index_select(0, es), ha.index_select(0, ed),
                           d2], -1), act=act)
            # coordinate update (E(n)-equivariant)
            cx = getattr(self, f"phi_x{i}")(m, act=act)
            x = x + split.to_block(sops.segment_sum(diff * cx, ed, n1)) / cnt
            # feature update
            agg = split.to_block(sops.segment_sum(m, ed, n1))
            h = h + getattr(self, f"phi_h{i}")(torch.cat([h, agg], -1),
                                               act=act)
        node_out = self.out(h, act=act)
        return node_out, h
