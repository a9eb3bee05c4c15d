"""Host-side neighbor sampler for GraphSAGE-style minibatch training:
the port's copy of ``repro.graphs.sampler`` (numpy only; for the same
``np.random.Generator`` it gives the same blocks, bitwise).

Produces DGL-style "blocks": for a batch of seed nodes and fanouts
(outer->inner, e.g. [10, 15] for sample_sizes=25-10 two-layer SAGE), each
block is a bipartite (src_local -> dst_local) edge set with fixed padded
shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostCSR:
    n: int
    indptr: np.ndarray   # int64[n+1]
    indices: np.ndarray  # int32[e]

    @staticmethod
    def from_coo(n: int, src, dst) -> "HostCSR":
        order = np.argsort(src, kind="stable")
        s, d = np.asarray(src)[order], np.asarray(dst)[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        indptr = np.cumsum(indptr)
        return HostCSR(n, indptr, d.astype(np.int32))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


@dataclasses.dataclass
class Block:
    """Bipartite message block. Arrays are padded to fixed shapes."""
    src_ids: np.ndarray    # int32[n_src_cap] global ids (pad = -1)
    dst_ids: np.ndarray    # int32[n_dst_cap]
    edge_src: np.ndarray   # int32[e_cap] local index into src_ids (pad -> n_src_cap)
    edge_dst: np.ndarray   # int32[e_cap] local index into dst_ids
    n_src_cap: int
    n_dst_cap: int


def sample_blocks(csr: HostCSR, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.Generator) -> list[Block]:
    """Sample inner-to-outer: returns blocks ordered outermost first, so a
    forward pass folds them left-to-right into the seeds."""
    blocks: list[Block] = []
    frontier = np.asarray(seeds, np.int32)
    for fanout in fanouts:                      # innermost (near seeds) first
        n_dst = len(frontier)
        e_cap = n_dst * fanout
        edge_src_g = np.full(e_cap, -1, np.int64)
        edge_dst_l = np.full(e_cap, n_dst, np.int32)
        for i, v in enumerate(frontier):
            nbr = csr.neighbors(int(v))
            if len(nbr) == 0:
                continue
            take = rng.choice(nbr, size=min(fanout, len(nbr)),
                              replace=len(nbr) < fanout)
            edge_src_g[i * fanout:i * fanout + len(take)] = take
            edge_dst_l[i * fanout:i * fanout + len(take)] = i
        uniq, inv = np.unique(
            np.concatenate([frontier.astype(np.int64),
                            edge_src_g[edge_src_g >= 0]]), return_inverse=True)
        src_ids = uniq.astype(np.int32)
        n_src_cap = n_dst * (fanout + 1)        # fixed cap
        pad_src = np.full(n_src_cap, -1, np.int32)
        pad_src[:len(src_ids)] = src_ids
        edge_src_l = np.full(e_cap, n_src_cap, np.int32)
        lut = {int(g): i for i, g in enumerate(src_ids)}
        valid = edge_src_g >= 0
        edge_src_l[valid] = [lut[int(g)] for g in edge_src_g[valid]]
        dst_pad = np.full(n_dst, -1, np.int32)
        dst_pad[:n_dst] = frontier
        blocks.append(Block(pad_src, dst_pad, edge_src_l, edge_dst_l,
                            n_src_cap, n_dst))
        frontier = src_ids                       # expand outward
    return blocks[::-1]                          # outermost first


def sampled_batch_arrays(csr: HostCSR, seeds, fanouts, rng, feats, labels):
    """Convenience: blocks + gathered input features for the outermost
    node set + labels for seeds, all numpy."""
    blocks = sample_blocks(csr, seeds, fanouts, rng)
    outer = blocks[0].src_ids
    x = np.zeros((len(outer), feats.shape[1]), feats.dtype)
    ok = outer >= 0
    x[ok] = feats[outer[ok]]
    return blocks, x, labels[np.asarray(seeds)]
