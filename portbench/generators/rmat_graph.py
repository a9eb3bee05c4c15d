"""Frozen copy of ``repro_torch.graphs.generators.rmat_graph``."""
from __future__ import annotations

import numpy as np

from portbench.graphs import finalize, pack_pairs, unpack_keys


def _rmat_chunk(rng, m: int, n_pow: int, a, b, c):
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(n_pow):
        q = rng.random(m)
        sbit = (q >= a + b).astype(np.int64)
        dbit = ((q >= a) & (q < a + b) | (q >= a + b + c)).astype(np.int64)
        src = (src << 1) | sbit
        dst = (dst << 1) | dbit
    return src, dst


def generate(n_pow: int, avg_deg: float = 8.0, max_w: int = 4, seed: int = 0,
               a=0.57, b=0.19, c=0.19, chunk_edges: int = 2_000_000):
    """R-MAT power-law graph (web regime), n = 2**n_pow, sampled in
    chunks of ``chunk_edges`` raw pairs."""
    n = 1 << n_pow
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    keys = []
    for lo in range(0, m, chunk_edges):
        src, dst = _rmat_chunk(rng, min(chunk_edges, m - lo), n_pow, a, b, c)
        keys.append(pack_pairs(n, src, dst))
    pairs = unpack_keys(n, np.unique(np.concatenate(keys))
                         if len(keys) > 1 else keys[0])
    return finalize(n, pairs, rng, max_w)
