"""The benchmark's graphs, made from a configuration's ``graph`` entry.

Each generator is a frozen copy of the program's, in a file of its own,
``generators/<name>.py`` with ``generate(**args)``, so that a later
change to the program cannot move the benchmark's graphs: on the
arguments the configurations give, each is bitwise equal to the
program's (``test_portbench.py`` checks this). A generator returns
``(n, src, dst, w)`` with both edge directions, no self loops, no
duplicates and integer-valued float32 weights.
"""
from __future__ import annotations

import numpy as np

from portbench.named import load


def pack_pairs(n, u, v):
    """Self-loop-free canonical (lo < hi) pairs as sorted unique int64
    keys ``lo * n + hi``."""
    keep = u != v
    lo = np.minimum(u[keep], v[keep]).astype(np.int64)
    hi = np.maximum(u[keep], v[keep]).astype(np.int64)
    return np.unique(lo * np.int64(n) + hi)


def unpack_keys(n, keys):
    return np.stack([keys // n, keys % n], 1)


def finalize(n, und_edges, rng, max_w):
    pairs = unpack_keys(n, pack_pairs(n, und_edges[:, 0], und_edges[:, 1]))
    m = pairs.shape[0]
    weights = rng.integers(1, max_w + 1, size=m).astype(np.float32)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32)
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32)
    w = np.concatenate([weights, weights]).astype(np.float32)
    return n, src, dst, w


def make_graph(spec: dict):
    """The graph a configuration's ``graph`` entry names:
    ``{"generator": name, "args": {...}}``, by ``generators/<name>.py``."""
    return load("generators", spec["generator"], "generate")(**spec["args"])


def reweighted(w: np.ndarray, seed: int, max_w: int) -> np.ndarray:
    """Fresh integer weights 1..max_w for the same edges, drawn from
    ``seed``: one weight per undirected edge, the same in both
    directions (the generators list the m forward edges, then the m
    reversed ones)."""
    m = len(w) // 2
    und = np.random.default_rng(seed).integers(
        1, max_w + 1, size=m).astype(np.float32)
    return np.concatenate([und, und])
