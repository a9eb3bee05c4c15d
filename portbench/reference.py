"""The plain reference: exact shortest-path distances from the edge list.

Synchronous Bellman-Ford in plain PyTorch, many sources at once: the
distance rows are vertex-major ([n, sources]), and every round takes,
for each vertex, the least of its own distance and ``d[src] + w`` over
its in-edges. It stops at the first round that improves nothing. It
reads the generated edge list alone, nothing the program built, and
imports nothing of the program.

Weights are integers and every distance is a sum of them below 2^24,
so float32 holds it exactly: the answers are compared with ``==``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

INF = float("inf")
HOST_BYTES = 1 << 28         # what a block may take off the card


def block_for(n: int, n_edges: int, device) -> int:
    """Sources a block takes: each source holds two [n] distance columns
    and two [n_edges] candidate columns of float32, and a block takes at
    most a quarter of the card's free memory."""
    if torch.device(device).type == "cuda":
        free = torch.cuda.mem_get_info(torch.device(device))[0] // 4
    else:
        free = HOST_BYTES
    return max(1, free // (4 * (2 * n + 2 * n_edges)))


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _blocks(n: int, src, dst, w, sources, device, block: int, dtype):
    """(first source's index, [n, b] device distances) for each block of
    ``block`` sources."""
    src_t = torch.as_tensor(np.asarray(src, np.int64), device=device)
    dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    w_t = torch.as_tensor(np.asarray(w, np.float32), device=device)[:, None]
    sources = np.asarray(sources, np.int64)
    for lo in range(0, len(sources), block):
        blk = torch.as_tensor(sources[lo:lo + block], device=device)
        d = torch.full((n, len(blk)), INF, dtype=torch.float32, device=device)
        d[blk, torch.arange(len(blk), device=device)] = 0.0
        while True:
            cand = _round_to(d[src_t] + w_t, dtype)
            with warnings.catch_warnings():    # "index_reduce is in beta"
                warnings.simplefilter("ignore", UserWarning)
                new = d.index_reduce(0, dst_t, cand, "amin",
                                     include_self=True)
            del cand
            if not bool((new < d).any()):
                break
            d = new
        yield lo, d
        del d, new


def pair_distances(n: int, src, dst, w, s, t, device="cpu",
                   dtype=torch.float32) -> np.ndarray:
    """float32[Q]: the exact distance of each pair (s[q], t[q]) (+inf
    where none exists), from blocks of ``block_for`` distinct sources.

    ``dtype`` below float32 rounds every sum to it, as arithmetic in
    that type would: the precision control of ``controls.py``."""
    s = np.asarray(s, np.int64)
    t = np.asarray(t, np.int64)
    uniq, inv = np.unique(s, return_inverse=True)
    block = block_for(n, len(src), device)
    out = np.empty(len(s), np.float32)
    for lo, d in _blocks(n, src, dst, w, uniq, device, block, dtype):
        sel = np.flatnonzero((inv >= lo) & (inv < lo + d.shape[1]))
        rows = torch.as_tensor(t[sel], device=d.device)
        cols = torch.as_tensor(inv[sel] - lo, device=d.device)
        out[sel] = d[rows, cols].cpu().numpy()
    return out
