"""Label partitioning for `ShardedIndex`: the port's copy of
``repro.shard.partition`` (numpy only), so both packages cut the same
labels into the same blocks, array for array.

A label entry (v, w, d) — ancestor w with distance d in label(v) — is
owned by the shard of its *ancestor* w, not of v: Equation 1 matches an
entry of label(s) against an entry of label(t) only when both reference
the same ancestor, so partitioning by ancestor keeps every match
shard-local and the global μ is the plain min of the per-shard partial
minima (float min is exact, so the reduction is bitwise-order-free).

Two deterministic vertex→shard strategies, both with the top
``replicate_top`` hierarchy levels (at minimum the core, level k)
REPLICATED on every shard:

* ``"hash"``  — Knuth multiplicative hash of the vertex id. Oblivious
  to the hierarchy; what a KV-store would do.
* ``"level"`` — round-robin by rank within each level, so every shard
  carries the same per-level slice of ancestors. Labels draw their
  ancestors level by level (paper §4.2), which makes this the balanced
  choice by construction.

Replicating the top levels is what keeps the stage-2 core search
shard-local: every shard's block contains *all* core-ancestor entries,
so each shard scatters the complete seed frontier and relaxes G_k to
the identical fixed point — no cross-shard traffic until the final
single-collective min over the per-shard answers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

REPLICATED = -1               # shard id meaning "present on every shard"
STRATEGIES = ("hash", "level")
_KNUTH = np.uint64(2654435761)


def assign_shards(level, k: int, num_shards: int, strategy: str = "level",
                  replicate_top: int = 1) -> np.ndarray:
    """Deterministic vertex→shard map: int32[n+1], REPLICATED for the
    top ``replicate_top`` hierarchy levels (the sentinel row n is
    REPLICATED too; partitioning masks it out by id)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    if replicate_top < 1:
        raise ValueError("replicate_top must be >= 1: the core level must "
                         "be replicated or the core search crosses shards")
    level = np.asarray(level, np.int32)
    n = len(level)
    out = np.full(n + 1, REPLICATED, np.int32)
    movable = level <= k - replicate_top
    if strategy == "hash":
        ids = np.arange(n, dtype=np.uint64)
        h = (ids * _KNUTH) % np.uint64(2 ** 32)
        out[:n][movable] = (h[movable] % np.uint64(num_shards)).astype(np.int32)
    else:
        for lv in np.unique(level[movable]):
            ids_lv = np.flatnonzero(level == lv)
            out[ids_lv] = np.arange(len(ids_lv), dtype=np.int32) % num_shards
    return out


@dataclasses.dataclass
class LabelBlocks:
    """Per-shard padded label blocks: [P, n+1, cap_s] host arrays.

    Rows keep the source order (id-sorted), pad with the sentinel id n /
    +inf / -1 — exactly the unsharded row convention, so every kernel
    backend consumes a block unchanged.
    """
    ids: np.ndarray            # int32 [P, n+1, cap_s]
    d: np.ndarray              # float32 [P, n+1, cap_s]
    pred: np.ndarray           # int32 [P, n+1, cap_s]
    entries: np.ndarray        # int64 [P]: owned+replicated entries per shard

    @property
    def num_shards(self) -> int:
        return self.ids.shape[0]

    @property
    def cap(self) -> int:
        return self.ids.shape[2]


def partition_labels(lbl_ids, lbl_d, lbl_pred, n: int, shard_of: np.ndarray,
                     num_shards: int, pad_to: int = 8) -> LabelBlocks:
    """Slice [n+1, l_cap] label arrays into per-shard padded blocks.

    Shard p keeps the entries whose ancestor it owns plus every
    REPLICATED entry; cap_s is the max kept-per-row count over all
    shards, rounded up to a ``pad_to`` multiple.

    ``repro`` compacts each row by a stable argsort on ``~keep``; here a
    kept entry's column is its rank among the row's kept entries (a
    cumulative sum), scattered with torch ops on the host — the same
    blocks, without the [n+1, l_cap] sort per shard.
    """
    ids = torch.from_numpy(np.ascontiguousarray(lbl_ids, np.int32))
    d = torch.from_numpy(np.ascontiguousarray(lbl_d, np.float32))
    pred = torch.from_numpy(np.ascontiguousarray(lbl_pred, np.int32))
    rows = ids.shape[0]
    if rows != n + 1:
        raise ValueError(f"label arrays must have n+1={n + 1} rows, "
                         f"got {rows}")
    valid = ids < n
    owner = torch.from_numpy(np.asarray(shard_of, np.int32))[
        ids.clamp(max=n).long()]
    keeps = [valid & ((owner == p) | (owner == REPLICATED))
             for p in range(num_shards)]
    counts = [k.sum(1) for k in keeps]
    cap = max(int(c.max()) if rows else 0 for c in counts)
    cap = max(pad_to, -(-cap // pad_to) * pad_to)

    out_ids = np.full((num_shards, rows, cap), n, np.int32)
    out_d = np.full((num_shards, rows, cap), np.inf, np.float32)
    out_pred = np.full((num_shards, rows, cap), -1, np.int32)
    entries = np.zeros(num_shards, np.int64)
    row_start = torch.arange(rows)[:, None] * cap
    for p, keep in enumerate(keeps):
        # flat slot of each kept entry: its row's start + its rank among
        # the row's kept entries (source order kept)
        slot = (row_start + keep.cumsum(1) - 1)[keep]
        for out, src in ((out_ids, ids), (out_d, d), (out_pred, pred)):
            torch.from_numpy(out[p]).view(-1)[slot] = src[keep]
        entries[p] = int(counts[p][:n].sum())
    return LabelBlocks(ids=out_ids, d=out_d, pred=out_pred, entries=entries)


def unpartition_labels(blocks: LabelBlocks, n: int, l_cap: int):
    """Reassemble full [n+1, l_cap] label arrays from per-shard blocks
    (replicated entries deduped by ancestor id). The round-trip
    ``unpartition(partition(x)) == x`` is asserted in tests."""
    p, rows, cap = blocks.ids.shape
    flat_ids = blocks.ids.transpose(1, 0, 2).reshape(rows, p * cap)
    flat_d = blocks.d.transpose(1, 0, 2).reshape(rows, p * cap)
    flat_pred = blocks.pred.transpose(1, 0, 2).reshape(rows, p * cap)
    out_ids = np.full((rows, l_cap), n, np.int32)
    out_d = np.full((rows, l_cap), np.inf, np.float32)
    out_pred = np.full((rows, l_cap), -1, np.int32)
    for r in range(rows):
        m = flat_ids[r] < n
        u, first = np.unique(flat_ids[r][m], return_index=True)
        if len(u) > l_cap:
            raise ValueError(f"row {r}: {len(u)} entries exceed l_cap={l_cap}")
        out_ids[r, :len(u)] = u
        out_d[r, :len(u)] = flat_d[r][m][first]
        out_pred[r, :len(u)] = flat_pred[r][m][first]
    return out_ids, out_d, out_pred
