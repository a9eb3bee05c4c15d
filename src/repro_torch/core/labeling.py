"""Top-down vertex labeling (paper §6.1.4, Algorithm 4), the counterpart
of ``repro.core.labeling``.

label(v) = {(v,0)} ∪ merge of label(u) (+ edge weight) over v's
up-neighbours u in G_{ℓ(v)}; levels run k-1 → 1 so every up-neighbour's
label is final before it is read. A chunk gathers the up-neighbour label
blocks, adds the connecting weight, sorts each row by (ancestor id,
distance) with two stable argsorts, and keeps the first occurrence of
each id.

The chunk loop is sync-free: the l_cap overflow flag accumulates into a
per-level device vector and the host reads it once every
``cfg.sync_every`` levels and once after the loop. Each level's padded
vertex chunks go to the device in one copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.config import IndexConfig
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs.trace import count, count_device, span, spanned, spans_on

INF = float("inf")


def label_chunk_step(lbl_ids, lbl_d, lbl_pred, ovf, up_ids, up_w, verts,
                     lvl: int, l_cap: int):
    """Label one chunk of same-level vertices, in place.

    lbl_*: [n+1, l_cap] global label arrays (row n = sentinel).
    ovf:   int32[k+1] per-level overflow accumulator.
    up_*:  [n+1, d_cap] up-neighbour matrix.
    verts: int32[chunk] vertex ids of this level (padded with n).

    The in-place writes are safe where JAX donated its buffers: vertices
    of one level are independent, so a chunk never reads a row it writes
    (pad entries rewrite the sentinel row with its own values). Counts
    ``build.label_slots`` (the candidates it sorts) and
    ``build.label_live`` (those that hold an ancestor).
    """
    n = lbl_ids.shape[0] - 1
    c = verts.shape[0]
    vl = verts.long()
    u = up_ids[vl].long()                   # [c, d]
    w = up_w[vl]                            # [c, d]
    d_cap = u.shape[1]
    dev = lbl_ids.device

    cand_ids = lbl_ids[u].reshape(c, d_cap * l_cap)
    cand_d = (w[:, :, None] + lbl_d[u]).reshape(c, d_cap * l_cap)
    cand_pred = u.to(torch.int32)[:, :, None].expand(c, d_cap, l_cap) \
        .reshape(c, d_cap * l_cap)
    self_ok = verts < n
    ids = torch.cat([torch.where(self_ok, verts, n)[:, None], cand_ids], 1)
    self_d = torch.where(self_ok, 0.0, INF).to(torch.float32)
    d = torch.cat([self_d[:, None], cand_d], 1)
    pred = torch.cat([torch.full((c, 1), -1, dtype=torch.int32, device=dev),
                      cand_pred], 1)
    d = torch.where(ids >= n, INF, d)
    ids = torch.where(torch.isinf(d) & (pred >= 0), n, ids)  # dead candidates
    count("build.label_slots", ids.numel())
    if spans_on():
        count_device("build.label_live", (ids < n).sum(dtype=torch.int64))

    # sort rows by (id asc, d asc): stable sort by d, then stable by id
    o1 = torch.sort(d, dim=1, stable=True).indices
    ids = ids.gather(1, o1)
    d = d.gather(1, o1)
    pred = pred.gather(1, o1)
    o2 = torch.sort(ids, dim=1, stable=True).indices
    ids = ids.gather(1, o2)
    d = d.gather(1, o2)
    pred = pred.gather(1, o2)

    is_first = torch.ones_like(ids, dtype=torch.bool)
    is_first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    is_first &= ids < n
    posn = torch.cumsum(is_first, 1, dtype=torch.int32) - 1
    overflow = (is_first & (posn >= l_cap)).any()
    ovf[lvl] = torch.maximum(ovf[lvl], overflow.to(torch.int32))

    # column l_cap parks everything that is not a kept entry
    col = torch.where(is_first, torch.clamp(posn, max=l_cap), l_cap).long()
    flat = (torch.arange(c, device=dev)[:, None] * (l_cap + 1) + col).reshape(-1)

    def rows(vals, fill, dtype):
        out = torch.full((c * (l_cap + 1),), fill, dtype=dtype, device=dev)
        out[flat] = torch.where(is_first, vals, fill).reshape(-1)
        return out.view(c, l_cap + 1)[:, :l_cap]

    lbl_ids[vl] = rows(ids, n, torch.int32)
    lbl_d[vl] = rows(d, INF, torch.float32)
    lbl_pred[vl] = rows(pred, -1, torch.int32)


def _check_overflow(ovf, cfg: IndexConfig):
    """Deferred l_cap overflow check: one blocking read of the per-level
    accumulator. Reports the *highest* flagged level — levels are labeled
    k-1 → 1, so that is the first chunk that overflowed chronologically."""
    hit = np.flatnonzero(hsync.host_read(ovf))
    if len(hit):
        raise RuntimeError(
            f"label capacity overflow at level {int(hit.max())}: raise "
            f"IndexConfig.l_cap (currently {cfg.l_cap})")


@spanned("build.labels")
def build_labels(hier: Hierarchy, cfg: IndexConfig, device=None):
    """Run Algorithm 4 over the hierarchy. Returns device label arrays
    ``(lbl_ids, lbl_d, lbl_pred)``; blocking syncs are limited to the
    deferred overflow checks (⌈k / sync_every⌉ + 1 total). ``device``
    is resolved by ``resolve_device`` (the card when None)."""
    device = resolve_device(device)
    n, k = hier.n, hier.k
    l_cap, chunk = cfg.l_cap, cfg.label_chunk
    sync_every = max(1, cfg.sync_every)

    lbl_ids = torch.full((n + 1, l_cap), n, dtype=torch.int32, device=device)
    lbl_d = torch.full((n + 1, l_cap), INF, dtype=torch.float32,
                       device=device)
    lbl_pred = torch.full((n + 1, l_cap), -1, dtype=torch.int32,
                          device=device)
    core = hsync.upload(np.flatnonzero(hier.level == k), device, torch.int64)
    lbl_ids[core, 0] = core.to(torch.int32)
    # a scalar fill: assigning a Python float would copy it from the host
    lbl_d.select(1, 0).index_fill_(0, core, 0.0)
    ovf = torch.zeros(k + 1, dtype=torch.int32, device=device)
    up_ids = hsync.upload(hier.up_ids, device)
    up_w = hsync.upload(hier.up_w, device)

    levels_done = 0
    for i in range(k - 1, 0, -1):
        with span("build.label_level"):
            verts = np.flatnonzero(hier.level == i)
            n_chunks = -(-len(verts) // chunk)
            pad = np.full(n_chunks * chunk, n, np.int32)
            pad[:len(verts)] = verts
            pad_d = hsync.upload(pad, device)
            for j in range(n_chunks):
                label_chunk_step(lbl_ids, lbl_d, lbl_pred, ovf, up_ids,
                                 up_w, pad_d[j * chunk:(j + 1) * chunk], i,
                                 l_cap)
        levels_done += 1
        if levels_done % sync_every == 0:
            _check_overflow(ovf, cfg)
    _check_overflow(ovf, cfg)
    return lbl_ids, lbl_d, lbl_pred
