"""Deterministic, seekable synthetic data — the data substrate for
training runs and fault-injection tests: the port's copy of
``repro.data.synthetic`` (numpy only; the same arrays, bitwise, for the
same arguments).

Every generator is a pure function of (seed, step) so a rollback replays
or skips data windows deterministically (FaultTolerantRunner contract),
and each host can generate exactly its addressable shard.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs import generators as gen


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             host_slice: slice | None = None):
    """Zipf-ish token stream with next-token targets."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    u = rng.random((batch, seq + 1))
    toks = np.minimum((u ** 2.5 * vocab).astype(np.int32), vocab - 1)
    if host_slice is not None:
        toks = toks[host_slice]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def dien_batch(seed: int, step: int, batch: int, seq: int, n_items: int,
               n_cats: int, n_users: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    return {
        "user": rng.integers(0, n_users, batch).astype(np.int32),
        "hist_items": rng.integers(0, n_items, (batch, seq)).astype(np.int32),
        "hist_cats": rng.integers(0, n_cats, (batch, seq)).astype(np.int32),
        "hist_mask": (rng.random((batch, seq)) > 0.1).astype(np.float32),
        "target_item": rng.integers(0, n_items, batch).astype(np.int32),
        "target_cat": rng.integers(0, n_cats, batch).astype(np.int32),
        "label": rng.integers(0, 2, batch).astype(np.int32),
    }


def gnn_full_batch(seed: int, n: int, avg_deg: float, d_feat: int,
                   n_classes: int, n_pad: int, e_pad: int,
                   with_coords: bool = False):
    """Random sparse graph padded to fixed caps (sentinel = n)."""
    n, src, dst, w = gen.er_graph(n, avg_deg=avg_deg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    e = len(src)
    if not (e <= e_pad and n + 1 <= n_pad):
        # repro asserts the same caps (minibatch_lg does not fit them)
        raise ValueError(f"graph of {n} nodes and {e} edges does not fit "
                         f"n_pad={n_pad}, e_pad={e_pad}")
    es = np.full(e_pad, n, np.int32)
    ed = np.full(e_pad, n, np.int32)
    es[:e], ed[:e] = src, dst
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, es[:e], 1.0)
    feats = np.zeros((n_pad, d_feat), np.float32)
    feats[:n] = rng.standard_normal((n, d_feat)).astype(np.float32)
    labels = np.zeros(n_pad, np.int32)
    labels[:n] = rng.integers(0, n_classes, n)
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = (rng.random(n) < 0.6)
    out = {"feats": feats, "edge_src": es, "edge_dst": ed, "deg": deg,
           "labels": labels, "mask": mask}
    if with_coords:
        coords = np.zeros((n_pad, 3), np.float32)
        coords[:n] = rng.standard_normal((n, 3)).astype(np.float32)
        out["coords"] = coords
    return out


def molecule_batch(seed: int, n_graphs: int, n_atoms: int, n_edges: int,
                   d_feat: int, n_pad: int, e_pad: int, t_cap: int = 0):
    """Batched random molecules flattened block-diagonally; with
    ``t_cap``, DimeNet's triplet lists (sentinel ``e_pad``)."""
    rng = np.random.default_rng(seed)
    n_tot = n_graphs * n_atoms
    feats = rng.standard_normal((n_pad, d_feat)).astype(np.float32)
    coords = rng.standard_normal((n_pad, 3)).astype(np.float32)
    es = np.full(e_pad, n_tot, np.int32)
    ed = np.full(e_pad, n_tot, np.int32)
    k = 0
    for g in range(n_graphs):
        base = g * n_atoms
        for _ in range(n_edges):
            a, b = rng.integers(0, n_atoms, 2)
            if a == b:
                continue
            es[k], ed[k] = base + a, base + b
            es[k + 1], ed[k + 1] = base + b, base + a
            k += 2
    graph_ids = np.full(n_pad, n_graphs, np.int32)
    for g in range(n_graphs):
        graph_ids[g * n_atoms:(g + 1) * n_atoms] = g
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, es[:k], 1.0)
    targets = rng.standard_normal(n_graphs).astype(np.float32)
    out = {"feats": feats, "edge_src": es, "edge_dst": ed, "deg": deg,
           "graph_ids": graph_ids, "targets": targets, "coords": coords,
           "atom_z": np.minimum(np.abs(feats[:, 0] * 10).astype(np.int32), 94)}
    if t_cap:
        from repro_torch.models.dimenet import build_triplets
        tkj, tji = build_triplets(es[:k], ed[:k], n_tot, t_cap)
        tkj = np.where(tkj == k, e_pad, tkj)
        tji = np.where(tji == k, e_pad, tji)
        out["trip_kj"], out["trip_ji"] = tkj, tji
    return out
