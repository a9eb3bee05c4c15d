"""Vertex-hierarchy construction (paper §4.1, §5.1; Algorithms 2+3), the
counterpart of ``repro.core.hierarchy``.

Each level: pick an independent set L_i of G_i (mis.py), record the
adjacency of L_i at removal time (the *up-edges* used for labeling and
path reconstruction), then rebuild the edge list: surviving edges +
augmenting edges (u,w) for every 2-path u-v-w through a removed v,
deduped keeping min weight.

Every buffer stays on the device across levels. The one blocking read
of a level is an int32[5] stat vector (IS size, deduped edge count,
augmentation fill, MIS rounds, "pool not yet empty"), from which the
host applies the stop rule and the overflow checks. JAX ran the MIS
rounds in a device ``while_loop``; here the level runs a guessed number
of rounds (16 at the first level, then twice the previous level's
count, at least 8), then the rest
of the level, then reads the stats. Rounds past the MIS fixed point are
exact no-ops, so the guess changes nothing but time; when it falls short
the stats say so, the MIS continues and the rest of the level runs
again from the unchanged pre-level state (one more read).

``build_hierarchy_host`` is the original loop, kept as the reference
the device builder is gated against: it reads every scalar on its own,
drives the MIS one round per read, and pulls the IS mask and the
neighbour matrices to numpy to record each level on the host. At a
fixed permutation source both builders give the same hierarchy,
bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sync as hsync
from repro_torch.core.config import IndexConfig
from repro_torch.core.mis import MISState, torch_permutations
from repro_torch.graphs import csr as gcsr
from repro_torch.kernels.backend import resolve_device
from repro_torch.obs.trace import count, span, spanned

INF = float("inf")


@dataclasses.dataclass
class Hierarchy:
    """Host-side result of the peeling loop."""
    n: int
    k: int                      # level of the core (vertices in G_k)
    level: np.ndarray           # int32[n], 1..k
    # up-edges: for every non-core v, its adjacency in G_{level(v)}
    up_ids: np.ndarray          # int32[n+1, d_cap], sentinel n
    up_w: np.ndarray            # float32[n+1, d_cap], inf pad
    up_via: np.ndarray          # int32[n+1, d_cap], -1 = original edge
    # core graph (G_k) in *global* vertex ids
    core_src: np.ndarray
    core_dst: np.ndarray
    core_w: np.ndarray
    core_via: np.ndarray
    level_sizes: list
    graph_sizes: list
    mis_rounds: list
    host_syncs: int = 0         # blocking device→host reads in the level loop
    peel_iters: int = 0         # level-loop iterations


@spanned("build.peel_level")
def peel_level(src, dst, w, via, in_is, n: int, d_cap: int, aug_cap: int):
    """One hierarchy level after its independent set ``in_is`` is known.

    Returns ``(o_src, o_dst, o_w, o_via, nbr_ids, nbr_w, nbr_via,
    n_unique, n_is, n_is_edges)``; reads its inputs and writes none of
    them. e_cap is implied by src.shape.
    """
    e_cap = src.shape[0]
    valid = src < n
    nbr_ids, nbr_w, nbr_via, _ = gcsr.neighbor_matrix(
        gcsr.EdgeList(src, dst, w, via, n_nodes=n), d_cap)

    # --- compact IS-incident edges into the augmentation buffer -----------
    src_c = torch.where(valid, src, 0).long()
    dst_c = torch.where(valid, dst, 0).long()
    is_src = in_is[src_c] & valid                 # edge (v,u), v in L_i
    a_v, a_u, a_w = gcsr.compact(is_src, aug_cap, (src, n), (dst, n),
                                 (w, INF))
    n_is_edges = is_src.sum(dtype=torch.int32)

    # --- augmenting pairs: (u, partner) for each partner slot of v --------
    av = a_v.long()
    p_ids = nbr_ids[av]                           # [aug_cap, d_cap]
    p_w = nbr_w[av]
    au = a_u[:, None]
    pair_ok = (p_ids < n) & (p_ids != au) & (au < n)
    pair_src = torch.where(pair_ok, au.expand_as(p_ids), n)
    pair_dst = torch.where(pair_ok, p_ids, n)
    pair_w = torch.where(pair_ok, a_w[:, None] + p_w, INF)
    pair_via = torch.where(pair_ok, a_v[:, None].expand_as(p_ids), -1)

    # --- surviving edges ---------------------------------------------------
    keep = valid & ~(in_is[src_c] | in_is[dst_c])
    all_src = torch.cat([torch.where(keep, src, n), pair_src.reshape(-1)])
    all_dst = torch.cat([torch.where(keep, dst, n), pair_dst.reshape(-1)])
    all_w = torch.cat([torch.where(keep, w, INF), pair_w.reshape(-1)])
    all_via = torch.cat([torch.where(keep, via, -1), pair_via.reshape(-1)])
    # the [aug_cap, d_cap] pair planes are in all_*: free them before the
    # dedup sort (at e_cap 2^26, d_cap 16, 13 GB of the level's peak)
    del p_ids, p_w, pair_ok, pair_src, pair_dst, pair_w, pair_via

    with span("build.dedup"):
        o_src, o_dst, o_w, o_via, n_unique = gcsr.dedup_min_edges(
            all_src, all_dst, all_w, all_via, n, e_cap)
    n_is = in_is.sum(dtype=torch.int32)
    return (o_src, o_dst, o_w, o_via, nbr_ids, nbr_w, nbr_via,
            n_unique, n_is, n_is_edges)


def build_hierarchy_device(n: int, src, dst, w, cfg: IndexConfig,
                           device=None, perms=None) -> Hierarchy:
    """Device-resident level loop: one blocking host read per level
    (two or more only when the MIS outlasts its guessed round count).

    ``perms`` is the permutation source: an iterator yielding one
    permutation of [0, n) per level (numpy or tensor); the default draws
    ``torch.randperm`` seeded with ``cfg.seed``. ``device`` is resolved
    by ``resolve_device`` (the card when None).
    """
    device = resolve_device(device)
    if perms is None:
        perms = torch_permutations(cfg.seed, n)
    m0 = len(src)
    e_cap = cfg.e_cap(m0)
    aug_cap = cfg.aug_cap(m0)
    with span("build.graph"):
        g = gcsr.from_host_edges(src, dst, w, n, e_cap, device=device)
    cur = (g.src, g.dst, g.weight, g.via)
    active = torch.ones(n, dtype=torch.bool, device=device)
    level_dev = torch.zeros(n, dtype=torch.int32, device=device)
    up_ids = torch.full((n + 1, cfg.d_cap), n, dtype=torch.int32,
                        device=device)
    up_w = torch.full((n + 1, cfg.d_cap), INF, dtype=torch.float32,
                      device=device)
    up_via = torch.full((n + 1, cfg.d_cap), -1, dtype=torch.int32,
                        device=device)
    no_row = torch.zeros(1, dtype=torch.bool, device=device)

    n_verts = n
    graph_sizes = [n + m0 // 2]
    level_sizes, mis_rounds = [], []
    k = 1
    peel_iters = 0
    guess = 16
    with hsync.sync_span() as syncs:
        for i in range(1, cfg.k_max + 1):
            with span("build.level"):
                peel_iters = i
                perm = hsync.upload(next(perms), device, torch.int32)
                mis = MISState.start(cur[0], cur[1], cur[0] < n, active,
                                     perm, n, cfg.d_cap)
                budget = guess
                while True:
                    mis.advance(budget)
                    out = peel_level(*cur, mis.in_is, n, cfg.d_cap,
                                     aug_cap)
                    stats = torch.stack([out[8], out[7], out[9],
                                         mis.rounds,
                                         mis.pool_left().to(torch.int32)])
                    # the level's blocking read: stop-rule scalars,
                    # overflow flags and the MIS fixed-point flag in one
                    # int32[5]
                    n_is, n_unique, n_is_edges, rounds, left = (
                        int(x) for x in hsync.host_read(stats))
                    if not left:
                        break
                    budget = 8
                guess = max(8, 2 * rounds)
                if n_unique > e_cap:
                    raise RuntimeError(
                        f"edge capacity overflow at level {i}: {n_unique} "
                        f"> {e_cap}; raise IndexConfig.e_cap_factor")
                if n_is_edges > aug_cap:
                    raise RuntimeError(
                        f"augmentation buffer overflow at level {i}; raise "
                        f"aug_cap_factor")
                if n_is == 0:
                    k = i
                    break
                # record level + up-edges under the IS mask (row n of up_*
                # is the sentinel row — never in the set); level and active
                # are updated in place, where JAX donated their buffers
                with span("build.record"):
                    in_is = mis.in_is
                    rec = torch.cat([in_is, no_row])[:, None]
                    level_dev.masked_fill_(in_is, i)
                    up_ids = torch.where(rec, out[4], up_ids)
                    up_w = torch.where(rec, out[5], up_w)
                    up_via = torch.where(rec, out[6], up_via)
                    active &= ~in_is
                cur = out[:4]
                n_verts -= n_is
                new_size = n_verts + n_unique // 2
                level_sizes.append(n_is)
                mis_rounds.append(rounds)
                count("build.mis_rounds", rounds)
                k = i + 1
                graph_sizes.append(new_size)
                if cfg.k_force:
                    if k >= cfg.k_force:
                        break
                elif new_size > cfg.sigma * graph_sizes[-2]:
                    break
    loop_syncs = syncs.count

    # one final pull of the whole hierarchy state
    with span("build.pull"):
        level, up_ids_h, up_w_h, up_via_h, c_src, c_dst, c_w, c_via = (
            hsync.host_read((level_dev, up_ids, up_w, up_via, *cur)))
        level[level == 0] = k
        mask = c_src < n
        core = (c_src[mask], c_dst[mask], c_w[mask], c_via[mask])
    return Hierarchy(n=n, k=k, level=level, up_ids=up_ids_h, up_w=up_w_h,
                     up_via=up_via_h, core_src=core[0], core_dst=core[1],
                     core_w=core[2], core_via=core[3], level_sizes=level_sizes,
                     graph_sizes=graph_sizes, mis_rounds=mis_rounds,
                     host_syncs=loop_syncs, peel_iters=peel_iters)


def build_hierarchy_host(n: int, src, dst, w, cfg: IndexConfig,
                         device=None, perms=None) -> Hierarchy:
    """Host-driven reference loop: per-level scalar reads (IS size,
    deduped edge count, augmentation fill, MIS rounds), the MIS run to
    its fixed point one round per read, and full pulls of the IS mask
    and the neighbour matrices to numpy. ``perms`` as in
    ``build_hierarchy_device``."""
    device = resolve_device(device)
    if perms is None:
        perms = torch_permutations(cfg.seed, n)
    m0 = len(src)
    e_cap = cfg.e_cap(m0)
    aug_cap = cfg.aug_cap(m0)
    g = gcsr.from_host_edges(src, dst, w, n, e_cap, device=device)
    cur = (g.src, g.dst, g.weight, g.via)
    active = torch.ones(n, dtype=torch.bool, device=device)
    level = np.zeros(n, np.int32)
    up_ids = np.full((n + 1, cfg.d_cap), n, np.int32)
    up_w = np.full((n + 1, cfg.d_cap), np.inf, np.float32)
    up_via = np.full((n + 1, cfg.d_cap), -1, np.int32)

    n_verts = n
    graph_sizes = [n + m0 // 2]
    level_sizes, mis_rounds = [], []
    k = 1
    peel_iters = 0
    with hsync.sync_span() as syncs:
        for i in range(1, cfg.k_max + 1):
            with span("build.level"):
                peel_iters = i
                perm = hsync.upload(next(perms), device, torch.int32)
                mis = MISState.start(cur[0], cur[1], cur[0] < n, active,
                                     perm, n, cfg.d_cap)
                while hsync.host_read(mis.advance(1).pool_left()):
                    pass
                out = peel_level(*cur, mis.in_is, n, cfg.d_cap, aug_cap)
                n_is = int(hsync.host_read(out[8]))
                n_unique = int(hsync.host_read(out[7]))
                if n_unique > e_cap:
                    raise RuntimeError(
                        f"edge capacity overflow at level {i}: {n_unique} "
                        f"> {e_cap}; raise IndexConfig.e_cap_factor")
                if int(hsync.host_read(out[9])) > aug_cap:
                    raise RuntimeError(
                        f"augmentation buffer overflow at level {i}; raise "
                        f"aug_cap_factor")
                if n_is == 0:
                    k = i
                    break
                # record level + up-edges on the host
                is_mask = hsync.host_read(mis.in_is)
                level[is_mask] = i
                up_ids[:n][is_mask] = hsync.host_read(out[4])[:n][is_mask]
                up_w[:n][is_mask] = hsync.host_read(out[5])[:n][is_mask]
                up_via[:n][is_mask] = hsync.host_read(out[6])[:n][is_mask]
                active = active & ~mis.in_is
                level_sizes.append(n_is)
                mis_rounds.append(int(hsync.host_read(mis.rounds)))
                count("build.mis_rounds", mis_rounds[-1])
                n_verts -= n_is
                new_size = n_verts + n_unique // 2
                cur = out[:4]
                k = i + 1
                graph_sizes.append(new_size)
                if cfg.k_force:
                    if k >= cfg.k_force:
                        break
                elif new_size > cfg.sigma * graph_sizes[-2]:
                    break
    loop_syncs = syncs.count

    level[level == 0] = k
    c_src, c_dst, c_w, c_via = (hsync.host_read(x) for x in cur)
    mask = c_src < n
    return Hierarchy(n=n, k=k, level=level, up_ids=up_ids, up_w=up_w,
                     up_via=up_via, core_src=c_src[mask],
                     core_dst=c_dst[mask], core_w=c_w[mask],
                     core_via=c_via[mask], level_sizes=level_sizes,
                     graph_sizes=graph_sizes, mis_rounds=mis_rounds,
                     host_syncs=loop_syncs, peel_iters=peel_iters)


def build_hierarchy(n: int, src, dst, w, cfg: IndexConfig, device=None,
                    perms=None) -> Hierarchy:
    """Peel levels until the size-reduction stop rule (§5.1), with the
    builder ``cfg.builder`` names: "device" (default) or "host"; each
    resolves ``device`` (the card when None)."""
    builders = {"device": build_hierarchy_device,
                "host": build_hierarchy_host}
    if cfg.builder not in builders:
        raise ValueError(f"unknown IndexConfig.builder: {cfg.builder!r}")
    return builders[cfg.builder](n, src, dst, w, cfg, device, perms)
