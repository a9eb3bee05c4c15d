"""Batched shortest-path reconstruction (paper §8.1): the torch
counterpart of ``repro.paths.reconstruct``.

Every stage works on a whole ``[Q]`` batch at once with fixed shapes,
exactly as in ``repro``, so the outputs agree bitwise:

  1. *label chase* (``label_chase``) — walk the label pred chain from
     an endpoint to its meeting ancestor, one ``[Q, L]`` row gather and
     searchsorted a step;
  2. *core parent chase* (``core_chase``) — recover predecessors from
     the relaxation's fixed point: u is a parent of v iff
     ``D[u] + w(u, v) == D[v]`` (exact float equality), the first such
     in-edge in the chase planes' order; the chase ends at a label seed
     (``D[v] == seed[v]``);
  3. *stitch* — the four pieces scattered into one ``[Q, hop_cap]``
     edge list (vertex, via, weight);
  4. *via expansion* (``expand_vias``) — each round splits every
     augmenting edge (a, b) with via c into (a, c) + (c, b) by a
     prefix-sum insertion scatter; the hierarchy height bounds the
     rounds.

JAX ran the three loops as device ``while_loop``s. Here each loop is on
the host and its exit test stays on the device
(``core/dispatch.py:device_loop``, as the relaxation rounds): the host
reads "any query still active" (``host_read``) once every
``CHECK_EVERY`` steps. A chase step
after every query went inactive changes nothing. An expansion round
does (it clamps ``length`` to ``hop_cap``), so each round applies only
under the loop's own condition, ``any(via >= 0)``, evaluated on the
device.

Row reads of the label and up-edge planes by vertex id map the id as
``repro`` does (``core/labels.py:row_index``), so endpoint ids outside
[0, n] give ``repro``'s answers.

Writes to the drop column ``h`` of the stitch and expansion buffers
have duplicate indices (their order on the card is unspecified); that
column is sliced off, and no valid write lands there.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import device_loop
from repro_torch.core.labels import row_index

I32 = torch.int32


def _first_true(mask, dim: int = -1, keepdim: bool = False):
    """Index of the first True along ``dim`` (0 where there is none), as
    ``jnp.argmax`` of a bool array."""
    return mask.to(torch.uint8).argmax(dim, keepdim=keepdim)


def label_chase(lbl_ids, lbl_pred, up_ids, up_w, up_via, start, target,
                active, chase_cap: int, n: int):
    """Walk the label pred chain ``start -> target`` for a batch.

    Returns ``(hop_v, hop_via, hop_w, hops, ok)`` with ``hop_v[q, i]``
    the i-th path vertex (the edge i leads to vertex i+1; the final
    vertex ``target`` is implicit) and ``hops[q]`` the hop count.
    Queries with ``active=False`` report zero hops. ``ok`` drops when
    the chain is inconsistent or longer than ``chase_cap``.
    """
    q = start.shape[0]
    dev = start.device
    l_cap = lbl_ids.shape[1]
    rows_l, rows_u = lbl_ids.shape[0], up_ids.shape[0]
    hop_v = torch.full((q, chase_cap), n, dtype=I32, device=dev)
    hop_via = torch.full((q, chase_cap), -1, dtype=I32, device=dev)
    hop_w = torch.zeros((q, chase_cap), dtype=torch.float32, device=dev)
    target_col = target.reshape(q, 1)

    def step(st, i):
        cur, hops, ok, act = st
        rl = row_index(cur, rows_l)
        ru = row_index(cur, rows_u)
        row_ids = lbl_ids[rl]                              # [Q, L]
        j = torch.searchsorted(row_ids, target_col).clamp_(max=l_cap - 1)
        found = row_ids.gather(1, j)[:, 0] == target
        u = lbl_pred[rl, j[:, 0]]
        hit = up_ids[ru] == u[:, None]                     # [Q, d_cap]
        slot = _first_true(hit, 1)
        step_ok = found & (u >= 0) & hit.any(1)
        write = act & step_ok
        hop_v[:, i] = torch.where(write, cur, hop_v[:, i])
        hop_via[:, i] = torch.where(write, up_via[ru, slot], hop_via[:, i])
        hop_w[:, i] = torch.where(write, up_w[ru, slot], hop_w[:, i])
        hops = hops + write.to(I32)
        ok = ok & (~act | step_ok)
        cur = torch.where(write, u, cur)
        return cur, hops, ok, write & (cur != target)

    st = (start, torch.zeros(q, dtype=I32, device=dev),
          torch.ones(q, dtype=torch.bool, device=dev),
          active & (start != target))
    _, hops, ok, act = device_loop(step, st, chase_cap, lambda s: s[3])
    ok = ok & ~act                  # ran out of chase_cap before target
    return hop_v, hop_via, hop_w, hops, ok


def core_chase(dvec, seed, ell_ids, ell_w, ell_via, core_gid, vstar, active,
               core_cap: int, n: int):
    """Parent-chase one direction's fixed point from ``vstar`` (local
    core index) back to a label seed.

    Step i records the parent edge walked: ``pv[q, i]`` the parent
    (global id), ``pvia``/``pw`` the via/weight of the edge between the
    previous chase vertex and that parent. Returns
    ``(pv, pvia, pw, steps, r_local, ok)`` — ``r_local`` is the seed
    core vertex the chase ended on (== ``vstar`` for zero steps).
    """
    q = dvec.shape[0]
    dev = dvec.device
    pv = torch.full((q, core_cap), n, dtype=I32, device=dev)
    pvia = torch.full((q, core_cap), -1, dtype=I32, device=dev)
    pw = torch.zeros((q, core_cap), dtype=torch.float32, device=dev)

    def at(x, cur):
        return x.gather(1, cur.long()[:, None])[:, 0]

    def step(st, i):
        cur, steps, ok, act = st
        dv = at(dvec, cur)
        at_seed = dv == at(seed, cur)
        rows = cur.long()
        nbr = ell_ids[rows]                                # [Q, D]
        wr = ell_w[rows]
        cand = (dvec.gather(1, nbr.long()) + wr) == dv[:, None]
        hit = cand.any(1)
        jsel = _first_true(cand, 1, keepdim=True)
        par = nbr.gather(1, jsel)[:, 0]
        write = act & ~at_seed & hit
        pv[:, i] = torch.where(write, core_gid[par.long()], pv[:, i])
        pvia[:, i] = torch.where(write, ell_via[rows].gather(1, jsel)[:, 0],
                                 pvia[:, i])
        pw[:, i] = torch.where(write, wr.gather(1, jsel)[:, 0], pw[:, i])
        steps = steps + write.to(I32)
        ok = ok & (~act | at_seed | hit)
        return torch.where(write, par, cur), steps, ok, write

    st = (vstar, torch.zeros(q, dtype=I32, device=dev),
          torch.ones(q, dtype=torch.bool, device=dev), active)
    cur, steps, ok, act = device_loop(step, st, core_cap, lambda s: s[3])
    # a chase still active after core_cap steps never reached a seed
    ok = ok & (~act | (at(dvec, cur) == at(seed, cur)))
    return pv, pvia, pw, steps, cur, ok


def _scatter_rows(buf, vals, start, count, fill):
    """Write ``vals[q, :count[q]]`` at columns ``start[q] + i`` of the
    ``[Q, H+1]`` buffer in place (column H is the drop scratch)."""
    q, c = vals.shape
    if c == 0:
        return buf
    h = buf.shape[1] - 1
    cols = torch.arange(c, device=buf.device)[None, :]
    valid = cols < count[:, None]
    tgt = torch.where(valid, start[:, None] + cols, h).clamp_(max=h)
    rows = torch.arange(q, device=buf.device)[:, None].expand_as(tgt)
    return buf.index_put_((rows, tgt), torch.where(valid, vals, fill))


def _reverse_gather(arr, count, fill):
    """``out[q, j] = arr[q, count[q]-1-j]`` for j < count (fill after)."""
    q, c = arr.shape
    cols = torch.arange(c, device=arr.device)[None, :]
    idx = (count[:, None] - 1 - cols).clamp(0, max(c - 1, 0))
    out = arr.gather(1, idx)
    return torch.where(cols < count[:, None], out, fill)


def stitch(s, t, finite, hop_cap: int, n: int,
           ls_v, ls_via, ls_w, p_s,
           seg_s_v, seg_s_via, seg_s_w, m_s,
           vstar_g, seg_t_v, seg_t_via, seg_t_w, m_t,
           lt_v, lt_via, lt_w, p_t, x_t):
    """Assemble the four path pieces into one ``[Q, hop_cap]`` edge
    list. Pieces (forward order): label hops of s · reversed s-side
    core segment · forward t-side core segment · reversed label hops of
    t · the final vertex t. Returns ``(verts, evia, ew, length, ok)``
    with ``length`` the vertex count (0 for unreachable pairs)."""
    q = s.shape[0]
    dev = s.device
    h = hop_cap
    edges = p_s + m_s + m_t + p_t
    length = torch.where(finite, edges + 1, 0).to(I32)
    ok = length <= h

    verts = torch.full((q, h + 1), n, dtype=I32, device=dev)
    evia = torch.full((q, h + 1), -1, dtype=I32, device=dev)
    ew = torch.zeros((q, h + 1), dtype=torch.float32, device=dev)

    zero = torch.zeros(q, dtype=I32, device=dev)
    p_s = torch.where(finite, p_s, zero)
    m_s = torch.where(finite, m_s, zero)
    m_t = torch.where(finite, m_t, zero)
    p_t = torch.where(finite, p_t, zero)

    def put(off, count, v, via, w):
        _scatter_rows(verts, v, off, count, n)
        _scatter_rows(evia, via, off, count, -1)
        _scatter_rows(ew, w, off, count, 0.0)

    # piece 1: label hops of s, forward
    put(zero, p_s, ls_v, ls_via, ls_w)
    # piece 2: s-side core segment, reversed (seed -> vstar)
    off = p_s
    put(off, m_s, _reverse_gather(seg_s_v, m_s, n),
        _reverse_gather(seg_s_via, m_s, -1),
        _reverse_gather(seg_s_w, m_s, 0.0))
    # piece 3: t-side core segment, forward from vstar
    off = off + m_s
    v3 = (torch.cat([vstar_g[:, None], seg_t_v[:, :-1]], dim=1)
          if seg_t_v.shape[1] > 0 else seg_t_v)
    put(off, m_t, v3, seg_t_via, seg_t_w)
    # piece 4: label hops of t, reversed (x_t -> t); vertex j is
    # b_{p_t - j}: x_t at j = 0, then the chase vertices reversed
    off = off + m_t
    cols = torch.arange(lt_v.shape[1], device=dev)[None, :]
    idx = (p_t[:, None] - cols).clamp(0, max(lt_v.shape[1] - 1, 0))
    v4 = torch.where(cols == 0, x_t[:, None], lt_v.gather(1, idx))
    put(off, p_t, v4, _reverse_gather(lt_via, p_t, -1),
        _reverse_gather(lt_w, p_t, 0.0))
    # final vertex t
    rows = torch.arange(q, device=dev)
    tcol = torch.where(finite, edges, h).clamp_(max=h).long()
    verts[rows, tcol] = torch.where(finite, t, verts[rows, tcol])
    return verts[:, :h], evia[:, :h], ew[:, :h], length, ok


def expand_vias(verts, evia, ew, length, ok, up_ids, up_w, up_via,
                n: int, max_rounds: int):
    """Iteratively expand every augmenting edge in place (§8.1).

    Each round splits every edge (a, b) with ``via = c >= 0`` into
    (a, c) + (c, b) via a prefix-sum insertion scatter; sub-edge vias
    and weights come from c's up-adjacency row. Terminates in at most
    ``max_rounds`` (the hierarchy height bounds the nesting depth). A
    round applies only where JAX's loop would run it: while some via is
    pending.
    """
    q, h = verts.shape
    dev = verts.device
    rows = torch.arange(q, device=dev)[:, None]
    cols = torch.arange(h, device=dev)[None, :]

    def body(v, evia_, ew_, length_, ok_):
        edge_valid = cols < (length_[:, None] - 1)
        need = (evia_ >= 0) & edge_valid
        grow = need.to(I32)
        shift = torch.cumsum(grow, 1, dtype=I32) - grow
        new_pos = cols + shift
        new_len = length_ + grow.sum(1, dtype=I32)
        ok_ = ok_ & (new_len <= h)

        b = torch.cat([v[:, 1:], torch.full((q, 1), n, dtype=I32,
                                            device=dev)], dim=1)
        c = torch.where(need, evia_, 0).long()
        crow = up_ids[c]                                   # [Q, H, D]
        hit_a = crow == v[..., None]
        hit_b = crow == b[..., None]
        sa = _first_true(hit_a, -1, keepdim=True)
        sb = _first_true(hit_b, -1, keepdim=True)
        ok_ = ok_ & ~(need & ~(hit_a.any(-1) & hit_b.any(-1))).any(1)
        cvia = up_via[c]
        cw = up_w[c]
        via_ac = cvia.gather(-1, sa)[..., 0]
        w_ac = cw.gather(-1, sa)[..., 0]
        via_cb = cvia.gather(-1, sb)[..., 0]
        w_cb = cw.gather(-1, sb)[..., 0]

        vert_valid = cols < length_[:, None]
        tgt = torch.where(vert_valid, new_pos, h).clamp_(max=h).long()
        rr = rows.expand_as(tgt)
        nv = torch.full((q, h + 1), n, dtype=I32, device=dev)
        nv.index_put_((rr, tgt), v)
        nvia = torch.full((q, h + 1), -1, dtype=I32, device=dev)
        nvia.index_put_((rr, tgt), torch.where(need, via_ac, evia_))
        nw = torch.zeros((q, h + 1), dtype=torch.float32, device=dev)
        nw.index_put_((rr, tgt), torch.where(need, w_ac, ew_))
        ins = torch.where(need, new_pos + 1, h).clamp_(max=h).long()
        nv.index_put_((rr, ins), torch.where(need, c.to(I32), nv[rr, ins]))
        nvia.index_put_((rr, ins), torch.where(need, via_cb, nvia[rr, ins]))
        nw.index_put_((rr, ins), torch.where(need, w_cb, nw[rr, ins]))
        return (nv[:, :h], nvia[:, :h], nw[:, :h],
                new_len.clamp(max=h), ok_)

    def step(st, _):
        pending = (st[1] >= 0).any()        # JAX's loop condition
        new = body(*st)
        return tuple(torch.where(pending, a, b) for a, b in zip(new, st))

    st = (verts, evia, ew, length, ok)
    verts, evia, ew, length, ok = device_loop(step, st, max_rounds,
                                              lambda s: s[1] >= 0)
    # any via still pending means the round bound was hit (inconsistent
    # index) — never report such a path as valid
    ok = ok & ~(evia >= 0).any(1)
    return verts, ew, length, ok
