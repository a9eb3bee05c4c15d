"""Bindings of the hand-written label-intersect kernels
(``csrc/label_intersect.cu`` and ``csrc/label_intersect_packed.cu``, one
merge core in ``csrc/label_merge.cuh``; the design notes are in those
files). They replace the Pallas ``label_intersect_kernel`` and
``label_intersect_packed_kernel`` of
``repro/kernels/label_intersect/kernel.py``.

Both read label rows in place: side s of query q is row ``idx_s[q]`` of
its planes, or row q when ``idx_s`` is None (rows gathered before the
call, the TPU kernels' signature). Row ids map as ``repro`` reads its
planes (``core/labels.py:row_index``): a negative id counts from the
end, then ids are clamped to [0, R)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _side(operands, idx, side: str) -> tuple[int, int]:
    """(queries, plane rows) of one side; ``operands`` are (name, tensor,
    dtype, rank) of its [R, L] planes and [R] bases, the first a plane."""
    lead = operands[0][1]
    for name, t, dt, nd in operands:
        _build.require(t, name, dt, nd)
        want = lead.shape if nd == 2 else lead.shape[:1]
        if t.shape != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(want)}")
    rows = lead.shape[0]
    if idx is None:
        return rows, rows
    _build.require(idx, f"idx_{side}", torch.int32, 1)
    return idx.shape[0], rows


def _sides(planes_s, idx_s, planes_t, idx_t) -> tuple[int, int, int]:
    """(Q, R_s, R_t) of both sides; checks that Q and L agree."""
    q, rows_s = _side(planes_s, idx_s, "s")
    q_t, rows_t = _side(planes_t, idx_t, "t")
    l_s, l_t = planes_s[0][1].shape[1], planes_t[0][1].shape[1]
    if q != q_t or l_s != l_t:
        raise ValueError(f"sides differ: {q} x {l_s} queries and slots for "
                         f"s, {q_t} x {l_t} for t")
    return q, rows_s, rows_t


def label_intersect_kernel(ids_s, d_s, ids_t, d_t, n_sentinel: int,
                           idx_s=None, idx_t=None):
    """ids_*: int32[R, L] sorted ancestor ids (pad = n_sentinel); d_*:
    float32[R, L]; idx_*: int32[Q] row ids (mapped by ``row_index``),
    or None for R = Q gathered rows. All contiguous on one CUDA device;
    any Q and L. Returns mu float32[Q]."""
    q, rows_s, rows_t = _sides(
        [("ids_s", ids_s, torch.int32, 2), ("d_s", d_s, torch.float32, 2)],
        idx_s,
        [("ids_t", ids_t, torch.int32, 2), ("d_t", d_t, torch.float32, 2)],
        idx_t)
    mu = torch.empty(q, dtype=torch.float32, device=ids_s.device)
    _build.launch("islabel_label_intersect", ids_s, d_s, idx_s, rows_s,
                  ids_t, d_t, idx_t, rows_t, mu, q, ids_s.shape[1],
                  n_sentinel)
    return mu


def label_intersect_packed_kernel(delta_s, base_s, d_s, delta_t, base_t, d_t,
                                  n_sentinel: int, idx_s=None, idx_t=None):
    """delta_*: int16[R, L] (-1 marks the first pad slot); base_*:
    int32[R]; d_*: int32[R, L] (-1 = +inf) or float32[R, L], one dtype
    for both sides; idx_*: int32[Q] row ids (mapped by ``row_index``), or
    None for R = Q gathered rows. All contiguous on one CUDA device; any
    Q and L. Returns mu float32[Q]."""
    d_dtype = d_s.dtype
    if d_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"d_s must be int32 or float32, got {d_dtype}")
    q, rows_s, rows_t = _sides(
        [("delta_s", delta_s, torch.int16, 2), ("base_s", base_s, torch.int32, 1),
         ("d_s", d_s, d_dtype, 2)], idx_s,
        [("delta_t", delta_t, torch.int16, 2), ("base_t", base_t, torch.int32, 1),
         ("d_t", d_t, d_dtype, 2)], idx_t)
    mu = torch.empty(q, dtype=torch.float32, device=delta_s.device)
    _build.launch("islabel_label_intersect_packed", delta_s, base_s, d_s,
                  idx_s, rows_s, delta_t, base_t, d_t, idx_t, rows_t, mu, q,
                  delta_s.shape[1], n_sentinel, int(d_dtype == torch.int32))
    return mu
