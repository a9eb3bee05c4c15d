"""Bindings of the hand-written label-intersect kernels
(``csrc/label_intersect.cu`` and ``csrc/label_intersect_packed.cu``; the
design notes are in those files). They replace the Pallas
``label_intersect_kernel`` and ``label_intersect_packed_kernel`` of
``repro/kernels/label_intersect/kernel.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def label_intersect_kernel(ids_s, d_s, ids_t, d_t, n_sentinel: int):
    """ids_*: int32[Q, L] sorted ancestor ids (pad = n_sentinel);
    d_*: float32[Q, L], all contiguous on one CUDA device. Any Q and L.
    Returns mu float32[Q]."""
    for name, t, dt in (("ids_s", ids_s, torch.int32), ("d_s", d_s, torch.float32),
                        ("ids_t", ids_t, torch.int32), ("d_t", d_t, torch.float32)):
        _build.require(t, name, dt, 2)
        if t.shape != ids_s.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(ids_s.shape)}")
    q, l = ids_s.shape
    mu = torch.empty(q, dtype=torch.float32, device=ids_s.device)
    _build.launch("islabel_label_intersect", ids_s, d_s, ids_t, d_t, mu,
                  q, l, n_sentinel)
    return mu


def label_intersect_packed_kernel(delta_s, base_s, d_s, delta_t, base_t, d_t,
                                  n_sentinel: int):
    """delta_*: int16[Q, L] (-1 marks the first pad slot); base_*:
    int32[Q]; d_*: int32[Q, L] (-1 = +inf) or float32[Q, L], one dtype
    for both rows; all contiguous on one CUDA device. Any Q and L.
    Returns mu float32[Q]."""
    d_dtype = d_s.dtype
    if d_dtype not in (torch.int32, torch.float32):
        raise ValueError(f"d_s must be int32 or float32, got {d_dtype}")
    for name, t, dt, nd in (
            ("delta_s", delta_s, torch.int16, 2), ("base_s", base_s, torch.int32, 1),
            ("d_s", d_s, d_dtype, 2), ("delta_t", delta_t, torch.int16, 2),
            ("base_t", base_t, torch.int32, 1), ("d_t", d_t, d_dtype, 2)):
        _build.require(t, name, dt, nd)
        want = delta_s.shape if nd == 2 else delta_s.shape[:1]
        if t.shape != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(want)}")
    q, l = delta_s.shape
    mu = torch.empty(q, dtype=torch.float32, device=delta_s.device)
    _build.launch("islabel_label_intersect_packed", delta_s, base_s, d_s,
                  delta_t, base_t, d_t, mu, q, l, n_sentinel,
                  int(d_dtype == torch.int32))
    return mu
