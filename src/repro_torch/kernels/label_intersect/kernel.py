"""Binding of the hand-written label-intersect kernel
(``csrc/label_intersect.cu``; the design note is in that file). It
replaces the Pallas ``label_intersect_kernel`` of
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
