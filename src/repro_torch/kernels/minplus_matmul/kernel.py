"""Binding of the hand-written min-plus matmul kernel
(``csrc/minplus_matmul.cu``; the design note is in that file). It
replaces the Pallas ``minplus_matmul_kernel`` of
``repro/kernels/minplus_matmul/kernel.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def minplus_matmul_kernel(a, b):
    """A: [M, K], B: [K, N] float32 on one CUDA device, any shapes
    (+inf, the min-plus zero, fills the ragged tiles). Returns [M, N]."""
    _build.require(a, "a", torch.float32, 2)
    _build.require(b, "b", torch.float32, 2)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _build.launch("islabel_minplus_matmul", a, b, c, m, n, k)
    return c
