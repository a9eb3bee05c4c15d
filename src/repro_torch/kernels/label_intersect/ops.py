"""Wrapper of the label-intersect kernel (stage 1 of every query).

Replaces ``repro/kernels/label_intersect/kernel.py:label_intersect_kernel``.
Bound on Hopper: bytes (four [Q, L] label planes read once); the CUDA
kernel takes one warp per query and binary-searches instead of the TPU's
L^2 equality join (``csrc/label_intersect.cu``).

On a CUDA tensor the ``cuda`` backend launches the kernel, or raises;
on a CPU tensor it runs the kernel's plain version (``ref.py``), which
is also the ``reference`` backend. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.label_intersect.kernel import label_intersect_kernel
from repro_torch.kernels.label_intersect.ref import label_intersect_ref

LAUNCHES = {"label_intersect_kernel": 0}


def label_intersect(ids_s, d_s, ids_t, d_t, n_sentinel: int, *,
                    backend=None):
    """μ float32[Q] over id-sorted label rows (pad id ``n_sentinel``,
    pad distance +inf); any Q and L."""
    backend = resolve_backend(backend, ids_s.device)
    ids_s = ids_s.to(torch.int32).contiguous()
    ids_t = ids_t.to(torch.int32).contiguous()
    d_s = d_s.to(torch.float32).contiguous()
    d_t = d_t.to(torch.float32).contiguous()
    if backend == "reference" or not ids_s.is_cuda:
        return label_intersect_ref(ids_s, d_s, ids_t, d_t, n_sentinel)
    out = label_intersect_kernel(ids_s, d_s, ids_t, d_t, n_sentinel)
    LAUNCHES["label_intersect_kernel"] += 1
    return out
