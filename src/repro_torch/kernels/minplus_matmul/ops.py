"""Wrapper of the min-plus matmul kernel (one round of the dense-core
route of stage 2).

Replaces ``repro/kernels/minplus_matmul/kernel.py:minplus_matmul_kernel``.
Bound on Hopper: operations (an add and a min per (i, j, k) on the fp32
CUDA cores: tensor cores do not do min-plus); the CUDA kernel tiles
like an SGEMM with +inf filling ragged tiles
(``csrc/minplus_matmul.cu``).

On a CUDA tensor the ``cuda`` backend launches the kernel, or raises;
on a CPU tensor it runs the kernel's plain version (``ref.py``), which
is also the ``reference`` backend. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.minplus_matmul.kernel import minplus_matmul_kernel
from repro_torch.kernels.minplus_matmul.ref import minplus_matmul_ref

LAUNCHES = {"minplus_matmul_kernel": 0}


def minplus_matmul(a, b, *, backend=None):
    """min-plus product for arbitrary [M,K]x[K,N] float32 inputs."""
    backend = resolve_backend(backend, a.device)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if backend == "reference" or not a.is_cuda:
        return minplus_matmul_ref(a, b)
    out = minplus_matmul_kernel(a, b)
    LAUNCHES["minplus_matmul_kernel"] += 1
    return out
