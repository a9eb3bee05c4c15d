"""Wrappers of the label-intersect kernels (stage 1 of every query).

``label_intersect`` replaces
``repro/kernels/label_intersect/kernel.py:label_intersect_kernel``.
Bound on Hopper at the serving batches: the latency of dependent loads;
the CUDA kernel takes one warp per query and merges the two rows 32
slots at a time instead of the TPU's L^2 equality join
(``csrc/label_intersect.cu``, ``csrc/label_merge.cuh``).

``label_intersect_rows`` is the counterpart of ``repro``'s wrapper of
the same name: codec ``"none"`` goes to ``label_intersect``, codec
``"delta16"`` to ``label_intersect_packed_kernel``, which decodes the
compressed rows in registers and merges them with the same core
(``csrc/label_intersect_packed.cu``).

``label_intersect_planes`` is what the query engine calls: the same
function of endpoint ids, each kernel reading the rows in place from the
[n+1, L] label planes (no gathered [Q, L] copies).

On a CUDA tensor the ``cuda`` backend launches the kernel, or raises;
on a CPU tensor it runs the kernel's plain version (``ref.py``), which
is also the ``reference`` backend. ``LAUNCHES`` counts kernel launches.

``ref`` is bound as a module: it imports ``repro_torch.core.labels``,
whose package imports this module, so its names resolve at call time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.label_intersect import ref
from repro_torch.kernels.label_intersect.kernel import (
    label_intersect_kernel, label_intersect_packed_kernel)

LAUNCHES = {"label_intersect_kernel": 0, "label_intersect_packed_kernel": 0}


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
        return ref.label_intersect_ref(ids_s, d_s, ids_t, d_t, n_sentinel)
    out = label_intersect_kernel(ids_s, d_s, ids_t, d_t, n_sentinel)
    LAUNCHES["label_intersect_kernel"] += 1
    return out


def label_intersect_rows(rows_s, rows_t, n_sentinel: int,
                         codec: str = "none", *, backend=None):
    """μ float32[Q] over gathered ``LabelRows`` (``core/labels.py``) in
    either codec; any Q and L."""
    if codec == "none":
        return label_intersect(rows_s.ids, rows_s.d, rows_t.ids, rows_t.d,
                               n_sentinel, backend=backend)
    if codec != "delta16":
        raise ValueError(f"unknown label codec {codec!r}")
    backend = resolve_backend(backend, rows_s.ids.device)
    args = [x.contiguous() for x in (*rows_s, *rows_t)]
    if backend == "reference" or not args[0].is_cuda:
        return ref.label_intersect_packed_ref(*args, n_sentinel)
    out = label_intersect_packed_kernel(*args, n_sentinel)
    LAUNCHES["label_intersect_packed_kernel"] += 1
    return out


def label_intersect_planes(planes, s, t, n_sentinel: int,
                           codec: str = "none", *, backend=None):
    """μ float32[Q] of the endpoint pairs (s[q], t[q]): the rows are read
    in place from ``planes`` (``LabelRows`` of [R, L] planes in either
    codec; base None for ``"none"``). The same function as
    ``label_intersect_rows`` on the gathered rows."""
    backend = resolve_backend(backend, planes.ids.device)
    idx = tuple(x.to(planes.ids.device, torch.int32).contiguous()
                for x in (s, t))
    if codec == "none":
        name, kernel, plain = ("label_intersect_kernel", label_intersect_kernel,
                               ref.label_intersect_ref)
        side = (planes.ids.to(torch.int32).contiguous(),
                planes.d.to(torch.float32).contiguous())
    elif codec == "delta16":
        name, kernel, plain = ("label_intersect_packed_kernel",
                               label_intersect_packed_kernel,
                               ref.label_intersect_packed_ref)
        side = tuple(x.contiguous() for x in planes)
    else:
        raise ValueError(f"unknown label codec {codec!r}")
    if backend == "reference" or not planes.ids.is_cuda:
        return plain(*side, *side, n_sentinel, *idx)
    out = kernel(*side, *side, n_sentinel, *idx)
    LAUNCHES[name] += 1
    return out
