"""Blocking device→host reads, counted, and host→device uploads that
do not block.

Every device→host read the builder and the query engine perform goes
through ``host_read``, so the sync budget of the build (one read per
peeled level) and of a query is measured, not asserted. ``host_read``
turns ``torch.cuda.set_sync_debug_mode`` off for its own read only:
a caller can run a build or a query under mode ``"error"``, and any
other hidden synchronisation (``.item()``, a boolean mask, ``nonzero``,
a blocking copy) raises.

``upload`` is the matching host→device copy. A blocking host→device
copy synchronises too (and raises under mode ``"error"``), so uploads
are issued ``non_blocking``; from pageable memory CUDA stages the
source before the call returns, so the numpy array may be dropped at
once.

numpy has no bfloat16. A bf16 tensor reads to the host as ``repro``'s
layout of such an array: its raw 2-byte patterns, dtype ``V2``
(``BF16_HOST``; ``.view(np.uint16)`` gives the bits), which is what
``np.savez`` writes for ``repro``'s bf16 leaves. ``upload`` takes that
form, and an array whose dtype is named ``bfloat16`` (``ml_dtypes``,
which ``np.asarray`` of a ``jnp.bfloat16`` array gives), through its
bytes: both become ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.trace import span

_COUNT = 0
BF16_HOST = np.dtype("V2")


def is_bf16_host(dtype) -> bool:
    """Whether a numpy dtype holds bf16 values: ``BF16_HOST``, or a
    2-byte dtype named ``bfloat16`` (recognised by name: the port does
    not import ``ml_dtypes``)."""
    dtype = np.dtype(dtype)
    return dtype.itemsize == 2 and dtype.fields is None and (
        dtype.kind == "V" or dtype.name == "bfloat16")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view; bf16 as its raw patterns
    (``BF16_HOST``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


def host_read(x):
    """Blocking device→host transfer of a tensor or a tuple of tensors,
    counted once, inside a ``sync.read`` span. Returns numpy (a tuple
    for a tuple)."""
    global _COUNT
    _COUNT += 1
    xs = x if isinstance(x, (tuple, list)) else (x,)
    with span("sync.read"):
        if not any(t.is_cuda for t in xs):
            out = tuple(_numpy(t).copy() for t in xs)
        else:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                host = []
                for t in xs:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t.detach(), non_blocking=True)
                    host.append(h)
                # each copy runs on its source device's stream
                for dev in dict.fromkeys(t.device for t in xs if t.is_cuda):
                    torch.cuda.current_stream(dev).synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            out = tuple(_numpy(h) for h in host)
    return out if isinstance(x, (tuple, list)) else out[0]


def host_arrays(*xs) -> list:
    """numpy forms of ``xs`` (numpy arrays, Python scalars, lists, or
    tensors on any device): CPU tensors as they are, and every CUDA
    tensor among them through one counted ``host_read``."""
    cuda = tuple(x for x in xs if isinstance(x, torch.Tensor) and x.is_cuda)
    read = iter(host_read(cuda) if cuda else ())
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(next(read) if x.is_cuda else _numpy(x))
        else:
            out.append(np.asarray(x))
    return out


def upload(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (or host tensor) -> tensor on ``device`` without a blocking
    copy, inside a ``sync.upload`` span. Always a fresh tensor: callers
    update it in place. A bf16 host array (``is_bf16_host``) becomes
    ``torch.bfloat16``."""
    with span("sync.upload"):
        return _upload(a, device, dtype)


def _upload(a, device, dtype):
    t = a
    if not isinstance(t, torch.Tensor):
        arr = np.ascontiguousarray(a).reshape(np.shape(a))   # keeps 0-d
        bf16 = is_bf16_host(arr.dtype)
        if bf16:
            arr = arr.view(np.int16)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        if bf16:
            t = t.view(torch.bfloat16)
    dtype = t.dtype if dtype is None else dtype
    if torch.device(device).type == "cpu":
        return t.to(dtype=dtype, copy=True)
    return t.to(device, dtype=dtype, non_blocking=True)


def sync_count() -> int:
    return _COUNT


class sync_span:
    """Context manager reporting the syncs issued inside its scope."""

    def __enter__(self):
        self._start = _COUNT
        return self

    def __exit__(self, *exc):
        self.count = _COUNT - self._start
        return False
