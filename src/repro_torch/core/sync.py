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
"""
from __future__ import annotations

import numpy as np
import torch

_COUNT = 0


def host_read(x):
    """Blocking device→host transfer of a tensor or a tuple of tensors,
    counted once. Returns numpy (a tuple for a tuple)."""
    global _COUNT
    _COUNT += 1
    xs = x if isinstance(x, (tuple, list)) else (x,)
    cuda = any(t.is_cuda for t in xs)
    if not cuda:
        out = tuple(t.detach().numpy().copy() for t in xs)
    else:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            host = []
            for t in xs:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t.detach(), non_blocking=True)
                host.append(h)
            torch.cuda.current_stream().synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        out = tuple(h.numpy() for h in host)
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
            out.append(next(read) if x.is_cuda else x.detach().numpy())
        else:
            out.append(np.asarray(x))
    return out


def upload(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (or host tensor) -> tensor on ``device`` without a blocking
    copy. Always a fresh tensor: callers update it in place."""
    t = a
    if not isinstance(t, torch.Tensor):
        arr = np.ascontiguousarray(a)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
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

    @property
    def so_far(self) -> int:
        return _COUNT - self._start
