"""Kernel backend resolution shared by every ``kernels/*/ops.py`` wrapper.

Two execution backends, one policy point:

  * ``"cuda"``      — the hand-written Hopper kernels (``kernels/csrc``).
    A wrapper given CUDA tensors launches its kernel, or raises; given
    CPU tensors it runs that kernel's plain PyTorch version (``ref.py``),
    which is how the CPU tests cover every kernel route.
  * ``"reference"`` — the plain PyTorch oracles in ``kernels/*/ref.py``
    and the COO scatter-min core search: the counterpart of ``repro``'s
    jnp ``reference`` backend.

``"auto"`` (the default) picks ``"cuda"`` when the index lies on a CUDA
device and ``"reference"`` on the CPU. The ``ISLABEL_BACKEND``
environment variable overrides ``"auto"``, as in ``repro``.
"""
from __future__ import annotations

import os

import torch

BACKENDS = ("cuda", "reference")
ENV_VAR = "ISLABEL_BACKEND"


def resolve_backend(backend: str | None = None, device=None) -> str:
    """Map a requested backend (or None/"auto") to a concrete one;
    ``device`` is where the index lies."""
    if backend in (None, "auto"):
        backend = os.environ.get(ENV_VAR, "auto")
    if backend in (None, "auto"):
        on_cuda = device is not None and torch.device(device).type == "cuda"
        backend = "cuda" if on_cuda else "reference"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS} or 'auto'")
    return backend


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller names
    the CPU: ``None`` means ``"cuda"``, and without CUDA that raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev
