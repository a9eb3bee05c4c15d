"""Label rows as the dispatch layer consumes them, and the delta16 label
codec (``IndexConfig.label_dtype``): the counterpart of
``repro.core.labels``.

``delta16`` id codec
    A sorted ancestor-id row becomes one ``int32`` base (the first id)
    plus ``int16`` forward deltas, 2 bytes an entry instead of 4. Pad
    slots (id == n sentinel) carry the in-band marker ``-1``; decode
    maps every slot at or after the first marker to the sentinel, so
    decoded rows stay sorted. A row whose real deltas exceed ``int16``
    does not fit: ``label_dtype="compressed"`` raises, ``"auto"`` keeps
    fp32.

``int32`` distance codec
    When every finite label distance is a non-negative integer below
    2**24, distances are stored as ``int32`` (``-1`` marks a +inf pad)
    and decoded by exact int->fp32 conversion, so answers stay bitwise
    equal to the fp32 planes. Other distances keep a float32 plane.

Encoding is host-side numpy, copied from ``repro`` (the port imports
nothing of it). Decoding is torch: the stage-2 seed scatter, the packed
kernel's plain version and the CPU path use it. The CUDA kernel
(``kernels/csrc/label_intersect_packed.cu``) decodes in registers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "LabelRows", "LabelCompressionError", "encode_labels",
    "try_encode_labels", "decode_ids", "decode_d", "decode_rows",
    "encoded_nbytes", "row_index",
]

DELTA_MAX = np.int64(2 ** 15 - 1)     # int16 ceiling for a real delta
D_INT_MAX = float(2 ** 24)            # int32 -> fp32 conversion stays exact
PAD_DELTA = -1                        # in-band pad marker (real deltas >= 0)
PAD_D = -1                            # +inf distance marker in int32 planes


class LabelCompressionError(ValueError):
    """The label planes don't fit the requested codec (delta overflow,
    unsorted rows, or non-integral distances under d_dtype=int32)."""


class LabelRows(NamedTuple):
    """Gathered label rows.

    codec "none":    ids int32[..., L], base None,         d float32
    codec "delta16": ids int16[..., L] (deltas), base int32[...],
                     d int32 (integral weights) or float32
    """
    ids: torch.Tensor
    base: torch.Tensor | None
    d: torch.Tensor


def row_index(idx, rows: int) -> torch.Tensor:
    """Row ids of [rows, ...] planes for torch indexing, read as
    ``repro`` reads them (jnp's gather rule: a negative id counts from
    the end, then ids are clamped to [0, rows - 1]). The ids are clamped
    to [-rows, rows - 1] and indexing wraps the negative ones, so ids
    below -rows read row 0. Keeps the dtype (one launch). The label
    kernels repeat the rule in ``csrc/label_merge.cuh``."""
    return idx.clamp(-rows, rows - 1)


# --------------------------------------------------------------- encode
def encode_labels(ids, d, n_sentinel: int, d_dtype: str | None = None):
    """Host-side delta16 encode of ``[..., L]`` label planes.

    Returns ``(delta int16, base int32, d_enc int32|float32)``.
    ``d_dtype``: None infers int32 vs float32 from the data; "int32" /
    "float32" pin the distance plane dtype and raise if the data doesn't
    fit.
    """
    ids = np.asarray(ids)
    d = np.asarray(d, np.float32)
    if ids.shape != d.shape or ids.shape[-1] == 0:
        raise LabelCompressionError(f"bad label plane shape {ids.shape}")
    real = ids < n_sentinel
    # rows must be [real entries..., pads], the layout labeling.py keeps
    if (real[..., 1:] & ~real[..., :-1]).any():
        raise LabelCompressionError("non-contiguous pad slots in a row")
    step = np.diff(ids.astype(np.int64), axis=-1)
    realpair = real[..., 1:]            # contiguity: real[j] => real[j-1]
    if realpair.any():
        real_steps = step[realpair]
        if real_steps.min(initial=0) < 0:
            raise LabelCompressionError("unsorted label row")
        if real_steps.max(initial=0) > DELTA_MAX:
            raise LabelCompressionError(
                f"ancestor-id delta {int(real_steps.max())} exceeds int16")
    delta = np.full(ids.shape, PAD_DELTA, np.int16)
    delta[..., 0] = np.where(real[..., 0], 0, PAD_DELTA)
    delta[..., 1:] = np.where(realpair, step, PAD_DELTA).astype(np.int16)
    base = np.where(real[..., 0], ids[..., 0], 0).astype(np.int32)

    vals = d[real]
    integral = (vals.size == 0 or
                (np.isfinite(vals).all() and (vals >= 0).all()
                 and (vals < D_INT_MAX).all()
                 and (vals == np.round(vals)).all()))
    if d_dtype == "int32" and not integral:
        raise LabelCompressionError(
            "non-integral/oversized distance under pinned int32 codec")
    if d_dtype == "float32" or (d_dtype is None and not integral):
        d_enc = d.copy()
    else:
        d_enc = np.where(real, d, float(PAD_D)).astype(np.int32)
    return delta, base, d_enc


def try_encode_labels(ids, d, n_sentinel: int, d_dtype: str | None = None):
    """``encode_labels`` or None when the planes don't fit the codec."""
    try:
        return encode_labels(ids, d, n_sentinel, d_dtype)
    except LabelCompressionError:
        return None


def encoded_nbytes(delta, base, d_enc) -> int:
    return sum(x.numel() * x.element_size() for x in (delta, base, d_enc))


# --------------------------------------------------------------- decode
def decode_ids(delta, base, n_sentinel: int):
    """int16 deltas + int32 base -> sorted int32 ids (pads -> sentinel):
    every slot from the first negative delta on is a pad; the rest add
    up (int32, wrapping as ``repro``'s cumsum does) onto the base."""
    pad = (delta < 0).to(torch.int32).cumsum(-1, dtype=torch.int32) > 0
    steps = delta.to(torch.int32).masked_fill(pad, 0)
    ids = base[..., None].to(torch.int32) + steps.cumsum(-1, dtype=torch.int32)
    return ids.masked_fill(pad, n_sentinel)


def decode_d(d_enc):
    """int32 distance plane -> float32 (-1 -> +inf, the rest exact below
    2**24); float32 planes pass through untouched."""
    if d_enc.dtype == torch.float32:
        return d_enc
    return torch.where(d_enc < 0, float("inf"), d_enc.to(torch.float32))


def decode_rows(rows: LabelRows, n_sentinel: int, codec: str):
    """(ids int32, d float32) of gathered rows in either codec."""
    if codec == "none":
        return rows.ids, rows.d
    if codec != "delta16":
        raise ValueError(f"unknown label codec {codec!r}")
    return decode_ids(rows.ids, rows.base, n_sentinel), decode_d(rows.d)
