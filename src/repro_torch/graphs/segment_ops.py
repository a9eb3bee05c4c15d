"""Segment reductions — the scatter/gather substrate of construction
and of the GNNs' message passing.

Each reduction scatters into an output pre-filled with the reduction's
identity (``include_self=True``), so empty segments come out exactly as
``jax.ops.segment_*`` leaves them: +inf / -inf for floats, the dtype's
max / min for integers, 0 for sums. ``data`` may carry trailing
dimensions (``[E, d]`` messages): the ids index its first dimension.
Gradients flow through the sum and mean paths (``scatter_reduce``'s
backward is a gather).
"""
from __future__ import annotations

import torch


def _fill(dtype: torch.dtype, lowest: bool):
    if dtype.is_floating_point:
        return float("-inf") if lowest else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lowest else info.max


def _scatter(data, segment_ids, num_segments: int, reduce: str, fill):
    out = torch.full((num_segments,) + tuple(data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long()
    if data.dim() > 1:
        idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce, include_self=True)


def segment_sum(data, segment_ids, num_segments: int):
    return _scatter(data, segment_ids, num_segments, "sum", 0)


def segment_min(data, segment_ids, num_segments: int):
    """Min-reduce; empty segments = +inf (float) / dtype max (int)."""
    return _scatter(data, segment_ids, num_segments, "amin",
                    _fill(data.dtype, lowest=False))


def segment_max(data, segment_ids, num_segments: int):
    return _scatter(data, segment_ids, num_segments, "amax",
                    _fill(data.dtype, lowest=True))


def segment_mean(data, segment_ids, num_segments: int):
    """Sum over the segment's count, an empty segment counting 1 (so it
    comes out 0), as ``repro``'s ``segment_mean``."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                 device=data.device), segment_ids,
                      num_segments)
    return tot / cnt.clamp(min=1.0).view((-1,) + (1,) * (data.dim() - 1))


def segment_argmin_take(data, payload, segment_ids, num_segments: int):
    """For each segment return payload of (one) element achieving the min.

    Deterministic: among ties picks the largest payload.
    """
    seg_min = segment_min(data, segment_ids, num_segments)
    is_min = data == seg_min[segment_ids.long()]
    return segment_max(torch.where(is_min, payload, -1), segment_ids,
                       num_segments)


def count_per_segment(segment_ids, num_segments: int, mask=None):
    ones = torch.ones(segment_ids.shape, dtype=torch.int32,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0)
    return segment_sum(ones, segment_ids, num_segments)
