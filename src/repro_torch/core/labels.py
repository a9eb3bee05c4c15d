"""Label rows as the dispatch layer consumes them (the counterpart of
``repro.core.labels``). Only the uncompressed codec ``"none"`` is
ported: ids int32 and distances float32, ``[..., l_cap]`` each. The
delta16 codec and its packed intersect kernel are still to port
(ROADMAP.md, queue 2 item 5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LabelRows", "decode_rows"]


class LabelRows(NamedTuple):
    """Gathered label rows: ids int32[..., L], base None, d float32."""
    ids: torch.Tensor
    base: torch.Tensor | None
    d: torch.Tensor


def decode_rows(rows: LabelRows, n_sentinel: int, codec: str):
    """(ids int32, d float32) of gathered rows."""
    if codec != "none":
        raise NotImplementedError(
            f"label codec {codec!r} is not ported yet (ROADMAP.md queue 2 "
            f"item 5)")
    return rows.ids, rows.d
