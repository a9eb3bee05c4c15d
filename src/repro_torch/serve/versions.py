"""The §8.3 mutation record of the serving layer.

Only ``MutationOp`` so far (the load generator's ``readwrite`` traces
carry it). The versioned copy-on-write store of ``repro.serve.versions``
(``LabelBlockStore``, ``VersionFamily``, ``VersionManager``) is not
ported yet; ``DistanceServer(versioned=True)`` raises until it is.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["MutationOp"]


class MutationOp(NamedTuple):
    """One §8.3 mutation. kind ∈ {"insert", "delete"}; nbrs/ws describe
    the inserted vertex's edges (ignored for deletes)."""
    kind: str
    u: int
    nbrs: tuple = ()
    ws: tuple = ()
