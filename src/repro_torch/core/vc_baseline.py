"""VC-Index-style baseline (paper Table 8 comparator, Cheng et al. [11]):
the port of ``repro.core.vc_baseline``.

The complement of a vertex cover is an independent set, so a
*one-level* IS-LABEL hierarchy (k=2, peel a maximal IS, keep the
reduced graph G_2 explicitly) is the vertex-cover reduced-graph
construction of VC-Index: non-cover vertices store their (augmented)
adjacency into the cover, and queries run a search over the reduced
graph seeded from those entries. The baseline is that special case of
the same code path (hierarchy truncated at k=2, the degree cap lifted
so the peel is a maximal independent set), so its queries run the same
kernels as the multi-level index: the label kernel, then the stage-2
kernel of the route its (large) core takes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import IndexConfig
from repro_torch.core.index import ISLabelIndex


def vc_index_config(base: IndexConfig = IndexConfig()) -> IndexConfig:
    """One-level (vertex-cover-equivalent) configuration."""
    return dataclasses.replace(base, k_force=2, d_cap=64)


def build_vc_index(n, src, dst, w, base: IndexConfig = IndexConfig(),
                   device=None, perms=None) -> ISLabelIndex:
    """Build the VC-style baseline index (k=2) on ``device`` (the card
    unless the caller names the CPU); ``perms`` as in
    ``ISLabelIndex.build``."""
    return ISLabelIndex.build(n, src, dst, w, vc_index_config(base),
                              device=device, perms=perms)
