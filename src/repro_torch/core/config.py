"""IS-LABEL index configuration (same fields and defaults as
``repro.core.config``, so a ``meta.json`` written by either package
loads through ``IndexConfig(**meta["cfg"])`` in the other).

The fixed capacities play the role of the paper's disk buffers: every
device computation is fixed-shape; overflows are detected and reported
(grow the cap and rebuild) instead of silently truncating.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    # -- hierarchy construction -------------------------------------------
    sigma: float = 0.95        # k-selection: stop when |G_{i+1}| > sigma*|G_i|
    k_force: int = 0           # >0: fixed k (paper Table 6 sweeps)
    k_max: int = 64            # hard cap on hierarchy height
    d_cap: int = 16            # IS eligibility degree cap (paper: greedy
                               # min-degree; we peel only deg<=d_cap vertices)
    e_cap_factor: float = 2.0  # edge capacity = factor * initial |E|
    aug_cap_factor: float = 1.0  # IS-incident edge buffer = factor * |E|
    builder: str = "device"    # level loop: device (one stat read per
                               # level) | host (the reference loop the
                               # device builder is gated against)
    # -- labeling ----------------------------------------------------------
    l_cap: int = 256           # max label entries per vertex
    label_chunk: int = 4096    # vertices labeled per chunk step
    sync_every: int = 8        # labeling overflow-check cadence: one
                               # deferred device read per this many levels
    # -- query -------------------------------------------------------------
    max_relax_rounds: int = 0  # 0 = bound by n_core (exact Bellman-Ford)
    query_backend: str = "auto"  # kernel dispatch: auto | cuda |
                                 # reference (kernels/backend.py)
    query_chunk: int = 0       # >0: tile query batches so the stage-2
                               # frontier is [chunk, n_core+1], not [Q, ...]
    label_dtype: str = "fp32"  # label storage codec: fp32 | compressed
                               # (delta16, raises if it does not fit) |
                               # auto (delta16 when it fits, else fp32)
    seed: int = 0

    def e_cap(self, n_edges: int) -> int:
        return max(64, int(self.e_cap_factor * n_edges))

    def aug_cap(self, n_edges: int) -> int:
        return max(64, int(self.aug_cap_factor * n_edges))


@dataclasses.dataclass
class BuildStats:
    """Per-build record mirroring the paper's Tables 3/6/7 columns."""
    n: int = 0
    m: int = 0                      # directed edge count of input
    k: int = 0
    n_core: int = 0                 # |V_{G_k}|
    m_core: int = 0                 # |E_{G_k}| (directed count)
    level_sizes: list = dataclasses.field(default_factory=list)
    graph_sizes: list = dataclasses.field(default_factory=list)  # |V|+|E| per level
    label_entries: int = 0          # total (u, d) pairs over all labels
    label_bytes: int = 0
    build_seconds: float = 0.0
    mis_rounds: list = dataclasses.field(default_factory=list)
    # construction-phase split + sync accounting (docs/CONSTRUCTION.md)
    peel_seconds: float = 0.0       # hierarchy (peel) phase wall time
    label_seconds: float = 0.0      # labeling phase wall time
    host_syncs: int = 0             # blocking device→host reads during build
    peel_loop_syncs: int = 0        # blocking reads inside the level loop
    peel_iters: int = 0             # level-loop iterations; the bench gates
                                    # peel_loop_syncs / peel_iters <= 1
    peak_device_bytes: int = 0      # max live device bytes observed (sampled)

    def summary(self) -> str:
        return (f"n={self.n} m={self.m} k={self.k} |V_Gk|={self.n_core} "
                f"|E_Gk|={self.m_core} label_entries={self.label_entries} "
                f"label_MB={self.label_bytes / 1e6:.2f} "
                f"build_s={self.build_seconds:.2f} "
                f"(peel {self.peel_seconds:.2f} + label {self.label_seconds:.2f}) "
                f"host_syncs={self.host_syncs}")
