"""Frozen copy of ``repro_torch.graphs.generators.er_graph``."""
from __future__ import annotations

import numpy as np

from portbench.graphs import finalize


def generate(n: int, avg_deg: float = 3.0, max_w: int = 4, seed: int = 0):
    """Sparse Erdos-Renyi: the BTC-like low-degree regime."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(int(m * 1.2), 2))
    return finalize(n, e, rng, max_w)
