"""Assigned input-shape sets: the port's copy of ``repro.configs.shapes``,
every family's, unchanged.

Each family has its own shape vocabulary; ``ArchSpec.input_specs``
translates (arch, shape) into concrete ``(shape, dtype)`` specs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    subquadratic_required: bool = False


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    # long_500k requires sub-quadratic attention; all five assigned LM archs
    # are pure full-attention (GQA) -> skipped per assignment (DESIGN.md §4).
    "long_500k": LMShape("long_500k", "decode", 524288, 1,
                         subquadratic_required=True),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str            # full | minibatch | molecule
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_nodes: int = 0
    fanout: tuple = ()
    batch_graphs: int = 0
    n_classes: int = 47


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2708, 10556, 1433,
                              n_classes=7),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", 232965, 114615892,
                             602, batch_nodes=1024, fanout=(15, 10),
                             n_classes=41),
    "ogb_products": GNNShape("ogb_products", "full", 2449029, 61859140, 100,
                             n_classes=47),
    "molecule": GNNShape("molecule", "molecule", 30, 64, 16, batch_graphs=128,
                         n_classes=1),
}


@dataclasses.dataclass(frozen=True)
class RecShape:
    name: str
    kind: str            # train | serve | retrieval
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecShape("train_batch", "train", 65536),
    "serve_p99": RecShape("serve_p99", "serve", 512),
    "serve_bulk": RecShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecShape("retrieval_cand", "retrieval", 1,
                               n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class IndexShape:
    """Shapes for the paper's own workload (IS-LABEL query serving)."""
    name: str
    kind: str            # query | build_level
    n_vertices: int
    l_cap: int
    n_core: int
    core_edges: int
    q_batch: int = 0
    e_cap: int = 0
    d_cap: int = 16


ISLABEL_SHAPES = {
    "serve_1m": IndexShape("serve_1m", "query", 1 << 20, 64, 1 << 17,
                           1 << 22, q_batch=4096),
    "serve_128m": IndexShape("serve_128m", "query", 1 << 27, 32, 1 << 20,
                             1 << 24, q_batch=16384),
    # peel-level working set = e_cap + (e_cap/2)*d_cap elements; keep the
    # flattened size under 2^31 (XLA int32 iota) -> 16M vertices here.
    "build_16m": IndexShape("build_16m", "build_level", 1 << 24, 64, 0, 0,
                            e_cap=1 << 26),
}
