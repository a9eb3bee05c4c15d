"""islabel — the paper's own workload as a servable config (the port's
copy of ``repro.configs.islabel``).

Query serving over a distance-label index (labels sharded by vertex,
core graph replicated per pod, query batches data-parallel) and one
hierarchy-peeling build level (edge-sharded).
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import ISLABEL_SHAPES
from repro_torch.core.config import IndexConfig

CONFIG = IndexConfig()


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="islabel", family="graph_index", model_cfg=CONFIG,
        shapes=dict(ISLABEL_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(CONFIG, l_cap=64,
                                                 label_chunk=256),
        notes="IS-LABEL query/build serving (the paper's technique)")
