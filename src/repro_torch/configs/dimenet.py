"""dimenet — assigned GNN architecture (the port's copy of
``repro.configs.dimenet``).

6 interaction blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6 [arXiv:2003.03123; unverified]. Kernel regime: triplet
gather (directed edge messages modulated by angular basis). Triplet
lists on the large web-graph shape cells are capped/sampled
(DESIGN.md §4) — sum-of-degree-squared triplet counts are a molecular
assumption that does not transfer.
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.dimenet import DimeNetConfig

CONFIG = DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                       n_bilinear=8, n_spherical=7, n_radial=6)


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dimenet", family="gnn", model_cfg=CONFIG,
        shapes=dict(GNN_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(CONFIG, n_blocks=2,
                                                 d_hidden=16, n_bilinear=2),
        notes="[arXiv:2003.03123; unverified]")
