"""egnn — assigned GNN architecture (the port's copy of
``repro.configs.egnn``).

4-layer E(n)-equivariant GNN, d_hidden=64 [arXiv:2102.09844; paper].
Scalar-distance messages + equivariant coordinate updates; no spherical
harmonics. Coordinates for non-molecular shape cells are synthesized
node attributes (DESIGN.md §4).
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=16, n_out=1)


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="egnn", family="gnn", model_cfg=CONFIG,
        shapes=dict(GNN_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(CONFIG, d_in=8, d_hidden=8,
                                                 n_layers=2),
        notes="[arXiv:2102.09844; paper]")
