"""gcn-cora — assigned GNN architecture (the port's copy of
``repro.configs.gcn_cora``).

2-layer GCN, d_hidden=16, mean/sym-norm aggregation [arXiv:1609.02907;
paper]. Kernel regime: SpMM via segment_sum over the edge index.
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GCNConfig

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, d_in=1433,
                   n_classes=7, norm="sym")


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="gcn-cora", family="gnn", model_cfg=CONFIG,
        shapes=dict(GNN_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(CONFIG, d_in=8, d_hidden=8,
                                                 n_classes=4),
        notes="[arXiv:1609.02907; paper]")
