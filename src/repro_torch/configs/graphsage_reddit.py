"""graphsage-reddit — assigned GNN architecture (the port's copy of
``repro.configs.graphsage_reddit``).

2-layer GraphSAGE, d_hidden=128, mean aggregator, sample_sizes=25-10
[arXiv:1706.02216; paper]. Minibatch cells use a real host-side
neighbor sampler (graphs/sampler.py).
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import SAGEConfig

CONFIG = SAGEConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                    d_in=602, n_classes=41, aggregator="mean",
                    fanouts=(25, 10))


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="graphsage-reddit", family="gnn", model_cfg=CONFIG,
        shapes=dict(GNN_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(CONFIG, d_in=8, d_hidden=8,
                                                 n_classes=4, fanouts=(3, 2)),
        notes="[arXiv:1706.02216; paper]")
