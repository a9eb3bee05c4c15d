"""dien — assigned recsys architecture (the port's copy of
``repro.configs.dien``).

embed_dim=18, seq_len=100, gru_dim=108, MLP 200-80, AUGRU interaction
[arXiv:1809.03672; unverified]. Embedding tables are the recsys-scale
hot path (67M item rows; on one card the tables are whole, not
mod-sharded).
"""
import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.dien import DIENConfig

CONFIG = DIENConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                    mlp_dims=(200, 80))


def get_spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dien", family="recsys", model_cfg=CONFIG,
        shapes=dict(RECSYS_SHAPES),
        smoke_cfg_fn=lambda: dataclasses.replace(
            CONFIG, n_items=1000, n_cats=50, n_users=100, seq_len=12),
        notes="[arXiv:1809.03672; unverified]")
