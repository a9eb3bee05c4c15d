"""yi-34b — assigned LM architecture (the port's copy of
``repro.configs.yi_34b``).

llama-arch GQA [arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, tiny_like

MOE = None
CONFIG = LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, qkv_bias=False, moe=MOE, q_chunk=512)


def get_spec() -> ArchSpec:
    return ArchSpec(arch_id="yi-34b", family="lm", model_cfg=CONFIG,
                    shapes=dict(LM_SHAPES), optimizer="adamw",
                    smoke_cfg_fn=lambda: tiny_like(CONFIG),
                    notes='llama-arch GQA [arXiv:2403.04652; hf]')
