"""granite-8b — assigned LM architecture (the port's copy of
``repro.configs.granite_8b``).

llama-arch, code [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, tiny_like

MOE = None
CONFIG = LMConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, qkv_bias=False, moe=MOE, q_chunk=512)


def get_spec() -> ArchSpec:
    return ArchSpec(arch_id="granite-8b", family="lm", model_cfg=CONFIG,
                    shapes=dict(LM_SHAPES), optimizer="adamw",
                    smoke_cfg_fn=lambda: tiny_like(CONFIG),
                    notes='llama-arch, code [arXiv:2405.04324; hf]')
