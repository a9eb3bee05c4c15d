"""qwen2-72b — assigned LM architecture (the port's copy of
``repro.configs.qwen2_72b``).

GQA, QKV bias [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, tiny_like

MOE = None
CONFIG = LMConfig(
    name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True, moe=MOE, q_chunk=512)


def get_spec() -> ArchSpec:
    return ArchSpec(arch_id="qwen2-72b", family="lm", model_cfg=CONFIG,
                    shapes=dict(LM_SHAPES), optimizer="adamw",
                    smoke_cfg_fn=lambda: tiny_like(CONFIG),
                    notes='GQA, QKV bias [arXiv:2407.10671; hf]')
