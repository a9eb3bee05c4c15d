"""qwen2-moe-a2.7b — assigned LM architecture (the port's copy of
``repro.configs.qwen2_moe_a2_7b``).

4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, tiny_like

MOE = MoEConfig(n_experts=60, top_k=4, d_expert_ff=1408,
                n_shared=4, d_shared_ff=5632)
CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, qkv_bias=True, moe=MOE, q_chunk=512)


def get_spec() -> ArchSpec:
    return ArchSpec(arch_id="qwen2-moe-a2.7b", family="lm", model_cfg=CONFIG,
                    shapes=dict(LM_SHAPES), optimizer="adamw",
                    smoke_cfg_fn=lambda: tiny_like(CONFIG),
                    notes='4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]')
