"""kimi-k2-1t-a32b — assigned LM architecture (the port's copy of
``repro.configs.kimi_k2_1t_a32b``).

Kimi K2 trillion-param MoE [arXiv:2501.kimi2; unverified]; assignment specifies GQA kv=8 (not MLA)
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, tiny_like

MOE = MoEConfig(n_experts=384, top_k=8, d_expert_ff=2048,
                n_shared=1, d_shared_ff=2048)
CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, qkv_bias=False, moe=MOE, q_chunk=512)


def get_spec() -> ArchSpec:
    return ArchSpec(arch_id="kimi-k2-1t-a32b", family="lm", model_cfg=CONFIG,
                    shapes=dict(LM_SHAPES), optimizer="adafactor",
                    smoke_cfg_fn=lambda: tiny_like(CONFIG),
                    fsdp_over_pod=True, param_dtype="bfloat16",
                    notes='Kimi K2 trillion-param MoE [arXiv:2501.kimi2; unverified]; assignment specifies GQA kv=8 (not MLA)')
