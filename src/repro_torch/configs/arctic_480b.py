"""arctic-480b — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
with a dense FFN residual in parallel (Arctic's dense-MoE hybrid).
~0.5T parameters: at full width one f32 expert table is 35.7 GB, so
the card runs its reduced form (2 layers, d 64, 4 experts, top-2,
d_expert 32, the dense FF beside them).
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, register)

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32000,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864, dense_residual=True),
    norm="rmsnorm",
    act="swiglu",
))
