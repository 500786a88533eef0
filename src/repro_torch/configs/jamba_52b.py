"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Layer pattern: blocks of 8 = 1 attention + 7 mamba (attn at in-block
index 0 here); MoE FFN every 2nd layer (16 experts top-2), dense FFN on
the others.  Attention layers carry a 4k sliding window so long-context
decode stays sub-quadratic.  One period of the pattern (8 layers) holds
every unit kind: 13.30 B parameters, 24.8 GiB in bf16; all 32 layers
(96 GiB in bf16) do not fit one 80 GB card.  Reduced (CPU tests): the
reference's rule — 16 layers, d 64, 4 heads of 16 (2 KV heads), 4
experts, top-2, d_expert 32, d_state 4, d_conv 2, window 4096.
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, SSMConfig, register)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              window=4096),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, moe_period=2),
    norm="rmsnorm",
    act="swiglu",
    attn_period=8,
    attn_phase=0,
))
