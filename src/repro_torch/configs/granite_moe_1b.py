"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512(per-expert) vocab=49155,
MoE 32e top-8, swiglu experts with separate gate and up tables; tied
embeddings.  Reduced (CPU tests): the reference's rule — 2 layers, d 64,
4 heads of 16 (2 KV heads), 4 experts, top-2, d_expert 32, vocab 256.
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, register)

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49155,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=64),
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
))
