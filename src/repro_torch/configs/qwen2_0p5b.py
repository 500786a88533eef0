"""qwen2-0.5b — GQA with QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) head_dim=64 d_ff=4864 vocab=151936.
Tied embeddings; swiglu; rmsnorm; QKV bias; rope_theta=1e6.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attention=AttentionConfig(n_heads=14, n_kv_heads=2, head_dim=64,
                              qkv_bias=True, rope_theta=1e6),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
))
