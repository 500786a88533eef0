"""minitron-4b — pruned Nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Nemotron family: squared-ReLU non-gated MLP, RoPE, no biases, layernorm.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=9216,
    vocab_size=256000,
    attention=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=128),
    norm="layernorm",
    act="relu_sq",
))
