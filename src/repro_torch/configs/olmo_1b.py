"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (GQA kv=16 == MHA) d_ff=8192 vocab=50304.
OLMo: non-parametric LN (no scale/bias), no biases anywhere, swiglu.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),
    norm="nonparametric_ln",
    act="swiglu",
))
