"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
RWKV6 head size 64 -> 32 heads.  Channel-mix is a non-gated relu^2 FFN;
layernorm with bias.  Reduced (CPU tests): 2 layers, d 128, head_dim 32
(4 heads), d_ff 256, vocab 256.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, SSMConfig, register


def _reduced(cfg: ModelConfig) -> ModelConfig:
    return replace(cfg, n_layers=2, d_model=128, d_ff=256, vocab_size=256,
                   max_seq_len=1024, ssm=replace(cfg.ssm, head_dim=32))


CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    norm="layernorm",
    act="relu_sq",
    notes="attention-free; the WKV6 recurrence is a hand-written kernel",
), reduced=_reduced)
