"""Config system: model / shape / train dataclasses + registry.

The port's own copy of the reference's config types, holding only what
the port's slices need: dense decoder-only models with GQA attention,
the attention-free RWKV6 family (``ssm``) and mixture-of-experts models
(``moe``: GQA attention with a routed expert FF).
``get_reduced`` gives the CPU-test variant of the same family (small
widths, two layers, vocab 256; MoE: 4 experts, top-2, d_expert 32) as
the reference derives it; rwkv6 registers its own rule (d 128,
head_dim 32), and a test builds the reference's config from the port's
fields.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # sliding window (ring-buffer KV cache); None = full causal attention
    window: Optional[int] = None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden size
    dense_residual: bool = False       # a dense FFN in parallel with MoE
    moe_period: int = 1                # MoE FFN every `period` layers
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"                # the port runs 'rwkv6' only
    head_dim: int = 64                 # rwkv6 head size


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # 'dense' | 'ssm' | 'moe'
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"              # rmsnorm|layernorm|nonparametric_ln
    act: str = "swiglu"                # swiglu|gelu|relu_sq|geglu
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    notes: str = ""

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.moe_period) == (self.moe.moe_period - 1)

    def _ffn_params(self, hidden: int) -> int:
        return (3 if self.act in ("swiglu", "geglu") else 2) \
            * self.d_model * hidden

    def param_count(self) -> int:
        """Analytic parameter count (the reference's count: embeddings and
        layers, final norm not counted; its rwkv6 mixer count is the
        reference's approximation, not the leaves' exact size)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = v * d if self.tie_embeddings else 2 * v * d
        n_norm = d if self.norm != "nonparametric_ln" else 0
        if self.family == "ssm":
            mixer = 5 * d * d + 2 * d + 6 * d
        else:
            a = self.attention
            mixer = (d * a.n_heads * a.head_dim
                     + 2 * d * a.n_kv_heads * a.head_dim
                     + a.n_heads * a.head_dim * d)
            if a.qkv_bias:
                mixer += (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
        for i in range(L):
            n += mixer + 2 * n_norm
            if self.is_moe_layer(i):
                m = self.moe
                n += m.n_experts * self._ffn_params(m.d_expert) \
                    + d * m.n_experts
                if m.dense_residual:
                    n += self._ffn_params(f)
            else:
                n += self._ffn_params(f)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_moe = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        return self.param_count() - n_moe * (m.n_experts - m.top_k) \
            * self._ffn_params(m.d_expert)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # 'train' | 'prefill' | 'decode'


@dataclass(frozen=True)
class TrainConfig:
    """The reference's training knobs that the port's train step reads,
    with the reference's defaults.  The run's own settings (seed, steps,
    logging, checkpoints) are the launcher's arguments; the multi-device
    knobs (gradient compression, ZeRO-1) come with that slice."""
    optimizer: str = "adamw"           # sgdm|adamw|adagrad
    lr: float = 3e-4
    weight_decay: float = 0.1
    momentum: float = 0.9
    precision: str = "paper_sr_bf16"   # see core/precision.py presets
    kernel_backend: str = "reference"  # engine matmul path: reference|cuda
    microbatch: int = 0                # 0 = no microbatching
    remat: str = "block"               # none|block|full


_REGISTRY: dict[str, ModelConfig] = {}
_REDUCED: dict[str, Callable[[ModelConfig], ModelConfig]] = {}


def register(cfg: ModelConfig,
             reduced: Optional[Callable[[ModelConfig], ModelConfig]] = None
             ) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    if reduced is not None:
        _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    return sorted(_REGISTRY)


def _default_reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny variant for CPU tests (the reference's rule)."""
    kw: dict = dict(n_layers=min(cfg.n_layers, 2), d_model=64, d_ff=128,
                    vocab_size=256, max_seq_len=1024)
    if cfg.attention is not None:
        a = cfg.attention
        kw["attention"] = replace(
            a, n_heads=4,
            n_kv_heads=min(a.n_kv_heads, 2) if a.n_kv_heads < a.n_heads else 4,
            head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
                            d_expert=32)
    return replace(cfg, **kw)


def get_reduced(name: str) -> ModelConfig:
    cfg = get_config(name)
    return _REDUCED.get(name, _default_reduced)(cfg)
