"""GQA attention against a KV cache: the serving subset.

``chunk_attend`` is multi-token attention against the cache (chunked
prefill); ``decode_attend`` is the same function at one token, so each
position's output of a chunk equals a single-token decode at that
position.  Caches are updated IN PLACE (the reference returns new
arrays); ``update_cache`` writes only the rows ``active`` selects.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig

NEG_INF = -1e30
_F32, _F64 = torch.float32, torch.float64


def split_qkv(cfg: AttentionConfig, qkv: torch.Tensor,
              bias: Optional[torch.Tensor]) -> tuple:
    """qkv: (B, S, (H+2K)*hd) -> q (B,S,K,G,hd), k/v (B,S,K,hd)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1)
    B, S = q.shape[:2]
    return (q.reshape(B, S, K, H // K, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def chunk_attend(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_pos: torch.Tensor,
                 pos: torch.Tensor, *, window: Optional[int] = None
                 ) -> torch.Tensor:
    """q: (B, T, K, G, hd); k/v_cache: (B, S, K, hd); kv_pos: (B, S)
    (-1 = empty); pos: (B, T).  Returns (B, T, K, G, hd).

    f32 scores, the unnormalised exp cast to the cache dtype before the
    PV contraction, the denominator applied afterwards (the reference's
    cast discipline).  Contractions and sums run in f64 (exact for bf16
    operands), so a position's result does not depend on T.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("btkgh,bskh->btkgs", q.to(_F64),
                     k_cache.to(_F64)).to(_F32) * scale
    kp = kv_pos[:, None, :]
    valid = (kp >= 0) & (kp <= pos[:, :, None])
    if window is not None:
        valid &= (pos[:, :, None] - kp) < window
    s = torch.where(valid[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp((s - m).to(_F64)).to(_F32)
    l = p.to(_F64).sum(dim=-1, keepdim=True).to(_F32)
    out = torch.einsum("btkgs,bskh->btkgh", p.to(v_cache.dtype).to(_F64),
                       v_cache.to(_F64)).to(_F32)
    out = out / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, kv_pos: torch.Tensor,
                  pos: torch.Tensor, *, window: Optional[int] = None
                  ) -> torch.Tensor:
    """One-token attention: q (B, K, G, hd), pos (B,) -> (B, K, G, hd)."""
    return chunk_attend(q[:, None], k_cache, v_cache, kv_pos, pos[:, None],
                        window=window)[:, 0]


def init_kv_cache(cfg: AttentionConfig, batch: int, length: int,
                  dtype=torch.bfloat16, device=None, lead: tuple = ()
                  ) -> dict:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    size = min(length, cfg.window) if cfg.window else length
    return {
        "k": torch.zeros(lead + (batch, size, K, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, size, K, hd), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
    }


def update_cache(cache: dict, k1: torch.Tensor, v1: torch.Tensor,
                 pos: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> dict:
    """Insert one token per row at `pos` (ring-buffered), in place.

    k1/v1: (B, K, hd); pos: (B,); active: (B,) bool — rows left False
    are not written.
    """
    size = cache["k"].shape[1]
    b = torch.arange(k1.shape[0], device=k1.device)
    if active is not None:
        b = b[active.to(torch.bool)]
    slot = pos[b].to(torch.int64) % size
    cache["k"][b, slot] = k1[b].to(cache["k"].dtype)
    cache["v"][b, slot] = v1[b].to(cache["v"].dtype)
    cache["pos"][b, slot] = pos[b].to(torch.int32)
    return cache


def update_cache_chunk(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor) -> dict:
    """Insert T tokens at positions `pos` (B, T), in place.  Un-windowed
    caches only: there positions never wrap within a chunk."""
    size = cache["k"].shape[1]
    slot = pos.to(torch.int64) % size
    b = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][b, slot] = k.to(cache["k"].dtype)
    cache["v"][b, slot] = v.to(cache["v"].dtype)
    cache["pos"][b, slot] = pos.to(torch.int32)
    return cache


def attn_params(cfg: ModelConfig, generator: torch.Generator,
                lead: tuple = ()) -> dict:
    """Attention weights drawn on the generator's device (f32)."""
    a = cfg.attention
    d = cfg.d_model
    q_out = a.n_heads * a.head_dim
    kv_out = 2 * a.n_kv_heads * a.head_dim
    dev = generator.device

    def normal(*shape):
        return torch.randn(lead + shape, generator=generator, dtype=_F32,
                           device=dev)

    p = {"qkv": normal(d, q_out + kv_out) * d ** -0.5,
         "o": normal(q_out, d) * q_out ** -0.5}
    if a.qkv_bias:
        p["qkv_bias"] = torch.zeros(lead + (q_out + kv_out,), dtype=_F32,
                                    device=dev)
    return p
