"""GQA attention: flash-style training attention and KV-cache serving.

``flash_attention`` / ``attention_block`` are the training path: an
online softmax over KV chunks in f32 (running max and denominator), one
``torch.utils.checkpoint`` per q chunk so backward re-runs the KV loop
instead of keeping every probability tile.  They are plain torch, as the
reference computes them in jnp (no TPU kernel), and they are not
``scaled_dot_product_attention``, whose numerics differ.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.engine.context import PEContext
from repro_torch.models.layers import apply_rope, param_drawer

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


def _pick_chunk(s: int, target: int = 1024) -> int:
    if s <= target:
        return s
    c = target
    while s % c:
        c //= 2
    return max(c, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention (the reference's arithmetic).

    q: (B, Sq, K, G, hd); k, v: (B, Skv, K, hd).  Returns
    (B, Sq, K, G, hd) in q's dtype.  Scores and PV accumulate in f32;
    the unnormalised probabilities are cast to v's dtype before PV.
    """
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq, ck = _pick_chunk(Sq), _pick_chunk(Skv)
    dev = q.device
    qpos_all = q_offset + torch.arange(Sq, dtype=torch.int32, device=dev)
    kpos_all = torch.arange(Skv, dtype=torch.int32, device=dev)

    def one_q_chunk(qb, qpos):
        m = torch.full((B, K, G, cq), NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((B, K, G, cq), dtype=_F32, device=dev)
        acc = torch.zeros((B, K, G, cq, hd), dtype=_F32, device=dev)
        for k0 in range(0, Skv, ck):
            kb, vb = k[:, k0:k0 + ck], v[:, k0:k0 + ck]
            kpos = kpos_all[k0:k0 + ck]
            s = torch.einsum("bqkgh,bskh->bkgqs", qb.to(_F32),
                             kb.to(_F32)) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vb.dtype).to(_F32),
                              vb.to(_F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]    # (B,K,G,cq,hd)
        return out.permute(0, 3, 1, 2, 4)                   # (B,cq,K,G,hd)

    outs = [checkpoint(one_q_chunk, q[:, q0:q0 + cq], qpos_all[q0:q0 + cq],
                       use_reentrant=False) for q0 in range(0, Sq, cq)]
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_block(cfg: ModelConfig, x: torch.Tensor, params: dict,
                    sh: PEContext, *, positions: torch.Tensor,
                    causal: bool = True, rope: bool = True,
                    op_prefix: str = "attn") -> torch.Tensor:
    """Training attention over the full sequence.  x: (B, S, d)."""
    a = cfg.attention
    qkv = sh.dot(f"{op_prefix}_qkv", x, params["qkv"])
    q, k, v = split_qkv(a, qkv, params.get("qkv_bias"))
    B, S = x.shape[:2]
    if rope:
        K_, G, hd = q.shape[2:]
        q = apply_rope(q.reshape(B, S, K_ * G, hd), positions,
                       a.rope_theta).reshape(B, S, K_, G, hd)
        k = apply_rope(k, positions, a.rope_theta)
    out = flash_attention(q, k, v, causal=causal,
                          window=a.window if causal else None)
    return sh.dot(f"{op_prefix}_o", out.reshape(B, S, -1), params["o"])


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


def attn_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                lead: tuple = (), dtype: torch.dtype = _F32) -> dict:
    """Attention weights drawn on the generator's device in f32, each cast
    to `dtype` as it is drawn; without a generator, the same tree on the
    meta device (shapes only)."""
    a = cfg.attention
    d = cfg.d_model
    q_out = a.n_heads * a.head_dim
    kv_out = 2 * a.n_kv_heads * a.head_dim
    dev = generator.device if generator is not None else torch.device("meta")
    normal = param_drawer(generator, lead, dtype)
    p = {"qkv": normal((d, q_out + kv_out), d ** -0.5),
         "o": normal((q_out, d), q_out ** -0.5)}
    if a.qkv_bias:
        p["qkv_bias"] = torch.zeros(lead + (q_out + kv_out,), dtype=dtype,
                                    device=dev)
    return p
