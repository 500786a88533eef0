"""Shared layer primitives (plain torch functions on tensors).

Parameters are nested dicts of tensors in the reference's pytree layout.
Every weight-bearing matmul goes through the engine seam ``sh.dot``.

Reductions and transcendental functions run in float64 and round to
float32 where the reference computes in float32: the rounded result
then does not depend on a tensor's shape (how many rows or tokens share
a call), which is what lets chunked prefill and token-by-token decode
agree bit for bit on the reference backend.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.context import PEContext

_F32, _F64 = torch.float32, torch.float64


def param_normal(generator: torch.Generator, shape: tuple,
                 std: float = 1.0) -> torch.Tensor:
    """f32 N(0, std^2) of `shape` drawn from `generator`, on its device."""
    return torch.randn(shape, generator=generator, dtype=_F32,
                       device=generator.device) * std


def param_drawer(generator: Optional[torch.Generator], lead: tuple = (),
                 dtype: torch.dtype = _F32):
    """normal(shape, std): an f32 N(0, std^2) draw of lead + shape from
    `generator` on its device, cast to `dtype` as it is drawn (the bits
    of a later cast of the f32 draw); without a generator, an empty meta
    tensor of that shape and dtype."""
    dev = generator.device if generator is not None else torch.device("meta")

    def normal(shape: tuple, std: float) -> torch.Tensor:
        if generator is None:
            return torch.empty(lead + shape, dtype=dtype, device=dev)
        return (torch.randn(lead + shape, generator=generator, dtype=_F32,
                            device=dev) * std).to(dtype)
    return normal


def _mean_f32(t: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of an f32 tensor, summed in f64."""
    return t.to(_F64).mean(dim=-1, keepdim=True).to(_F32)


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    y = xf * torch.rsqrt(_mean_f32(xf * xf) + eps)
    if scale is not None:
        y = y * scale.to(_F32)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(_F32)
    mu = _mean_f32(xf)
    var = _mean_f32((xf - mu) ** 2)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(_F32)
    if bias is not None:
        y = y + bias.to(_F32)
    return y.to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor,
               params: Optional[dict]) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"] if params else None,
                         params.get("bias") if params else None)
    if cfg.norm == "nonparametric_ln":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {cfg.norm!r}")


def norm_params(cfg: ModelConfig, device=None, lead: tuple = (),
                dtype: torch.dtype = _F32) -> Optional[dict]:
    if cfg.norm == "nonparametric_ln":
        return None
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=device)
    return p


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(_F64)).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu (the reference's jax.nn.gelu default)."""
    return F.gelu(x.to(_F64), approximate="tanh").to(x.dtype)


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return _gelu(x)
    if name == "relu_sq":
        r = F.relu(x)
        return r * r
    if name in ("swiglu", "geglu"):
        raise ValueError("gated activations are applied inside mlp()")
    raise ValueError(f"unknown act {name!r}")


def mlp(cfg: ModelConfig, x: torch.Tensor, w_in: torch.Tensor,
        w_out: torch.Tensor, sh: PEContext) -> torch.Tensor:
    """FFN with fused gate+up for gated activations.

    w_in: (d, 2f) for swiglu/geglu else (d, f); w_out: (f, d).
    """
    h = sh.dot("ffn_in", x, w_in)
    if cfg.act in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        gate = _silu(g) if cfg.act == "swiglu" else _gelu(g)
        h = gate * u
    else:
        h = act_fn(cfg.act, h)
    return sh.dot("ffn_out", h, w_out)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=_F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(_F32) * freqs          # (..., S, hd/2)
    cos = torch.cos(ang.to(_F64)).to(_F32)[..., None, :]
    sin = torch.sin(ang.to(_F64)).to(_F32)[..., None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.to(torch.int64)]


def lm_logits(x: torch.Tensor, cfg: ModelConfig, params: dict,
              sh: PEContext) -> torch.Tensor:
    if cfg.tie_embeddings:
        y = sh.dot("embed", x, params["embed"]["table"], transpose_w=True)
        return y.to(_F32)
    return sh.dot("lm_head", x, params["lm_head"]).to(_F32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL; logits f32 (B, S, V), labels (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_chunks(B: int, S: int, V: int) -> int:
    """The reference's chunk count: about 128 MB of f32 logits per
    chunk, a divisor of B."""
    n = max(1, min(B, round(B * S * V * 4.0 / 128e6)))
    while B % n:
        n -= 1
    return n


def lm_loss_chunked(cfg: ModelConfig, x: torch.Tensor, params: dict,
                    labels: torch.Tensor, sh: PEContext,
                    n_chunks: int = 0) -> torch.Tensor:
    """Cross-entropy without materialising the full (B, S, V) logits.

    The LM head and the softmax run per batch chunk under
    ``torch.utils.checkpoint``, so forward and backward each hold one
    chunk of logits at a time.  Chunks are strided (row r -> chunk
    r % n), and n is the reference's: about 128 MB of f32 logits per
    chunk, a divisor of B (4 chunks at B=4, S=256 for qwen2-0.5b).
    """
    B, S, _ = x.shape
    n_chunks = n_chunks or loss_chunks(B, S, cfg.vocab_size)
    tied = cfg.tie_embeddings
    head_op = "embed" if tied else "lm_head"
    w = params["embed"]["table"] if tied else params["lm_head"]

    def piece(xc, lc):
        # logits stay in the activation dtype; only the reductions run f32
        logits = sh.dot(head_op, xc, w, transpose_w=tied)
        lse = torch.logsumexp(logits.to(_F32), dim=-1)
        gold = torch.gather(logits, -1, lc.to(torch.int64)[..., None])
        return torch.sum(lse - gold[..., 0].to(_F32))

    total = torch.zeros((), dtype=_F32, device=x.device)
    for c in range(n_chunks):
        total = total + checkpoint(piece, x[c::n_chunks], labels[c::n_chunks],
                                   use_reentrant=False)
    return total / (B * S)
