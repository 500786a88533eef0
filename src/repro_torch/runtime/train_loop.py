"""Serve-step builders: where the program words meet the model code.

The training step builders come with the training slice.  Each builder
returns a plain function (torch runs eagerly; there is no jit to wrap).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.phases import Phase
from repro_torch.core.program import Program
from repro_torch.engine.context import PEContext
from repro_torch.models import transformer as tfm


def cast_params(params, dtype: torch.dtype):
    """Persistent storage cast: every f32 leaf to `dtype`."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.dtype == torch.float32 else params


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{leaf path: (shape, dtype)} of the decode cache, without
    allocating it."""
    a = cfg.attention
    ng = tfm.n_groups(cfg)
    size = min(max_len, a.window) if a.window else max_len
    kv = ((ng, batch, size, a.n_kv_heads, a.head_dim), torch.bfloat16)
    return {"u0/attn/k": kv, "u0/attn/v": kv,
            "u0/attn/pos": ((ng, batch, size), torch.int32)}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return sum(math.prod(shape) * (torch.finfo(dt).bits if dt.is_floating_point
                                   else torch.iinfo(dt).bits) // 8
               for shape, dt in cache_shapes(cfg, batch, max_len).values())


def make_chunk_step(cfg: ModelConfig, program: Program,
                    kernel_backend: str = "reference"):
    """Multi-token cache step under the PREFILL program word."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.PREFILL)
    dt = program.policy.ff_dtype

    def chunk(params, cache, tokens, pos0):
        return tfm.chunk_step(cfg, params, tokens, cache, pos0, sh,
                              compute_dtype=dt)

    return chunk


def make_decode_step(cfg: ModelConfig, program: Program,
                     kernel_backend: str = "reference"):
    """One-token serve step under the per-op DECODE words."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.DECODE)
    dt = program.policy.ff_dtype

    def decode(params, cache, tokens, pos, active=None):
        return tfm.decode_step(cfg, params, tokens, cache, pos, sh,
                               compute_dtype=dt, active=active)

    return decode


def make_fused_decode_step(cfg: ModelConfig, program: Program,
                           kernel_backend: str = "reference"):
    """One-token serve step with each layer as ONE fused-decode word."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.DECODE)
    dt = program.policy.ff_dtype

    def decode(params, cache, tokens, pos, active=None):
        return tfm.decode_step(cfg, params, tokens, cache, pos, sh,
                               compute_dtype=dt, fused=True, active=active)

    return decode
