"""Stochastic rounding of f32 to bf16 (paper §3.3.2), as plain torch.

SR adds 16 random bits below the bf16 mantissa and truncates: the carry
is the round-up, so E[SR(x)] == x.  Non-finite inputs pass through a plain
cast (adding bits would corrupt inf/NaN).

The bit math runs in int64: torch on the CPU has no uint32 ``add``, and a
wide add cannot overflow.  The f32 bit pattern is zero-extended, the low
16 random bits added, the sum shifted right by 16 and its low 16 bits are
the bf16 pattern — the same 16 bits the reference's uint32 wrap-around
add gives.
"""
from __future__ import annotations

import torch

_LOW_MASK = 0xFFFF


def _bits_u32(t: torch.Tensor) -> torch.Tensor:
    """A 32-bit tensor's bit pattern as non-negative int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sr_cast_bf16(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 stochastic rounding given explicit random bits.

    rbits: int32 (or uint32) tensor of x's shape holding the 32 random
    bits per element; only the low 16 are read.  A non-finite input takes
    the plain cast: inf truncates exactly, NaN becomes the canonical quiet
    NaN with its sign (the reference's pattern, computed here on the bits
    because torch's own vectorised cast writes a different NaN).
    """
    xf = x.to(torch.float32).contiguous()
    u = _bits_u32(xf)
    rounded = ((u + (_bits_u32(rbits.contiguous()) & _LOW_MASK)) >> 16) \
        & 0xFFFF
    plain = torch.where(torch.isnan(xf), ((u >> 16) & 0x8000) | 0x7FC0,
                        u >> 16)
    hi = torch.where(torch.isfinite(xf), rounded, plain)
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16)
    return hi.view(torch.bfloat16)


def make_rbits(shape, generator: torch.Generator, *, device="cpu",
               lo: bool = False, lo_block: int = 256) -> torch.Tensor:
    """Entropy for SR as int32 bit patterns, drawn from ``generator``.

    lo=True reproduces the reference's shared-entropy layout (one fresh
    32-bit word per ``lo_block`` elements, rotated by ``idx % 32``).
    torch's Philox never gives the reference's threefry bits, so tests
    inject the reference's bits instead of calling this.
    """
    n = 1
    for s in shape:
        n *= int(s)
    if not lo:
        w = torch.randint(0, 1 << 32, (n,), generator=generator,
                          dtype=torch.int64, device=generator.device)
    else:
        n_words = -(-n // lo_block)
        words = torch.randint(0, 1 << 32, (n_words,), generator=generator,
                              dtype=torch.int64, device=generator.device)
        idx = torch.arange(n, dtype=torch.int64, device=generator.device)
        wd = words[idx // lo_block]
        rot = idx % 32
        w = ((wd >> rot) | (wd << ((32 - rot) % 32))) & 0xFFFFFFFF
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return w.reshape(tuple(shape)).to(device)
