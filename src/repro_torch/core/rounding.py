"""Stochastic rounding of f32 to bf16 (paper §3.3.2), as plain torch.

SR adds 16 random bits below the bf16 mantissa and truncates: the carry
is the round-up, so E[SR(x)] == x.  Non-finite inputs pass through a plain
cast (adding bits would corrupt inf/NaN).

Two entropy regimes, as in the reference:

  * :func:`stochastic_round_bf16`    — fresh random bits per element
    (the paper's ``SR``);
  * :func:`stochastic_round_bf16_lo` — a shared stream of ``ceil(n/32)+1``
    random words; element i reads the 16-bit window at bit offset i (the
    paper's ``SR LO`` shift register: one fresh bit per element).

The LO stream is NOT :func:`make_rbits`'s ``lo=True`` layout (one word
per 256 elements, rotated), which is the entropy layout of the kernels'
fused SR epilogues; both exist in the reference and both are kept.
Every function takes a ``torch.Generator`` or the bits themselves, so
tests can inject the reference's threefry bits.

:func:`fixed_quantize` emulates the paper's fixed-point MAC datapath
(Qm.n: scale, round nearest / SR / SR-LO, saturate, de-scale) for the
Fig 10 precision study; its SR-LO entropy is the same sliding window.

The bit math runs in int64: torch on the CPU has no uint32 ``add``, and a
wide add cannot overflow.  The f32 bit pattern is zero-extended, the low
16 random bits added, the sum shifted right by 16 and its low 16 bits are
the bf16 pattern — the same 16 bits the reference's uint32 wrap-around
add gives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

_LOW_MASK = 0xFFFF


_MASK64 = (1 << 64) - 1


def fold_key(key: int, data: int) -> int:
    """Fold 32 bits of data into a key (splitmix64 finaliser): a
    deterministic 63-bit generator seed."""
    z = ((key & _MASK64) * 0x9E3779B97F4A7C15 + (data & 0xFFFFFFFF)) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _bits_u32(t: torch.Tensor) -> torch.Tensor:
    """A 32-bit tensor's bit pattern as non-negative int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


# elements sr_cast_bf16 rounds at a time
SR_CHUNK = 1 << 24


def sr_cast_bf16(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 stochastic rounding given explicit random bits.

    rbits: int32 (or uint32) tensor of x's shape holding the 32 random
    bits per element; only the low 16 are read.  A non-finite input takes
    the plain cast: inf truncates exactly, NaN becomes the canonical quiet
    NaN with its sign (the reference's pattern, computed here on the bits
    because torch's own vectorised cast writes a different NaN).
    """
    xf = x.to(torch.float32).contiguous()
    rb = rbits.contiguous()
    out = torch.empty(xf.shape, dtype=torch.int16, device=xf.device)
    # SR_CHUNK elements at a time: the int64 temporaries of a whole leaf
    # (tens of bytes an element) would not fit beside a large model
    for xs, rs, o in zip(xf.view(-1).split(SR_CHUNK),
                          rb.view(-1).split(SR_CHUNK),
                          out.view(-1).split(SR_CHUNK)):
        u = _bits_u32(xs)
        rounded = ((u + (_bits_u32(rs) & _LOW_MASK)) >> 16) & 0xFFFF
        plain = torch.where(torch.isnan(xs), ((u >> 16) & 0x8000) | 0x7FC0,
                            u >> 16)
        hi = torch.where(torch.isfinite(xs), rounded, plain)
        o.copy_(torch.where(hi >= 0x8000, hi - 0x10000, hi))
    return out.view(torch.bfloat16)


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
        return _words(n, generator).reshape(tuple(shape)).to(device)
    n_words = -(-n // lo_block)
    words = torch.randint(0, 1 << 32, (n_words,), generator=generator,
                          dtype=torch.int64, device=generator.device)
    idx = torch.arange(n, dtype=torch.int64, device=generator.device)
    wd = words[idx // lo_block]
    rot = idx % 32
    w = ((wd >> rot) | (wd << ((32 - rot) % 32))) & 0xFFFFFFFF
    return _to_int32(w).reshape(tuple(shape)).to(device)


def _words(n: int, generator: torch.Generator) -> torch.Tensor:
    """n uniform 32-bit words as int32, on the generator's device."""
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=generator,
                         dtype=torch.int32, device=generator.device)


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 values below 2^32 -> the same bits as int32."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def sliding_window_bits(stream: torch.Tensor, n: int) -> torch.Tensor:
    """The SR-LO entropy: element i reads the 16 bits at bit offset i of
    the word stream (``ceil(n/32)+1`` 32-bit words), int32 (n,)."""
    u = _bits_u32(stream.reshape(-1))
    idx = torch.arange(n, dtype=torch.int64, device=stream.device)
    w, b = idx >> 5, idx & 31
    lo = u[w] >> b
    hi = torch.where(b > 0, (u[w + 1] << (32 - b)) & 0xFFFFFFFF, 0)
    return ((lo | hi) & _LOW_MASK).to(torch.int32)


def sr_bits(mode: str, shape, generator: torch.Generator,
            device=None) -> torch.Tensor:
    """The per-element SR entropy of rounding mode 'sr' or 'sr_lo' for a
    tensor of `shape`, drawn from `generator` (int32, on `device`)."""
    n = 1
    for s in shape:
        n *= int(s)
    if mode == "sr":
        bits = _words(n, generator)
    elif mode == "sr_lo":
        bits = sliding_window_bits(_words((n + 31) // 32 + 1, generator), n)
    else:
        raise ValueError(f"no SR entropy for rounding mode {mode!r}")
    return bits.reshape(tuple(shape)).to(device or generator.device)


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          rbits: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Unbiased f32 -> bf16 with fresh bits per element (paper's ``SR``):
    `rbits` (x's shape) when given, else drawn from `generator`."""
    if rbits is None:
        rbits = sr_bits("sr", x.shape, generator, x.device)
    return sr_cast_bf16(x, rbits)


def stochastic_round_bf16_lo(x: torch.Tensor,
                             generator: Optional[torch.Generator] = None, *,
                             stream: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Low-overhead SR (paper's ``SR LO``): the sliding 16-bit window of a
    shared word stream — `stream` (``ceil(n/32)+1`` words) when given,
    else drawn from `generator`."""
    n = x.numel()
    if stream is None:
        stream = _words((n + 31) // 32 + 1, generator)
    rbits = sliding_window_bits(stream.to(x.device), n)
    return sr_cast_bf16(x, rbits.reshape(x.shape))


def round_nearest_bf16(x: torch.Tensor) -> torch.Tensor:
    """Deterministic round-to-nearest-even baseline."""
    return x.to(torch.bfloat16)


def sr_by_name(name: str) -> Callable:
    """The writeback of rounding mode 'sr' | 'sr_lo' | 'nearest'."""
    if name == "sr":
        return stochastic_round_bf16
    if name == "sr_lo":
        return stochastic_round_bf16_lo
    if name == "nearest":
        return lambda x, generator=None: round_nearest_bf16(x)
    raise ValueError(f"unknown rounding mode {name!r}")


# ---------------------------------------------------------------------------
# Fixed-point emulation (Fig 10 / Table 1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedPointConfig:
    total_bits: int = 32
    frac_bits: int = 16
    rounding: str = "nearest"      # nearest | sr | sr_lo

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def qmax(self) -> float:
        return float((1 << (self.total_bits - 1)) - 1)


FX16 = FixedPointConfig(total_bits=16, frac_bits=8)
FX32 = FixedPointConfig(total_bits=32, frac_bits=16)
FX32_SR = FixedPointConfig(total_bits=32, frac_bits=16, rounding="sr")
FX32_SR_LO = FixedPointConfig(total_bits=32, frac_bits=16, rounding="sr_lo")


def fixed_quantize(x: torch.Tensor, cfg: FixedPointConfig,
                   generator: Optional[torch.Generator] = None, *,
                   uniforms: Optional[torch.Tensor] = None,
                   stream: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize through Qm.n fixed point (returns f32).

    Scale by 2^frac_bits, round, saturate to total_bits, de-scale.
    Rounding 'sr' adds a uniform in [0, 1) before the floor: `uniforms`
    (x's shape, f32) when given, else drawn from `generator`.  'sr_lo'
    takes its uniform from the 16-bit sliding window of a shared word
    stream (``ceil(n/32)+1`` 32-bit words): `stream` when given, else
    drawn from `generator`.
    """
    x = x.to(torch.float32)
    scaled = x * cfg.scale
    if cfg.rounding == "nearest":
        q = torch.round(scaled)
    else:
        if cfg.rounding == "sr":
            if uniforms is None:
                if generator is None:
                    raise ValueError("stochastic rounding needs a generator "
                                     "or uniforms")
                uniforms = torch.rand(x.shape, generator=generator,
                                      dtype=torch.float32,
                                      device=generator.device)
            u = uniforms.to(device=x.device, dtype=torch.float32)
        elif cfg.rounding == "sr_lo":
            n = x.numel()
            if stream is None:
                if generator is None:
                    raise ValueError("stochastic rounding needs a generator "
                                     "or a stream")
                stream = _words((n + 31) // 32 + 1, generator)
            r16 = sliding_window_bits(stream.to(x.device), n)
            u = (r16.to(torch.float32) / 65536.0).reshape(x.shape)
        else:
            raise ValueError(f"unknown rounding {cfg.rounding!r}")
        q = torch.floor(scaled + u)
    q = torch.clamp(q, -cfg.qmax - 1, cfg.qmax)
    return q / cfg.scale
