"""Plain torch oracles for the kernels (the reference's ``kernels/ref.py``).

The plain version of each ported kernel lives beside its wrapper
(``sr_matmul.sr_matmul_plain``, ``outer_accum.outer_accum_plain``,
``sr_round.sr_round_plain``, ``decode_fused.fused_attn_unit_plain``,
``decode_fused.fused_ffn_plain``, ``wkv6.wkv6_plain``);
this module re-exports them with the SR cast under the reference's names.
"""
from __future__ import annotations

from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels.decode_fused import (fused_attn_unit_plain,
                                              fused_ffn_plain)
from repro_torch.kernels.outer_accum import outer_accum_plain
from repro_torch.kernels.sr_matmul import sr_matmul_plain
from repro_torch.kernels.wkv6 import wkv6_plain


def sr_round_ref(x, rbits):
    return sr_cast_bf16(x, rbits)


def sr_matmul_ref(a, b, rbits=None, *, trans_b: bool = False):
    return sr_matmul_plain(a, b, rbits, trans_b=trans_b)


def outer_accum_ref(x, dy, *, scale: float = 1.0, rbits=None):
    """FC weight update (paper Fig 8): dW = scale * X^T dY, f32 or SR-bf16."""
    return outer_accum_plain(x, dy, scale=scale, rbits=rbits)


def wkv6_ref(r, k, v, w, u, state0=None):
    """Sequential WKV6 oracle.  r, k, v, w: (BH, S, hd); u: (BH, hd).
    Returns (y (BH, S, hd) f32, final state (BH, hd, hd) f32)."""
    y, s = wkv6_plain(*(t[:, :, None] for t in (r, k, v, w)), u[:, None],
                      state0[:, None] if state0 is not None else None)
    return y[:, :, 0], s[:, 0]


__all__ = ["sr_cast_bf16", "sr_round_ref", "sr_matmul_ref",
           "outer_accum_ref", "wkv6_ref", "fused_attn_unit_plain",
           "fused_ffn_plain"]
