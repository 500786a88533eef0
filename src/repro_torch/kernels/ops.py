"""Public wrappers for the kernels, with explicit SR entropy.

Every wrapper takes ``rbits`` explicitly, so tests can inject the bits the
reference generated; a live caller draws them with :func:`make_rbits`
from a ``torch.Generator`` (torch's Philox never reproduces the
reference's threefry bits).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.rounding import make_rbits
from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels import outer_accum as _oa
from repro_torch.kernels import sr_matmul as _mm
from repro_torch.kernels import sr_round as _rr
from repro_torch.kernels import wkv6 as _wkv

fused_attn_unit = _df.fused_attn_unit
fused_ffn = _df.fused_ffn


def _entropy(shape, generator, lo: bool, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("SR needs rbits or a generator")
    return make_rbits(shape, generator, device=device, lo=lo)


def sr_round(x: torch.Tensor, generator: Optional[torch.Generator] = None,
             *, lo: bool = False,
             rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastically round f32 to bf16 with `rbits` when given, else with
    bits drawn from `generator` (lo=True: the shared-entropy layout)."""
    if rbits is None:
        rbits = _entropy(x.shape, generator, lo, x.device)
    return _rr.sr_round(x, rbits)


def sr_matmul(a: torch.Tensor, b: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              sr: bool = False, lo: bool = False,
              rbits: Optional[torch.Tensor] = None,
              trans_b: bool = False) -> torch.Tensor:
    """bf16 matmul, f32 accumulation, optional fused SR-bf16 writeback.

    sr=True rounds with `rbits` when given, else with bits drawn from
    `generator` (lo=True: the shared-entropy layout).
    """
    if sr and rbits is None:
        n = b.shape[0] if trans_b else b.shape[1]
        rbits = _entropy((a.shape[0], n), generator, lo, a.device)
    return _mm.sr_matmul(a, b, rbits if sr else None, trans_b=trans_b)


def outer_accum(x: torch.Tensor, dy: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                scale: float = 1.0, sr: bool = False, lo: bool = False,
                rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FC-UP: dW = scale * X^T dY (fused minibatch average + SR).

    sr=True rounds with `rbits` when given, else with bits drawn from
    `generator` (lo=True: the shared-entropy layout).
    """
    if sr and rbits is None:
        rbits = _entropy((x.shape[1], dy.shape[1]), generator, lo, x.device)
    return _oa.outer_accum(x, dy, scale=scale, rbits=rbits if sr else None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None, *,
         active: Optional[torch.Tensor] = None):
    """WKV6 in the model-facing layout: r, k, v, w (B, S, H, hd), u (H, hd);
    r, k, v bf16 or f32, the rest f32; state (B, H, hd, hd) updated in place (rows `active` selects)
    or None for zeros.  Returns (y (B, S, H, hd), final state).  The
    reference folds to (B*H, S, hd) for its kernel; the port's kernel
    reads this layout directly."""
    return _wkv.wkv6_bshd(r, k, v, w, u, state, active=active)


__all__ = ["make_rbits", "sr_matmul", "outer_accum", "sr_round",
           "fused_attn_unit", "fused_ffn", "wkv6"]
